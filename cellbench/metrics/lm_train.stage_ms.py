"""`train.stage_ms` of an LM training cell: the same reading, split so that it
moves that cell's end-to-end metric (`train_tokens_per_s`)."""

from cellbench.harness.manifest import metric_reader


def read(record):
    return metric_reader("train.stage_ms").read(record)
