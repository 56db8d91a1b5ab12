"""The card's idle share of the traced part of the scoring window, in %:
1 - the union of kernel, copy and memset intervals / the traced window."""

from cellbench.harness.trace import idle_percent


def read(record):
    return idle_percent(record)
