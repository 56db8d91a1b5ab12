"""Host staging per scoring batch, in ms: the scoring stage's `host` and
`transfer` thread-seconds over the window (`PipelineTimings` of
`TPUModel.transform_batches`: stacking, padding into pinned buffers, the
copy on a side stream) over the batches staged."""


def read(record):
    sec, n = record["timings"]["seconds"], record["timings"]["counts"]
    if not n.get("host"):
        return None
    return 1e3 * (sec.get("host", 0.0) + sec.get("transfer", 0.0)) / n["host"]
