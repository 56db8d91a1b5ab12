"""Dispatch per training step, in ms: the `compute` thread-seconds of
`Trainer.fit_arrays` over the window (the host's time to enqueue a step)
over the steps."""


def read(record):
    sec, n = record["timings"]["seconds"], record["timings"]["counts"]
    if not n.get("compute"):
        return None
    return 1e3 * sec["compute"] / n["compute"]
