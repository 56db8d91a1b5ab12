"""Staging per training step, in ms: the `host` (gather, mask, pinned
buffers) and `transfer` (the copies to the card) thread-seconds of
`Trainer.fit_arrays`' staging workers over the window, over the steps
staged."""


def read(record):
    sec, n = record["timings"]["seconds"], record["timings"]["counts"]
    if not n.get("host"):
        return None
    return 1e3 * (sec.get("host", 0.0) + sec.get("transfer", 0.0)) / n["host"]
