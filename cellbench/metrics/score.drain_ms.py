"""Drain per scoring batch, in ms: the `drain` thread-seconds of
`TPUModel.transform_batches` over the window (the consumer blocked on the
card's results) over the batches drained."""


def read(record):
    sec, n = record["timings"]["seconds"], record["timings"]["counts"]
    if not n.get("drain"):
        return None
    return 1e3 * sec["drain"] / n["drain"]
