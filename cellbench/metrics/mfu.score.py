"""The scoring window's share of the card's bf16 peak, in %: the frozen
forward FLOPs of an image (`costs/`) x the images scored over the window
/ the peak."""

from cellbench.harness import manifest


def read(record):
    peaks = record.get("peaks")
    if not peaks or not record["window_s"]:
        return None
    flops = manifest.costs(record["config"]["costs"]).forward_flops(
        record["config"])
    rate = record["images"] / record["window_s"]
    return 100.0 * flops * rate / peaks["bf16_flops"]
