"""The training window's share of the card's bf16 peak, in %: the frozen
FLOPs of a step (`costs/`: `lm_train_flops`' total for an LM, 3 x the
forward for a ResNet) x the steps over the window / the peak."""

from cellbench.harness import manifest


def read(record):
    peaks = record.get("peaks")
    if not peaks or not record["steps"]:
        return None
    flops = manifest.costs(record["config"]["costs"]).train_step_flops(
        record["config"], record["traffic"])
    step_s = record["window_s"] / record["steps"]
    return 100.0 * flops / step_s / peaks["bf16_flops"]
