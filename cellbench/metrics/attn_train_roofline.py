"""Causal attention's training kernels against their bound, in %: the
least time the traced launches need (`costs/attention.py`: each forward
launch of K1[lse] the forward's bound, each pair of K2 and K3 launches
the backward's) / their device time in the trace.  Nothing is read where
the trace holds no such launch."""

from cellbench.harness import manifest

FORWARD, DQ, DKV = "flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"


def read(record):
    trace, peaks = record.get("trace"), record.get("peaks")
    if not trace or not peaks:
        return None
    count = {FORWARD: 0, DQ: 0, DKV: 0}
    seconds = 0.0
    for name, (n, s) in trace["kernels"].items():
        for key in (DKV, DQ, FORWARD):
            if key in name:
                count[key] += n
                seconds += s
                break
    if not seconds or not count[FORWARD]:
        return None
    cfg, mix = record["config"], record["traffic"]
    heads = cfg["n_head"]
    bounds = manifest.costs("attention").causal_bounds(
        mix["batch"], heads, mix["seq"], cfg["n_embd"] // heads, 2,
        peaks["bf16_flops"], peaks["hbm_bytes_per_s"], peaks["ex2_per_s"])
    need = (count[FORWARD] * bounds["forward"]
            + min(count[DQ], count[DKV]) * bounds["backward"])
    return 100.0 * need / seconds
