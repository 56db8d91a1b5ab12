"""Tiny configurations and traffic for the harness's CPU tests: the same
code paths as the cells, at sizes a test run holds."""

from __future__ import annotations

import time

import torch

from cellbench.harness import core, manifest

RESNET = {
    "stage_sizes": [1, 1, 1, 1], "widths": [4, 8, 8, 8], "block": "bottleneck",
    "num_classes": 10, "image_size": 32, "channels": 3, "dtype": "bfloat16",
    "bn_eps": 1e-5, "bn_momentum": 0.99, "costs": "resnet",
    "program": {"architecture": "ResNet", "model_config": {
        "stage_sizes": [1, 1, 1, 1], "widths": [4, 8, 8, 8],
        "num_classes": 10, "block_kind": "bottleneck", "dtype": "bfloat16"}},
}
GPT2 = {
    "n_embd": 32, "n_head": 4, "n_layer": 2, "n_positions": 16, "n_ctx": 16,
    "vocab_size": 64, "layer_norm_epsilon": 1e-6, "dtype": "bfloat16",
    "costs": "lm",
    "program": {"architecture": "TransformerLM", "model_config": {
        "vocab_size": 64, "d_model": 32, "n_heads": 4, "n_layers": 2,
        "max_len": 16, "mlp_ratio": 4, "dtype": "bfloat16",
        "attn_impl": "flash"}},
}
# the control of the GPT-2 cell reads its published head size (64) and a
# width its fp8 rounding shows at; 4 layers hold it to about a second
GPT2_CONTROL = dict(GPT2, n_embd=512, n_head=8, n_layer=4, n_positions=64,
                    n_ctx=64, vocab_size=2048)
SCORE = {"driver": "score", "table_rows": 16, "batch": 8,
         "prefetch_depth": 2, "pool_images": 64, "warm_tables": 2,
         "sample_tables": 2, "reference_rows": 8, "trace_after_s": 0.1,
         "trace_tables": 2}
TRAIN_TOKENS = {"driver": "train", "inputs": "tokens", "batch": 4, "seq": 16,
                "pool_rows": 16, "recipe": {"optimizer": "adam",
                                            "learning_rate": 1e-3},
                "prefetch_depth": 2, "check_steps": 3, "warm_steps": 2,
                "trace_after_steps": 1, "trace_steps": 2,
                "reference_rows": 2}
TRAIN_TOKENS_CONTROL = dict(TRAIN_TOKENS, batch=2, seq=64)
TRAIN_IMAGES = {"driver": "train", "inputs": "images", "batch": 8,
                "pool_rows": 32, "recipe": {"optimizer": "momentum",
                                            "momentum": 0.875,
                                            "learning_rate": 0.05,
                                            "weight_decay": 3e-5},
                "prefetch_depth": 2, "check_steps": 3, "warm_steps": 2,
                "trace_after_steps": 1, "trace_steps": 2,
                "reference_rows": 8}

CELLS = {  # tiny stand-in -> (config, its reference, traffic)
    "resnet50.score.b256": (RESNET, "resnet50", SCORE),
    "gpt2-xl.train.b8s1024": (GPT2, "gpt2-xl", TRAIN_TOKENS),
    "resnet50.train.b256": (RESNET, "resnet50", TRAIN_IMAGES),
}


def context(workload: str, seed: int = 1234567890123, seconds: float = 0.5,
            trace: bool = False, limits=None) -> core.Context:
    """A CPU context of a cell at its tiny size, held to the cell's own
    limits unless `limits` is given."""
    cfg, ref, mix = CELLS[workload]
    return core.Context(workload, dict(cfg), dict(mix),
                        manifest.reference(ref),
                        manifest.limits(workload) if limits is None
                        else limits, seed, seconds, trace,
                        torch.device("cpu"), time.perf_counter())


def run(ctx: core.Context) -> dict:
    out = manifest.driver(ctx.traffic["driver"]).run(ctx)
    return core.result(ctx, out, manifest.Manifest())
