"""Flash attention, forward and backward: hand-written CUDA kernels for
Hopper and their plain PyTorch versions.

The kernels replace the Pallas kernels of
`mmlspark_tpu/ops/flash_attention.py`:

  * K1 `_flash_kernel` / `_flash_forward` (the `pallas_call` at :148),
    with its log-sum-exp output and q/k position offsets:
    `csrc/flash_attention.cu`;
  * K2 `_dq_kernel` (:318) and K3 `_dkv_kernel` (:330) of
    `_flash_backward`: `csrc/flash_backward.cu`.

Semantics are the JAX kernels': inputs (B, S, H, D), causal or not, f32
softmax statistics, scale D^-0.5 by default, outputs in the input dtype.
The log-sum-exp `lse` and the backward's `delta = rowsum(dO * O)` are f32
(B, Sq, H), the JAX layout; the kernels read and write that layout in
place.  Unlike the JAX wrappers the kernels take any S: they mask the
ragged last tile themselves, so there is no dense fallback.

Entry points, each with its plain version beside it:

  * `flash_attention` — differentiable; with grad, `_FlashAttention` (the
    port of the `_flash` custom VJP) runs K1 with the LSE output forward
    and K2 + K3 backward, delta computed between them as a torch op;
  * `flash_attention_with_lse` — forward with lse and offsets;
  * `flash_block_grads` — (dq, dk, dv) of one K/V block against global
    lse/delta (the ring backward's building block), through K2 and K3.

For CPU tensors every wrapper runs the plain version; for CUDA tensors it
launches its kernel or raises.  Launch counters: `flash_attention.launches`
(K1 without lse), `flash_attention_with_lse.launches` (K1 with lse),
`flash_bwd_dq.launches` (K2), `flash_bwd_dkv.launches` (K3).
"""

from __future__ import annotations

from typing import Optional

import torch

from mmlspark_tpu_torch.ops import native
from mmlspark_tpu_torch.ops.attention import NEG_INF

# dtype codes of the C entry points
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 128)


def _scale(q: torch.Tensor, scale: Optional[float]) -> float:
    return scale if scale is not None else q.shape[-1] ** -0.5


def _scores(q, k, causal, scale, q_offset, k_offset) -> torch.Tensor:
    """(B, H, Sq, Sk) f32 scores of the JAX kernels' algebra (q scaled in
    f32 before QK^T), NEG_INF where the global-position causal mask
    hides a key."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float() * scale, k.float())
    if causal:
        rows = q_offset + torch.arange(s.shape[-2], device=s.device)
        cols = k_offset + torch.arange(s.shape[-1], device=s.device)
        s = torch.where(rows[:, None] >= cols[None, :], s, NEG_INF)
    return s


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------

def flash_attention_with_lse_plain(q, k, v, causal: bool = False,
                                   scale: Optional[float] = None,
                                   q_offset: int = 0, k_offset: int = 0
                                   ) -> tuple:
    """K1's function in plain PyTorch (the JAX `_dense_with_lse`): output
    in q's dtype and the scaled-score log-sum-exp (B, Sq, H) f32; a row
    with no visible key gives zeros and lse NEG_INF."""
    s = _scores(q, k, causal, _scale(q, scale), q_offset, k_offset)
    m = s.amax(dim=-1)
    safe_m = torch.where(m == NEG_INF, 0.0, m)
    p = torch.where(s == NEG_INF, 0.0, torch.exp(s - safe_m[..., None]))
    l = p.sum(dim=-1)
    lse = torch.where(l == 0.0, NEG_INF,
                      safe_m + torch.log(torch.clamp(l, min=1e-30)))
    out = torch.einsum("bhqk,bkhd->bqhd",
                       p / torch.clamp(l, min=1e-30)[..., None], v.float())
    return out.to(q.dtype), lse.transpose(1, 2).contiguous()


def flash_attention_plain(q, k, v, causal: bool = False,
                          scale: Optional[float] = None) -> torch.Tensor:
    """K1's function without the lse output, in plain PyTorch."""
    return flash_attention_with_lse_plain(q, k, v, causal, scale)[0]


def flash_block_grads_plain(q, k, v, do, lse, delta, causal: bool,
                            scale: float, q_offset: int = 0,
                            k_offset: int = 0) -> tuple:
    """K2 and K3's function in plain PyTorch (the JAX
    `_dense_block_grads`): the (dq, dk, dv) contribution of this K/V block
    against the given global lse and delta.  With lse and delta of the
    whole sequence it is exactly the flash backward."""
    s = _scores(q, k, causal, scale, q_offset, k_offset)
    lse_b = lse.float().transpose(1, 2)[..., None]          # (B, H, Sq, 1)
    p = torch.exp(s - torch.where(lse_b == NEG_INF, 0.0, lse_b))
    p = torch.where((s == NEG_INF) | (lse_b == NEG_INF), 0.0, p)
    do32 = do.float()
    dv = torch.einsum("bhqk,bqhd->bkhd", p, do32)
    dp = torch.einsum("bqhd,bkhd->bhqk", do32, v.float())
    ds = p * (dp - delta.float().transpose(1, 2)[..., None])
    dq = scale * torch.einsum("bhqk,bkhd->bqhd", ds, k.float())
    dk = scale * torch.einsum("bhqk,bqhd->bkhd", ds, q.float())
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

def _check_inputs(q, k, v) -> None:
    if q.device.type != "cuda":
        raise ValueError(f"flash attention kernels: unsupported device "
                         f"{q.device}")
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash attention takes (B, S, H, D) tensors")
    if k.shape != v.shape or k.shape[0] != q.shape[0] or \
            k.shape[2:] != q.shape[2:]:
        raise ValueError(
            f"shape mismatch: q {tuple(q.shape)}, k {tuple(k.shape)}, "
            f"v {tuple(v.shape)}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(
            f"flash attention kernels take float32 or bfloat16 q/k/v of one "
            f"dtype, got {q.dtype}/{k.dtype}/{v.dtype}")
    if q.shape[-1] not in _HEAD_DIMS:
        raise ValueError(
            f"flash attention kernels take head dim {_HEAD_DIMS}, got "
            f"{q.shape[-1]}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash attention kernels take contiguous tensors")
    if k.device != q.device or v.device != q.device:
        raise ValueError("q, k, v must be on one device")


def _check_stats(q, do, lse, delta) -> None:
    if do.shape != q.shape or do.dtype != q.dtype or not do.is_contiguous():
        raise ValueError(
            f"dout must match q: {tuple(do.shape)} {do.dtype} vs "
            f"{tuple(q.shape)} {q.dtype}, contiguous")
    want = tuple(q.shape[:3])
    for name, t in (("lse", lse), ("delta", delta)):
        if tuple(t.shape) != want or t.dtype != torch.float32 or \
                not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous float32 {want}, got "
                             f"{tuple(t.shape)} {t.dtype}")
    if any(t.device != q.device for t in (do, lse, delta)):
        raise ValueError("q, dout, lse, delta must be on one device")


def _check_backward(q, k, v, do, lse, delta) -> None:
    """K2 and K3's inputs; at bf16 the kernels read q, k, v and dout
    through TMA."""
    _check_inputs(q, k, v)
    _check_stats(q, do, lse, delta)
    if q.dtype == torch.bfloat16:
        _check_aligned(q=q, k=k, v=v, dout=do)


def _check_aligned(**tensors) -> None:
    """The bf16 kernels read their inputs through TMA, which takes
    16-byte-aligned tensors only: raise for any other."""
    for name, t in tensors.items():
        if t.data_ptr() % 16:
            raise ValueError(f"flash attention kernel: {name} is not "
                             f"16-byte aligned")


def _forward_kernel(q, k, v, causal, scale, with_lse, q_offset, k_offset):
    """Launch K1 on the current stream: (out, lse or None).  The bf16
    kernel reads q, k, v through TMA, which takes 16-byte-aligned tensors
    only, and folds a positive scale into its base-2 softmax."""
    _check_inputs(q, k, v)
    b, sq, h, d = q.shape
    out = torch.empty_like(q)
    if q.dtype == torch.bfloat16:
        _check_aligned(q=q, k=k, v=v, out=out)
        if not scale > 0:
            raise ValueError(f"flash attention kernel: bf16 takes a "
                             f"positive scale, got {scale}")
    lse = (torch.empty((b, sq, h), dtype=torch.float32, device=q.device)
           if with_lse else None)
    lib = native.library("flash_attention")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.mmlspark_flash_forward(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr(), b, h, sq, k.shape[1], d,
            float(scale), int(causal), int(q_offset), int(k_offset),
            _DTYPES[q.dtype], stream)
    native.check(code, "flash attention forward")
    return out, lse


def flash_attention_with_lse(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, causal: bool = False,
                             scale: Optional[float] = None,
                             q_offset: int = 0, k_offset: int = 0) -> tuple:
    """Flash attention that also returns the log-sum-exp (B, Sq, H) f32;
    `q_offset`/`k_offset` place q and k at global positions for the causal
    mask.  Forward only."""
    scale = _scale(q, scale)
    if q.device.type == "cpu":
        return flash_attention_with_lse_plain(q, k, v, causal, scale,
                                              q_offset, k_offset)
    out, lse = _forward_kernel(q, k, v, causal, scale, True, q_offset,
                               k_offset)
    flash_attention_with_lse.launches += 1
    return out, lse


def flash_bwd_dq(q, k, v, do, lse, delta, causal: bool, scale: float,
                 q_offset: int = 0, k_offset: int = 0) -> torch.Tensor:
    """K2: dq (B, Sq, H, D) in q's dtype from the saved statistics."""
    if q.device.type == "cpu":
        return flash_block_grads_plain(q, k, v, do, lse, delta, causal,
                                       scale, q_offset, k_offset)[0]
    _check_backward(q, k, v, do, lse, delta)
    b, sq, h, d = q.shape
    dq = torch.empty_like(q)
    lib = native.library("flash_backward")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.mmlspark_flash_bwd_dq(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), b, h, sq,
            k.shape[1], d, float(scale), int(causal), int(q_offset),
            int(k_offset), _DTYPES[q.dtype], stream)
    native.check(code, "flash_bwd_dq")
    flash_bwd_dq.launches += 1
    return dq


def flash_bwd_dkv(q, k, v, do, lse, delta, causal: bool, scale: float,
                  q_offset: int = 0, k_offset: int = 0) -> tuple:
    """K3: (dk, dv) (B, Sk, H, D) in k's dtype from the saved statistics."""
    if q.device.type == "cpu":
        return flash_block_grads_plain(q, k, v, do, lse, delta, causal,
                                       scale, q_offset, k_offset)[1:]
    _check_backward(q, k, v, do, lse, delta)
    b, sq, h, d = q.shape
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    lib = native.library("flash_backward")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.mmlspark_flash_bwd_dkv(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            b, h, sq, k.shape[1], d, float(scale), int(causal),
            int(q_offset), int(k_offset), _DTYPES[q.dtype], stream)
    native.check(code, "flash_bwd_dkv")
    flash_bwd_dkv.launches += 1
    return dk, dv


def flash_block_grads(q, k, v, do, lse, delta, causal: bool, scale: float,
                      q_offset: int = 0, k_offset: int = 0) -> tuple:
    """(dq, dk, dv) of one K/V block against global `lse`/`delta`
    (B, Sq, H) f32: K2 then K3 on the card, the plain version on the
    CPU."""
    if q.device.type == "cpu":
        return flash_block_grads_plain(q, k, v, do, lse, delta, causal,
                                       scale, q_offset, k_offset)
    dq = flash_bwd_dq(q, k, v, do, lse, delta, causal, scale, q_offset,
                      k_offset)
    return (dq,) + flash_bwd_dkv(q, k, v, do, lse, delta, causal, scale,
                                 q_offset, k_offset)


class _FlashAttention(torch.autograd.Function):
    """The port of the JAX `_flash` custom VJP: the forward saves
    (q, k, v, out, lse); the backward computes delta = rowsum(dO * O) in
    f32 and runs K2 and K3 (their plain version on CPU tensors)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        out, lse = flash_attention_with_lse(q, k, v, causal, scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.scale = causal, scale
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        g = g.contiguous()
        delta = (g.float() * out.float()).sum(-1)
        dq, dk, dv = flash_block_grads(q, k, v, g, lse, delta, ctx.causal,
                                       ctx.scale)
        return dq, dk, dv, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = False,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Fused attention: q (B, Sq, H, D), k/v (B, Sk, H, D) -> (B, Sq, H, D)
    in q's dtype.  Differentiable: when grad is needed it goes through
    `_FlashAttention` (K1 with lse, then K2 + K3 backward)."""
    scale = _scale(q, scale)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _FlashAttention.apply(q, k, v, causal, scale)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal, scale)
    out, _ = _forward_kernel(q, k, v, causal, scale, False, 0, 0)
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
flash_attention_with_lse.launches = 0
flash_bwd_dq.launches = 0
flash_bwd_dkv.launches = 0
