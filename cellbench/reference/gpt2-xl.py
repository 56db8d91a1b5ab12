"""Plain GPT-2 in float32 (the reference of the `gpt2-xl` cells).

Radford et al. 2019, the sizes of the public `gpt2-xl` config: learned
token and position embeddings, pre-LayerNorm blocks (causal softmax
attention over `n_head` heads, a GELU (tanh) MLP of 4 x `n_embd`), a
final LayerNorm and the vocabulary head.  Departures, as the
configuration lists them: the head is untied from the token embedding
and has a bias, LayerNorm eps is the configuration's
`layer_norm_epsilon` (1e-6), no dropout.

Weights live stacked over the layers (`make_weights`: a few large draws
on the device); `port_state` names each layer's slice as the program's
state dict does, so the harness hands one set of weights to both sides.
Nothing here imports the program.  Products run in float32 with TF32 off;
`quant="fp8"` reads every Dense operand in fp8 (`_lowp.py`), the control
of `correct`.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F

from cellbench.reference import _lowp, _optim

# the tensors stacked over the layers: block i's are `block{i}_w.<name>`
_BLOCK = ("LayerNorm_0.scale", "LayerNorm_0.bias", "qkv.weight", "qkv.bias",
          "proj.weight", "proj.bias", "LayerNorm_1.scale", "LayerNorm_1.bias",
          "mlp_up.weight", "mlp_up.bias", "mlp_down.weight", "mlp_down.bias")


@contextlib.contextmanager
def exact_f32():
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def shapes(cfg: dict) -> dict:
    d, L, V = cfg["n_embd"], cfg["n_layer"], cfg["vocab_size"]
    h = 4 * d
    return {
        "tok_embed.weight": (V, d),
        "pos_embed.weight": (cfg["n_positions"], d),
        "LayerNorm_0.scale": (L, d), "LayerNorm_0.bias": (L, d),
        "qkv.weight": (L, 3 * d, d), "qkv.bias": (L, 3 * d),
        "proj.weight": (L, d, d), "proj.bias": (L, d),
        "LayerNorm_1.scale": (L, d), "LayerNorm_1.bias": (L, d),
        "mlp_up.weight": (L, h, d), "mlp_up.bias": (L, h),
        "mlp_down.weight": (L, d, h), "mlp_down.bias": (L, d),
        "final_norm_w.scale": (d,), "final_norm_w.bias": (d,),
        "lm_head.weight": (V, d), "lm_head.bias": (V,),
    }


def make_weights(cfg: dict, seed: int, device) -> dict:
    """Seeded float32 weights, one normal draw per stacked tensor on
    `device`: GPT-2's init (std 0.02; the residual projections 0.02 /
    sqrt(2 n_layer)), with small random biases and LayerNorm affines
    (scale 1 + N(0, 0.05)) so that every term of the math is live."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (2 ** 63))
    resid = 0.02 / math.sqrt(2 * cfg["n_layer"])
    out = {}
    for name, shape in shapes(cfg).items():
        z = torch.randn(shape, generator=gen, device=device)
        if name.endswith(".scale"):
            t = z.mul_(0.05).add_(1.0)
        elif name in ("proj.weight", "mlp_down.weight"):
            t = z.mul_(resid)
        else:
            t = z.mul_(0.02)
        out[name] = t
    return out


def port_state(W: dict, cfg: dict) -> dict:
    """The program's state dict names -> views of the stacked weights."""
    n_layer = cfg["n_layer"]
    state = {}
    for name, t in W.items():
        if name in _BLOCK:
            for i in range(n_layer):
                state[f"block{i}_w.{name}"] = t[i]
        else:
            state[name] = t
    return state


def _ln(x, scale, bias, eps):
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * scale + bias


def _dense(x, w, b, quant):
    return F.linear(_lowp.operand(x, quant), _lowp.operand(w, quant), b)


def logits(W: dict, tokens: torch.Tensor, cfg: dict, quant=None):
    """Logits (B, S, vocab) of token ids (B, S), float32."""
    b, s = tokens.shape
    d, H, eps = cfg["n_embd"], cfg["n_head"], cfg["layer_norm_epsilon"]
    hd = d // H
    x = W["tok_embed.weight"][tokens] + W["pos_embed.weight"][:s][None]
    causal = torch.ones(s, s, dtype=torch.bool,
                        device=tokens.device).tril()
    for i in range(cfg["n_layer"]):
        def p(name):
            return W[name][i]
        h = _ln(x, p("LayerNorm_0.scale"), p("LayerNorm_0.bias"), eps)
        qkv = _dense(h, p("qkv.weight"), p("qkv.bias"), quant)
        q, k, v = (t.reshape(b, s, H, hd).transpose(1, 2)
                   for t in qkv.split(d, -1))
        att = (q * hd ** -0.5) @ k.transpose(-1, -2)
        att = att.masked_fill(~causal, float("-inf")).softmax(-1)
        o = (att @ v).transpose(1, 2).reshape(b, s, d)
        x = x + _dense(o, p("proj.weight"), p("proj.bias"), quant)
        h = _ln(x, p("LayerNorm_1.scale"), p("LayerNorm_1.bias"), eps)
        h = F.gelu(_dense(h, p("mlp_up.weight"), p("mlp_up.bias"), quant),
                   approximate="tanh")
        x = x + _dense(h, p("mlp_down.weight"), p("mlp_down.bias"), quant)
    x = _ln(x, W["final_norm_w.scale"], W["final_norm_w.bias"], eps)
    return _dense(x, W["lm_head.weight"], W["lm_head.bias"], quant)


def train_steps(W: dict, batches: list, cfg: dict, recipe: dict,
                quant=None, half: bool = False, rows: int = 2) -> dict:
    """Steps of next-token cross-entropy training from `W` over `batches`
    ((tokens, targets), each (B, S), on the weights' device), the
    gradient summed over blocks of `rows` rows so that it fits: each
    step's loss (the mean over every token), the first step's gradient
    of every program leaf, and every leaf's change over all the steps
    (program names, tensors).  `half` trains on the first half of each
    batch (a fault the check must catch)."""
    params = {n: t.clone().requires_grad_(True) for n, t in W.items()}
    state = _optim.init(params, recipe)
    losses, first = [], {}
    with exact_f32():
        for step, (x, y) in enumerate(batches):
            if half:
                x, y = x[:len(x) // 2], y[:len(y) // 2]
            total = 0.0
            for r in range(0, len(x), rows):
                out = logits(params, x[r:r + rows], cfg, quant)
                loss = F.cross_entropy(out.reshape(-1, out.shape[-1]),
                                       y[r:r + rows].reshape(-1).long(),
                                       reduction="sum") / y.numel()
                loss.backward()   # summed into each leaf's .grad
                total += float(loss.detach())
                del out, loss
            grads = {n: p.grad for n, p in params.items()}
            losses.append(total)
            if step == 0:
                first = port_state({n: g.clone() for n, g in grads.items()},
                                   cfg)
            _optim.update(params, grads, state, recipe)
            for p in params.values():
                p.grad = None
            del grads
    change = port_state({n: params[n].detach() - W[n] for n in W}, cfg)
    return {"losses": losses, "grad": first, "change": change}


def leaf_norms(tensors: dict) -> dict:
    names = list(tensors)
    norms = torch.stack([tensors[n].detach().float().norm() for n in names])
    return dict(zip(names, norms.cpu().tolist()))
