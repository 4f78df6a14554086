"""Shared layers of the port (the port of ``repro/models/layers.py``):
dense projections, RMSNorm, LayerNorm, activations and softcap, the GLU
MLP, the plain two-layer MLP with bias (whisper), rotary embeddings, the
vocab embedding and the LM heads.

Parameters keep the reference's layouts (``{"kernel": (d_in, d_out),
"bias": (d_out,)}``, ``{"scale": (d,)}``, ``{"table": (vocab, d)}``, ...),
so converting a reference parameter is a plain copy.  Each ``init_*``
draws from a ``torch.Generator``: the reference's distributions, other
draws.
Each ``*_specs`` returns the reference's tree of logical axes for the
matching ``init_*`` (``sharding/partition.py`` resolves them).

Tensor parallelism (``sharding/tp.py``): given a model ``group``, the GLU
MLP holds this member's columns of ``gate``/``up`` and rows of ``down`` and
sums the members' outputs; the embedding holds this member's rows of the
vocab (a token outside them looks up zeros, and the sum over the group
leaves the one non-zero row); the LM heads hold its vocab columns and
all-gather the logits.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.sharding import partition, tp


def dtype_of(name: str) -> torch.dtype:
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dt


def truncated_normal(gen: torch.Generator, shape, scale: float,
                     dtype: torch.dtype, device) -> torch.Tensor:
    """Standard normal truncated to [-2, 2], times ``scale`` — the
    reference's distribution; the draws themselves differ from JAX's."""
    x = torch.empty(shape, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(x, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return x.mul_(scale).to(dtype)


def init_dense(gen: torch.Generator, d_in: int, d_out: int, dtype: str,
               device, bias: bool = False, scale: Optional[float] = None):
    p = {"kernel": truncated_normal(
        gen, (d_in, d_out), scale if scale is not None else d_in ** -0.5,
        dtype_of(dtype), device)}
    if bias:
        p["bias"] = torch.zeros((d_out,), dtype=dtype_of(dtype),
                                device=device)
    return p


def dense_specs(in_ax, out_ax, bias: bool = False):
    p = {"kernel": (in_ax, out_ax)}
    if bias:
        p["bias"] = (out_ax,)
    return p


def stack_specs(tree, *axes):
    """``axes`` prepended to every leaf of a spec tree (stacked layers)."""
    return partition.map_specs(lambda _, t: tuple(axes) + t, tree)


def dense(params, x):
    y = x @ params["kernel"]
    if "bias" in params:
        y = y + params["bias"]
    return y


# ---------------------------------------------------------------------------
# norms, activations, softcap
# ---------------------------------------------------------------------------


def init_rmsnorm(dim: int, dtype: str, device, plus_one: bool = False):
    """gemma2 stores the weight as w and applies (1 + w): zeros with
    ``plus_one``, ones without."""
    fill = torch.zeros if plus_one else torch.ones
    return {"scale": fill((dim,), dtype=dtype_of(dtype), device=device)}


def rmsnorm_specs():
    return {"scale": ("embed",)}


def _rmsnorm(scale, x, eps: float, plus_one: bool):
    xf = x.float()
    xn = xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + eps)
    w = scale.float()
    if plus_one:
        w = 1.0 + w
    return (xn * w).to(x.dtype)


class RMSNormFn(torch.autograd.Function):
    """RMSNorm with the reference's VJP (``_rmsnorm_cvjp``,
    ``repro/models/layers.py:55-84``): f32 inside, dscale summed over the
    leading axes in the scale's type, dx in x's type (the cotangent that
    crosses block boundaries stays in the compute type)."""

    @staticmethod
    def forward(ctx, scale, x, eps, plus_one):
        ctx.save_for_backward(scale, x)
        ctx.eps, ctx.plus_one = eps, plus_one
        return _rmsnorm(scale, x, eps, plus_one)

    @staticmethod
    def backward(ctx, g):
        scale, x = ctx.saved_tensors
        xf, gf = x.float(), g.float()
        inv = torch.rsqrt(xf.square().mean(-1, keepdim=True) + ctx.eps)
        xn = xf * inv
        w = scale.float()
        if ctx.plus_one:
            w = 1.0 + w
        gw = gf * w
        dx = inv * (gw - xn * (gw * xn).mean(-1, keepdim=True))
        dscale = (gf * xn).sum(dim=tuple(range(x.dim() - 1)))
        return dscale.to(scale.dtype), dx.to(x.dtype), None, None


def rmsnorm(params, x, eps: float = 1e-6, plus_one: bool = False):
    """f32 inside, cast back to x's type; under autograd through
    :class:`RMSNormFn`."""
    if torch.is_grad_enabled() and (x.requires_grad or
                                    params["scale"].requires_grad):
        return RMSNormFn.apply(params["scale"], x, eps, plus_one)
    return _rmsnorm(params["scale"], x, eps, plus_one)


def init_layernorm(dim: int, dtype: str, device):
    return {"scale": torch.ones((dim,), dtype=dtype_of(dtype), device=device),
            "bias": torch.zeros((dim,), dtype=dtype_of(dtype), device=device)}


def layernorm_specs():
    return {"scale": ("embed",), "bias": ("embed",)}


def layernorm(params, x, eps: float = 1e-5):
    """f32 inside with the population variance (``jnp.var``; torch's
    default would be the sample variance), cast back to x's type."""
    xf = x.float()
    var, mu = torch.var_mean(xf, dim=-1, keepdim=True, correction=0)
    xf = (xf - mu) * torch.rsqrt(var + eps)
    return (xf * params["scale"].float()
            + params["bias"].float()).to(x.dtype)


def activation(name: str):
    if name == "silu":
        return F.silu
    if name == "gelu":
        return lambda x: F.gelu(x, approximate="tanh")
    if name == "relu2":
        return lambda x: torch.relu(x).square()
    raise ValueError(name)


def softcap(x, cap: float):
    """gemma2 logit soft-capping: cap * tanh(x / cap) in f32; cap == 0 is
    the identity."""
    if not cap:
        return x
    return (cap * torch.tanh(x.float() / cap)).to(x.dtype)


# ---------------------------------------------------------------------------
# GLU MLP (SwiGLU / GeGLU)
# ---------------------------------------------------------------------------


def init_glu_mlp(gen: torch.Generator, d_model: int, d_ff: int, dtype: str,
                 device):
    dt = dtype_of(dtype)
    return {
        "gate": truncated_normal(gen, (d_model, d_ff), d_model ** -0.5, dt,
                                 device),
        "up": truncated_normal(gen, (d_model, d_ff), d_model ** -0.5, dt,
                               device),
        "down": truncated_normal(gen, (d_ff, d_model), d_ff ** -0.5, dt,
                                 device),
    }


def glu_mlp_specs():
    return {"gate": ("embed", "mlp"), "up": ("embed", "mlp"),
            "down": ("mlp", "embed")}


def glu_mlp(params, x, act: str = "silu", group=None):
    """With ``group`` the parameters are this member's block of the hidden
    width (column-parallel ``gate``/``up``, row-parallel ``down``) and one
    ``all_reduce`` sums the members' outputs."""
    x = tp.copy_to(x, group)
    h = activation(act)(x @ params["gate"]) * (x @ params["up"])
    return tp.reduce_from(h @ params["down"], group)


def init_mlp(gen: torch.Generator, d_model: int, d_ff: int, dtype: str,
             device, bias: bool = True):
    """The plain MLP: ``fc1`` (d_model, d_ff) then ``fc2`` (d_ff, d_model),
    each drawn as :func:`init_dense` (``fc2`` at scale d_ff ** -0.5)."""
    return {"fc1": init_dense(gen, d_model, d_ff, dtype, device, bias=bias),
            "fc2": init_dense(gen, d_ff, d_model, dtype, device, bias=bias,
                              scale=d_ff ** -0.5)}


def mlp_specs(bias: bool = True):
    return {"fc1": dense_specs("embed", "mlp", bias=bias),
            "fc2": dense_specs("mlp", "embed", bias=bias)}


def mlp(params, x, act: str = "gelu"):
    return dense(params["fc2"], activation(act)(dense(params["fc1"], x)))


# ---------------------------------------------------------------------------
# rotary position embeddings
# ---------------------------------------------------------------------------


def rope_frequencies(head_dim: int, theta: float, fraction: float = 1.0,
                     device=None):
    """Inverse frequencies (f32) of the rotated sub-dimension, and its
    width."""
    rot = int(head_dim * fraction)
    rot -= rot % 2
    exps = torch.arange(0, rot, 2, dtype=torch.float32, device=device) / rot
    return 1.0 / (theta ** exps), rot


def apply_rope(x, positions, theta: float, fraction: float = 1.0,
               style: str = "neox"):
    """x: (..., seq, heads, head_dim); positions: broadcastable to (...,
    seq).  f32 inside, cast back to x's type."""
    inv, rot = rope_frequencies(x.shape[-1], theta, fraction, x.device)
    ang = positions[..., :, None].float() * inv         # (..., seq, rot/2)
    cos = torch.cos(ang)[..., :, None, :]               # heads axis
    sin = torch.sin(ang)[..., :, None, :]
    xr, xp = x[..., :rot].float(), x[..., rot:]
    if style == "neox":
        a, b = xr[..., : rot // 2], xr[..., rot // 2:]
        out = torch.cat([a * cos - b * sin, b * cos + a * sin], dim=-1)
    elif style == "glm2d":
        a, b = xr[..., 0::2], xr[..., 1::2]
        out = torch.stack([a * cos - b * sin, b * cos + a * sin],
                          dim=-1).reshape(xr.shape)
    else:
        raise ValueError(style)
    return torch.cat([out.to(x.dtype), xp], dim=-1)


# ---------------------------------------------------------------------------
# vocab embedding + LM head
# ---------------------------------------------------------------------------


def init_embedding(gen: torch.Generator, vocab: int, d_model: int,
                   dtype: str, device):
    return {"table": truncated_normal(gen, (vocab, d_model), 1.0,
                                      dtype_of(dtype), device)}


def embedding_specs():
    # own logical axes: training of untied archs shards columns (local
    # gather); serving + tied archs shard rows like the LM head
    return {"table": ("emb_vocab", "emb_col")}


def embed_tokens(params, tokens, scale: Optional[float] = None, group=None):
    """Rows of the table; the ``scale`` multiply is in f32.  An id outside
    [0, vocab) raises (JAX would clamp it).  With ``group`` the table is
    this member's block of rows: ids outside it look up zeros and one
    ``all_reduce`` over the group leaves the one non-zero term (exact); an
    id outside the whole vocab gives zeros there."""
    if group is not None:
        rows = params["table"].shape[0]
        local = tokens - dist.get_rank(group) * rows
        hit = (local >= 0) & (local < rows)
        out = params["table"][local.clamp(0, rows - 1)]
        out = tp.reduce_from(torch.where(hit[..., None], out, 0), group)
    else:
        out = params["table"][tokens]
    if scale is not None:
        out = (out.float() * scale).to(out.dtype)
    return out


def init_lm_head(gen: torch.Generator, d_model: int, vocab: int, dtype: str,
                 device):
    return {"kernel": truncated_normal(gen, (d_model, vocab),
                                       d_model ** -0.5, dtype_of(dtype),
                                       device)}


def lm_head_specs():
    return {"kernel": ("embed", "vocab")}


def lm_head(params, x, cap: float = 0.0, group=None):
    """With ``group`` the kernel is this member's vocab columns and the
    logits are all-gathered along the vocab (the softcap is elementwise)."""
    x = tp.copy_to(x, group)
    return tp.gather_from(softcap(x @ params["kernel"], cap), group)


def tied_lm_head(embed_params, x, cap: float = 0.0, group=None):
    """As :func:`lm_head` over the embedding's (block of) rows."""
    x = tp.copy_to(x, group)
    return tp.gather_from(softcap(x @ embed_params["table"].T, cap), group)
