"""Gradient compression for the data-parallel exchange, with error feedback
(the port of ``repro/train/grad_compression.py``).

Two codecs:
  * ``int8``  — per-tensor symmetric quantisation (4x wire reduction vs f32);
    used with a shared pre-reduced scale so the summed payload stays int-exact.
  * ``topk``  — magnitude top-k sparsification (the classic deep-gradient-
    compression scheme); wire = 2 * k floats per tensor.

Both carry an error-feedback buffer so the *accumulated* gradient is unbiased
(residuals re-enter the next step), which is what keeps convergence intact.
:func:`compressed_psum` is the all-reduce of one tensor over a process
group with an int8 wire; as in the reference, no train step calls it: it is
a building block, off by default.

Trees are dicts, lists and tuples of tensors.  ``topk`` orders ties by
``torch.topk``, which need not put the lower index first as
``jax.lax.top_k`` does: without ties the two agree.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist


# ---------------------------------------------------------------------------
# codecs
# ---------------------------------------------------------------------------


def int8_encode(x: torch.Tensor, scale: Optional[torch.Tensor] = None):
    """x -> (q int8, scale). scale defaults to per-tensor max/127."""
    xf = x.float()
    if scale is None:
        scale = torch.clamp(xf.abs().max(), min=1e-12) / 127.0
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def int8_decode(q: torch.Tensor, scale) -> torch.Tensor:
    return q.float() * scale


def topk_encode(x: torch.Tensor, k_frac: float = 0.01):
    """x -> (values, flat int32 indices); k = max(1, k_frac * size)."""
    xf = x.float().reshape(-1)
    k = max(1, int(xf.numel() * k_frac))
    _, idx = torch.topk(xf.abs(), k)
    return xf[idx], idx.to(torch.int32)


def topk_decode(vals: torch.Tensor, idx: torch.Tensor, size: int):
    out = torch.zeros((size,), dtype=torch.float32, device=vals.device)
    return out.index_add_(0, idx.long(), vals)


# ---------------------------------------------------------------------------
# error feedback
# ---------------------------------------------------------------------------


def _map(fn, *trees):
    t = trees[0]
    if isinstance(t, dict):
        return {k: _map(fn, *(x[k] for x in trees)) for k in t}
    if isinstance(t, (list, tuple)):
        return type(t)(_map(fn, *xs) for xs in zip(*trees, strict=True))
    return fn(*trees)


def ef_init(params):
    return _map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                      device=p.device), params)


def ef_compress_leaf(g, err, codec: str = "int8", k_frac: float = 0.01):
    """Returns (decoded g', new error).  g' + err' == g + err exactly in
    expectation; the residual re-enters next step."""
    target = g.float() + err
    if codec == "int8":
        q, s = int8_encode(target)
        dec = int8_decode(q, s)
    elif codec == "topk":
        vals, idx = topk_encode(target, k_frac)
        dec = topk_decode(vals, idx, target.numel()).reshape(target.shape)
    else:
        raise ValueError(codec)
    return dec.to(g.dtype), target - dec


def compress_grads(grads, err_state, codec: str = "int8",
                   k_frac: float = 0.01):
    """-> (decoded gradients, new error state), trees like ``grads``."""
    both = _map(lambda g, e: ef_compress_leaf(g, e, codec, k_frac), grads,
                err_state)
    return (_map(lambda _, o: o[0], grads, both),
            _map(lambda _, o: o[1], grads, both))


# ---------------------------------------------------------------------------
# all-reduce with an int8 wire
# ---------------------------------------------------------------------------


def compressed_psum(x: torch.Tensor, group=None) -> torch.Tensor:
    """The sum of ``x`` over ``group`` with an int8 codebook on the wire:

    1. ``all_reduce(MAX)`` of the local |max| (a scalar)   -> shared scale
    2. quantise to int8, widen to int32 for the sum (the sum is exact; the
       *wire-relevant* payload is the int8 codebook)
    3. dequantise.
    """
    xf = x.float()
    gmax = xf.abs().max().reshape(1)
    dist.all_reduce(gmax, op=dist.ReduceOp.MAX, group=group)
    scale = torch.clamp(gmax[0] / 127.0, min=1e-12)
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    total = q.to(torch.int32)
    dist.all_reduce(total, group=group)
    return (total.float() * scale).to(x.dtype)


def wire_bytes_saved(nbytes_f32: int) -> int:
    return nbytes_f32 * 3 // 4
