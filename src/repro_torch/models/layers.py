"""Dense layers of the port (the ``truncated_normal``/``init_dense``/
``dense`` subset of ``repro/models/layers.py``).

Parameters keep the reference's ``{"kernel": (d_in, d_out), "bias":
(d_out,)}`` layout, so converting a reference parameter is a plain copy.
"""
from __future__ import annotations

from typing import Optional

import torch


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


def dense(params, x):
    y = x @ params["kernel"]
    if "bias" in params:
        y = y + params["bias"]
    return y
