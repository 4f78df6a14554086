"""AdamW with the cosine/warmup schedule and global-norm clipping (the port
of ``repro/train/optimizer.py``) as functions on trees of tensors.

The state mirrors the parameters: ``{"m": tree, "v": tree, "count": int32
0-d}``, m and v in f32.  :func:`adamw_update` updates the parameters, m and
v in place, leaf by leaf, so the transient stays one leaf's size (the
largest at granite-moe-3b-a800m is 4 GB in f32): the reference returns new
trees.  Each leaf takes the reference's operations in its order (which
``torch.optim.AdamW`` does not).  The sharding specs (``adamw_specs``) wait
for the launch tooling (ROADMAP A14f).
"""
from __future__ import annotations

import math

import torch


def leaves(tree) -> list:
    """The tensors of a tree of dicts, lists and tuples (a list of tensors
    is its own leaves), in the reference's flattening order (dict keys
    sorted)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in leaves(t)]
    return [tree]


def _like(tree, fn):
    if isinstance(tree, dict):
        return {k: _like(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_like(v, fn) for v in tree)
    return fn(tree)


def adamw_init(params):
    dev = leaves(params)[0].device
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,  # noqa: E731
                                  device=p.device)
    return {"m": _like(params, zeros), "v": _like(params, zeros),
            "count": torch.zeros((), dtype=torch.int32, device=dev)}


@torch.no_grad()
def adamw_update(grads, state, params, lr, *, b1: float = 0.9,
                 b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.1):
    """One AdamW step with bias correction and decoupled weight decay on
    every leaf, in place -> (params, state).  ``lr`` is an f32 0-d tensor
    (or a float); ``grads`` a tree like ``params`` or its :func:`leaves`."""
    count = state["count"] + 1
    cf = count.float()
    bc1 = 1.0 - torch.pow(torch.tensor(b1, dtype=torch.float32,
                                       device=cf.device), cf)
    bc2 = 1.0 - torch.pow(torch.tensor(b2, dtype=torch.float32,
                                       device=cf.device), cf)
    for g, m, v, p in zip(leaves(grads), leaves(state["m"]),
                          leaves(state["v"]), leaves(params), strict=True):
        gf = g.float()
        m.mul_(b1).add_(gf * (1.0 - b1))
        v.mul_(b2).add_(gf.square().mul_(1.0 - b2))
        step = (m / bc1).div_((v / bc2).sqrt_().add_(eps))
        step.add_(p.float() * weight_decay)
        p.sub_(step.mul_(lr))    # in f32, rounded once to p's type
        del gf, step
    state["count"] = count
    return params, state


def cosine_schedule(step, *, peak_lr: float = 3e-4, warmup: int = 100,
                    total: int = 10_000, floor: float = 0.1):
    """Linear warmup (step 0 already takes a step) into a cosine decay to
    ``floor * peak_lr``; ``step`` an int tensor -> f32 0-d tensor."""
    sf = step.float()
    warm = (sf + 1.0) / max(warmup, 1)
    prog = torch.clamp((sf - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = floor + (1.0 - floor) * 0.5 * (1.0 + torch.cos(math.pi * prog))
    return peak_lr * torch.where(sf < warmup, warm, cos)


def global_norm(tree):
    """sqrt of the sum of every leaf's squares (f32), leaves summed one
    after another in :func:`leaves` order, as the reference's ``sum``."""
    total = 0
    for x in leaves(tree):
        total = total + torch.sum(torch.square(x.float()))
    return torch.sqrt(total)


@torch.no_grad()
def clip_by_global_norm(grads, max_norm: float = 1.0):
    """Scale the gradients in place so their global norm is at most
    ``max_norm`` -> (grads, the norm before clipping)."""
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    for g in leaves(grads):
        g.mul_(scale.to(g.dtype))
    return grads, norm
