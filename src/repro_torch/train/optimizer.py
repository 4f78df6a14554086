"""AdamW with the cosine/warmup schedule and global-norm clipping (the port
of ``repro/train/optimizer.py``) as functions on trees of tensors.

The state mirrors the parameters: ``{"m": tree, "v": tree, "count": int32
0-d}``, m and v in f32.  :func:`adamw_update` updates the parameters, m and
v in place, leaf by leaf, so the transient stays one leaf's size (the
largest at granite-moe-3b-a800m is 4 GB in f32): the reference returns new
trees.  Each leaf takes the reference's operations in its order (which
``torch.optim.AdamW`` does not).  Over a mesh the state's leaves are the
members' blocks of the parameters' (:func:`adamw_layout`); the update is
elementwise, and :func:`global_norm` sums the squares of the cut leaves
over the model group, and of the FSDP blocks over the data group.  :func:`adamw_specs` gives the state's logical axes
(the dry run's optimizer layouts).  On the meta device
:func:`adamw_init` makes the state's stand-ins.
"""
from __future__ import annotations

import math

import torch

from repro_torch.sharding import partition


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


def adamw_specs(param_specs):
    """Optimizer-state logical axes mirror the parameters'."""
    return {"m": param_specs, "v": param_specs, "count": ()}


def adamw_layout(param_layout):
    """The optimizer state's layout from the parameters': m and v as the
    parameters, the step count whole."""
    return partition.Layout(param_layout.mesh,
                            adamw_specs(param_layout.specs))


def global_norm(tree, *, cut=None, group=None, data_cut=None,
                data_group=None):
    """sqrt of the sum of every leaf's squares (f32), leaves summed one
    after another in :func:`leaves` order, as the reference's ``sum``.
    ``cut`` (one flag a leaf, in :func:`leaves` order:
    ``partition.cut_flags``) marks the leaves that are this member's block
    of a leaf cut over ``group``: their sum is all-reduced over the group,
    and each whole (replicated) leaf counts once; a flag with ``pieces``
    (a fused leaf, ``partition.SegmentedCut``) splits its leaf into cut
    and whole segments.  ``data_cut`` marks the leaves cut over
    ``data_group`` too (FSDP): their sums are all-reduced over it once."""
    if group is None:
        cut = None
    if data_group is None:
        data_cut = None
    if cut is None and data_cut is None:
        total = 0
        for x in leaves(tree):
            total = total + torch.sum(torch.square(x.float()))
        return torch.sqrt(total)
    xs = leaves(tree)
    cut = cut or [False] * len(xs)
    data_cut = data_cut or [False] * len(xs)
    # by (cut over the group, cut over data): whole, model, data, both
    parts = [0, 0, 0, 0]
    for x, c, dc in zip(xs, cut, data_cut, strict=True):
        for piece, is_cut in (c.pieces(x) if hasattr(c, "pieces")
                              else [(x, c)]):
            k = int(bool(is_cut)) + 2 * int(bool(dc))
            parts[k] = parts[k] + torch.sum(torch.square(piece.float()))
    local = torch.stack([torch.as_tensor(p, dtype=torch.float32,
                                         device=xs[0].device)
                         for p in parts[1:]])
    if group is not None:
        m = local[0::2].contiguous()             # model, both
        torch.distributed.all_reduce(m, group=group)
        local[0::2] = m
    if data_group is not None:
        d = local[1:].contiguous()               # data, both
        torch.distributed.all_reduce(d, group=data_group)
        local[1:] = d
    return torch.sqrt(parts[0] + local[0] + local[1] + local[2])


@torch.no_grad()
def clip_by_global_norm(grads, max_norm: float = 1.0, *, cut=None,
                        group=None, data_cut=None, data_group=None):
    """Scale the gradients in place so their global norm is at most
    ``max_norm`` -> (grads, the norm before clipping); the cut flags and
    groups as in :func:`global_norm`."""
    norm = global_norm(grads, cut=cut, group=group, data_cut=data_cut,
                       data_group=data_group)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    for g in leaves(grads):
        g.mul_(scale.to(g.dtype))
    return grads, norm
