"""Fully sharded data parallelism over the ambient mesh's ``data`` axis:
the reference's train rules put the d_model ("embed") dimension of the
weights on ``data`` (``launch/specs.py::arch_rules``), so each data member
holds a block of every such leaf (``models/api.py::param_layout``).

The reference leaves the gathers to GSPMD; the port issues them itself.
Each layer group's body gathers its leaves first (:func:`gather_tree`),
inside the group's remat region, so the recompute of the backward gathers
again and no member keeps more than one group's full leaves beyond its
blocks; the non-layer leaves (embeddings, final norms, the unembedding)
are gathered where the forward uses them.  The gather's backward is a
reduce-scatter (a sum over the data members), so a data-cut leaf's
gradient reaches its block already summed over ``data``: the train step
skips its data all-reduce (``train/steps.py``).

Without a data axis of more than one member, or rules that leave "embed"
whole, :func:`group` is None and every call here is the identity.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.sharding import partition


def group(mesh=None, rules=None):
    """The data group the rules cut weights over, or None (no mesh, one
    data member, or "embed" not on ``data``)."""
    mesh = mesh if mesh is not None else partition.current_mesh()
    if mesh is None or mesh.shape.get("data", 1) == 1:
        return None
    rules = partition.current_rules() if rules is None else \
        partition._merged(rules)
    if partition._physical(("embed",), rules, mesh)[0] != "data":
        return None
    return mesh.group("data")


def data_dim(spec_: tuple):
    """The dimension a resolved spec cuts over ``data``, or None."""
    for d, e in enumerate(spec_):
        if e == "data":
            return d
    return None


def dims(spec_tree, mesh=None, rules=None, *, skip: int = 0):
    """A tree of each leaf's data-cut dimension (or None) from the logical
    ``spec_tree`` resolved under ``mesh`` and ``rules`` (default: the
    ambient ones), less ``skip`` leading dimensions (a stacked layer
    tree's group axis, once split off)."""
    mesh = mesh if mesh is not None else partition.current_mesh()
    layout = partition.tree_layout(spec_tree, mesh, rules)

    def one(_, s):
        d = data_dim(s)
        return None if d is None else d - skip

    return partition.map_specs(one, layout.specs)


def _reduce_scatter(g: torch.Tensor, dim: int, group_) -> torch.Tensor:
    """This member's block along ``dim`` of the sum of every member's
    ``g`` (a reduce-scatter on NCCL; an all-reduce and a narrow where the
    backend has no reduce-scatter of its own)."""
    n, m = dist.get_world_size(group_), dist.get_rank(group_)
    size = g.shape[dim] // n
    if dist.get_backend(group_) == "nccl":
        parts = [p.contiguous() for p in g.split(size, dim)]
        out = torch.empty_like(parts[0])
        dist.reduce_scatter(out, parts, group=group_)
        return out
    g = g.contiguous().clone()
    dist.all_reduce(g, group=group_)
    return g.narrow(dim, m * size, size).contiguous()


class _Gather(torch.autograd.Function):
    """Forward: the full leaf from every data member's block along
    ``dim`` (``all_gather``).  Backward: the reduce-scatter (sum) of its
    gradient back to this member's block."""

    @staticmethod
    def forward(ctx, x, dim, group_):
        ctx.dim, ctx.group = dim, group_
        return partition._all_gather(x, dim, group_)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter(g, ctx.dim, ctx.group), None, None


def gather(x: torch.Tensor, dim, group_) -> torch.Tensor:
    """The full leaf of this member's block ``x`` cut along ``dim`` over
    ``group_`` (differentiable); ``x`` itself where nothing is cut."""
    if dim is None or group_ is None:
        return x
    if torch.is_grad_enabled() and x.requires_grad:
        return _Gather.apply(x, dim, group_)
    return partition._all_gather(x, dim, group_)


def gather_tree(tree, dims_tree, group_):
    """:func:`gather` over every leaf of ``tree`` with its dimension in
    ``dims_tree`` (from :func:`dims`); ``tree`` itself without a group."""
    if group_ is None:
        return tree
    if isinstance(tree, dict):
        return {k: gather_tree(v, dims_tree[k], group_)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(gather_tree(v, d, group_)
                          for v, d in zip(tree, dims_tree))
    return gather(tree, dims_tree, group_)


def gatherer(spec_tree, *, skip: int = 0):
    """A function that takes a part of a model's parameters, whose logical
    axes are ``spec_tree``'s less ``skip`` leading dimensions (keys of
    ``spec_tree`` the part lacks are ignored), and gathers whole every
    leaf the rules cut over ``data``.  The group and the dimensions are
    resolved now, under the ambient rules: a remat region's recompute
    runs in autograd's backward thread, which sees no ambient mesh.  The
    identity without a data group (:func:`group`)."""
    g = group()
    if g is None:
        return lambda tree: tree
    d = dims(spec_tree, skip=skip)
    return lambda tree: gather_tree(tree, d, g)


def gathered(tree, spec_tree, *, skip: int = 0):
    """``tree`` gathered by :func:`gatherer` of ``spec_tree`` at once."""
    return gatherer(spec_tree, skip=skip)(tree)
