"""Logical-axis rules on process groups (the port of
``repro/sharding/partition.py``).

Modules name their tensors' axes *logically* ("heads", "mlp", "vocab",
"experts", ...); a rules table maps each logical axis to axes of the
ambient :class:`~repro_torch.launch.mesh.Mesh`.  The reference hands the
result to GSPMD (``with_sharding_constraint``); the port's layout is
explicit instead: each member holds its block of every parameter
(:func:`shard_tree`), the model code reads :func:`current_mesh` and issues
its own collectives, and :func:`constrain` is a no-op that keeps the
reference's rank check.  :func:`gather_tree` puts full leaves back together
(checkpoints, resharding).

A layout (:class:`Layout`) is a mesh and a tree of per-leaf specs: one
entry per dimension, None (whole), a mesh axis name, or a tuple of names
(the dimension cut over their product, row-major), as the reference's
``PartitionSpec`` entries, or a :class:`Segments` entry: a fused dimension
(Mamba-2's ``in_proj`` columns z | x | B | C | dt) whose segments are each
cut or whole, where the reference's one "heads" axis cuts the dimension as
a contiguous block.  Saved and gathered leaves keep the reference's full
layout, column for column.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Any, Optional, Sequence

import torch
import torch.distributed as dist

# Default logical->physical rules for the production (data, model) mesh.
# "batch" rides (pod, data) when the pod axis exists.
DEFAULT_RULES: dict[str, object] = {
    "batch": ("pod", "data"),
    "seq": None,            # sequence usually replicated; long-context decode overrides
    "res_seq": None,        # residual-stream seq (Megatron-style sequence
                            # parallelism between layers; train rules -> model)
    "kv_seq": None,         # KV-cache sequence axis (sequence-parallel decode overrides)
    "embed": None,
    "heads": "model",
    "kv_heads": "model",
    "act_heads": None,     # head-count dim of activations (set per arch when
    "act_kv": None,        # divisible by the model axis)
    "act_groups": None,    # GQA group dim of score tensors (fallback)
    "act_qchunk": None,    # flash q-chunk dim of score tensors (fallback 2)
    "head_dim": None,
    "mlp": "model",
    "vocab": "model",
    "emb_vocab": "model",   # embedding-table rows
    "emb_col": None,        # embedding-table columns
    "experts": "model",
    "expert_mlp": None,
    "layers": None,
    "table_rows": "model",   # DLRM row-sharded embedding tables
    "stack": None,
    "conv": None,
    "state": None,
}


class _Ctx(threading.local):
    def __init__(self):
        self.mesh = None
        self.rules: dict[str, object] = dict(DEFAULT_RULES)


_CTX = _Ctx()


class axis_rules:
    """Context manager installing a mesh + logical rules (overrides on top
    of :data:`DEFAULT_RULES`) for the code it runs."""

    def __init__(self, mesh, rules: Optional[dict] = None):
        self.mesh = mesh
        self.rules = dict(DEFAULT_RULES)
        if rules:
            self.rules.update(rules)

    def __enter__(self):
        self._prev = (_CTX.mesh, _CTX.rules)
        _CTX.mesh, _CTX.rules = self.mesh, self.rules
        return self

    def __exit__(self, *exc):
        _CTX.mesh, _CTX.rules = self._prev
        return False


def current_mesh():
    return _CTX.mesh


def current_rules() -> dict:
    return _CTX.rules


def _physical(axes: Sequence[Optional[str]], rules: dict, mesh) -> tuple:
    """Map logical axes to a spec valid for ``mesh`` (a tuple of
    PartitionSpec entries): each mesh axis is used at most once, by the
    first logical axis that claims it."""
    used: set[str] = set()
    out = []
    for ax in axes:
        if ax is None:
            out.append(None)
            continue
        phys = rules.get(ax, None)
        if phys is None:
            out.append(None)
            continue
        if isinstance(phys, str):
            phys = (phys,)
        # keep only axes present in the mesh and not already used in this spec
        keep = tuple(p for p in phys if p in mesh.axis_names and p not in used)
        used.update(keep)
        if not keep:
            out.append(None)
        elif len(keep) == 1:
            out.append(keep[0])
        else:
            out.append(keep)
    return tuple(out)


def _merged(rules: Optional[dict]) -> dict:
    if rules is None:
        return _CTX.rules
    r = dict(DEFAULT_RULES)
    r.update(rules)
    return r


def spec(*axes: Optional[str], rules: Optional[dict] = None,
         mesh=None) -> tuple:
    """Resolve logical axes against ``mesh`` (default: the ambient one).
    ``rules`` are overrides on top of the defaults."""
    mesh = mesh or _CTX.mesh
    if mesh is None:
        return tuple(axes)  # best effort; only used for debugging
    return _physical(axes, _merged(rules), mesh)


def constrain(x: torch.Tensor, *axes: Optional[str]) -> torch.Tensor:
    """The reference's sharding constraint: the port's layout is explicit,
    so this only checks the rank (under a mesh, as the reference does)."""
    if _CTX.mesh is not None and len(axes) != x.dim():
        raise ValueError(f"constrain: {len(axes)} axes for rank-{x.dim()} "
                         "array")
    return x


@dataclasses.dataclass(frozen=True)
class Segments:
    """A layout entry for a dimension that concatenates segments of
    ``sizes`` (full widths), each cut over the mesh axis ``axis`` where
    ``cut`` says so and whole on every member elsewhere.  A member's block
    is its block of each cut segment and every whole one, in the same
    order."""
    axis: str
    sizes: tuple
    cut: tuple

    def local(self, n: int) -> list:
        """A member's segment widths over ``n`` blocks."""
        for size, c in zip(self.sizes, self.cut):
            if c and size % n:
                raise ValueError(f"segment of {size} does not split into "
                                 f"{n} blocks")
        return [size // n if c else size
                for size, c in zip(self.sizes, self.cut)]

    def pieces(self, x: torch.Tensor, dim: int, n: int) -> list:
        """(segment, cut) pairs of a member's block ``x`` along ``dim``."""
        return list(zip(torch.split(x, self.local(n), dim), self.cut))


def is_spec(t) -> bool:
    """A spec-tree leaf: a tuple of logical (or mesh) axis names, Nones and
    :class:`Segments` entries."""
    return isinstance(t, tuple) and all(
        a is None or isinstance(a, (str, tuple, Segments)) for a in t)


def map_specs(fn, tree, *rest, path=()):
    """``fn(path, spec, *leaves)`` over a spec tree and trees of the same
    structure (dicts, lists, tuples)."""
    if is_spec(tree):
        return fn(path, tree, *rest)
    if isinstance(tree, dict):
        return {k: map_specs(fn, v, *(r[k] for r in rest), path=path + (k,))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_specs(fn, v, *(r[i] for r in rest),
                                    path=path + (str(i),))
                          for i, v in enumerate(tree))
    raise TypeError(f"not a spec tree at {'/'.join(path)}: {tree!r}")


@dataclasses.dataclass
class Layout:
    """Where each leaf of a tree lives: ``specs`` (a tree of per-dimension
    entries) over ``mesh``."""
    mesh: Any
    specs: Any


def tree_layout(spec_tree, mesh=None, rules: Optional[dict] = None) -> Layout:
    """The counterpart of the reference's ``tree_shardings``: every leaf's
    logical axes resolved against ``mesh`` (default: the ambient one);
    ``rules`` are overrides on top of the defaults."""
    mesh = mesh or _CTX.mesh
    if mesh is None:
        raise ValueError("tree_layout requires a mesh")
    r = _merged(rules)
    return Layout(mesh, map_specs(lambda _, axes: _physical(axes, r, mesh),
                                  spec_tree))


def _axes(entry) -> tuple:
    if entry is None:
        return ()
    if isinstance(entry, Segments):
        return (entry.axis,)
    return (entry,) if isinstance(entry, str) else tuple(entry)


def is_cut(spec_: tuple) -> bool:
    """Whether a leaf of this spec is cut over some mesh axis."""
    return any(_axes(e) for e in spec_)


@dataclasses.dataclass(frozen=True)
class SegmentedCut:
    """A member's block of a leaf with a :class:`Segments` entry at ``dim``
    over ``n`` blocks: :meth:`pieces` tells its cut segments from its whole
    ones (``optimizer.global_norm`` counts a whole one once)."""
    dim: int
    segments: Segments
    n: int

    def pieces(self, x: torch.Tensor) -> list:
        return self.segments.pieces(x, self.dim, self.n)


def cut_flags(layout: "Layout"):
    """A tree of each leaf's cut flag under ``layout``: whether it is cut,
    or a :class:`SegmentedCut` for a leaf with a cut :class:`Segments`
    entry."""
    def flag(_, spec_):
        for d, e in enumerate(spec_):
            if isinstance(e, Segments) and layout.mesh.shape[e.axis] > 1:
                return SegmentedCut(d, e, layout.mesh.shape[e.axis])
        return is_cut(spec_)

    return map_specs(flag, layout.specs)


def block(mesh, entry) -> tuple[int, int]:
    """(number of blocks, this member's block) of a dimension cut over the
    mesh axes of ``entry`` (row-major over them)."""
    n, i = 1, 0
    for a in _axes(entry):
        n, i = n * mesh.shape[a], i * mesh.shape[a] + mesh.index(a)
    return n, i


def shard_leaf(x: torch.Tensor, spec_: tuple, mesh) -> torch.Tensor:
    """This member's block of the full leaf ``x`` (a copy, so the full leaf
    can go; ``x`` itself when no dimension is cut)."""
    if len(spec_) != x.dim():
        raise ValueError(f"spec {spec_} for a rank-{x.dim()} leaf")
    out = x
    for d, entry in enumerate(spec_):
        n, i = block(mesh, entry)
        if n == 1:
            continue
        if out.shape[d] % n:
            raise ValueError(f"dimension {d} of {tuple(x.shape)} does not "
                             f"split into {n} blocks")
        if isinstance(entry, Segments):
            out = torch.cat([
                p.narrow(d, i * (p.shape[d] // n), p.shape[d] // n) if c
                else p for p, c in entry.pieces(out, d, 1)], dim=d)
            continue
        size = out.shape[d] // n
        out = out.narrow(d, i * size, size)
    return out if out is x else out.clone()


def shard_tree(full_tree, layout: Layout):
    """Cut this member's block of every leaf of ``full_tree``."""
    return map_specs(lambda _, s, x: shard_leaf(x, s, layout.mesh),
                     layout.specs, full_tree)


def _gather_blocks(x: torch.Tensor, group) -> list:
    n = dist.get_world_size(group)
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x, group=group)
    return parts


def _all_gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    return torch.cat(_gather_blocks(x, group), dim=dim)


def join_blocks(blocks: list, entry, dim: int) -> torch.Tensor:
    """The full dimension ``dim`` from every member's block of it, in block
    order: their concatenation, or for a :class:`Segments` entry each cut
    segment's blocks concatenated and each whole segment taken once."""
    if not isinstance(entry, Segments):
        return torch.cat(blocks, dim=dim)
    n = len(blocks)
    split = [entry.pieces(b, dim, n) for b in blocks]
    return torch.cat([torch.cat([s[j][0] for s in split], dim=dim) if c
                      else split[0][j][0]
                      for j, c in enumerate(entry.cut)], dim=dim)


def gather_leaf(x: torch.Tensor, spec_: tuple, mesh) -> torch.Tensor:
    """The full leaf from every member's block: one ``all_gather`` along
    each cut dimension over each of its mesh axes (the innermost first)."""
    for d, entry in enumerate(spec_):
        if isinstance(entry, Segments):
            if mesh.shape[entry.axis] > 1:
                x = join_blocks(_gather_blocks(x, mesh.group(entry.axis)),
                                entry, d)
            continue
        for a in reversed(_axes(entry)):
            if mesh.shape[a] > 1:
                x = _all_gather(x, d, mesh.group(a))
    return x


def gather_tree(tree, layout: Layout):
    """Full leaves from every member's blocks (collective over the axes'
    groups: every member calls it)."""
    return map_specs(lambda _, s, x: gather_leaf(x, s, layout.mesh),
                     layout.specs, tree)
