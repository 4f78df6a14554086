"""Tensor parallelism over the ambient mesh's ``model`` axis: which parts of
a model each member holds (:func:`plan`: the transformer families, rwkv6's
time and channel mix, zamba2's Mamba-2 layers and shared block), and the
collectives that join the parts, differentiable where autograd runs
through them.

The reference lets GSPMD place its collectives from the logical-axis
rules; the port issues them itself, Megatron's way.  A column-parallel
region (attention's q/k/v projections, an MLP's gate and up, the LM head)
takes the replicated input through :func:`copy_to` (identity forward, sum
of the gradient over the group backward) and a row-parallel one (``wo``,
``down``, the vocab-parallel embedding) leaves through :func:`reduce_from`
(sum forward, identity backward); the vocab-parallel LM head ends in
:func:`gather_from` (all-gather forward, this member's slice backward).
A replicated parameter or activation used inside a region that computes
part of a sum (a qk-norm scale, the MoE routing weights, the shared-expert
gate, K/V projections a member only partly uses) goes through
:func:`copy_to` too, so its gradient is summed over the members; a whole
segment of a cut fused leaf (Mamba-2's ``B``/``C`` columns of ``in_proj``)
through :func:`copy_to_slice`.  A statistic summed over the members'
channels that each member then uses on its own channels (the mean square
of Mamba-2's ``gate_norm`` over the whole ``d_inner``) is summed by
:func:`sum_shared`, whose backward sums too: Megatron's ``reduce_from``
has an identity backward, right only where everything downstream is
replicated.

Where a head count does not divide the members, that part keeps its
leaves whole and runs replicated (no collective), as chatglm3's KV heads
do: rwkv6's smoke config has 2 heads, so at P = 4 its time mix is
replicated while its channel mix is cut.

The sequence axis (the production layout's ``res_seq`` and ``kv_seq``
rules).  Under ``res_seq`` (``Plan.res_seq``) the residual stream between
blocks is this member's block of the sequence, Megatron's sequence
parallelism: a region enters through :func:`gather_seq` (all-gather
forward, reduce-scatter backward) in place of :func:`copy_to` and leaves
through :func:`scatter_seq` (reduce-scatter forward, all-gather backward)
in place of :func:`reduce_from`; :func:`split_seq` enters the cut stream
from a replicated tensor (this member's block forward, all-gather
backward).  Inside such a region every gradient is a member's part, summed
by the entry's reduce-scatter; a replicated computation there whose
gradient is whole on every member (MoE routing) takes its input through
:func:`own_seq`, which keeps only this member's block of that gradient.  A
replicated leaf used on the cut stream (the norm scales, or a part that
runs replicated) sees only this member's positions: it goes through
:func:`copy_to`, so its gradient is summed over the members in the
backward.  Under ``kv_seq`` (:func:`kv_cut`, ``Plan.kv_seq``) a KV cache
is cut by positions: each member holds a block of positions for every KV
head (``models/attention.py::decode_step``).  Every group is resolved in
the forward and held by the backward's context, never read from the
ambient mesh there.

Without a model axis of more than one member :func:`plan` is None and the
model code runs exactly its one-device path.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch
import torch.distributed as dist

from repro_torch.sharding import fsdp, partition


@dataclasses.dataclass(frozen=True)
class Plan:
    """This member's share of a transformer on a model axis of ``n``
    members (``m`` is its index, ``group`` the axis' process group).

    ``heads``: the query heads (``wq`` columns, ``wo`` rows) are cut, H / n
    a member.  ``kv``: "cut" (Kh / n KV heads a member), "select" (``wk`` /
    ``wv`` whole on every member, which projects only the ``kv_n`` heads
    from ``kv_lo`` that its query heads use: where the KV head count does
    not divide, cutting ``wk`` by columns would split a head) or "full"
    (attention replicated, no collective).  ``mlp`` / ``shared_mlp``: the
    dense MLP's / the shared experts' hidden width is cut.  ``vocab`` /
    ``emb_vocab``: the LM head's columns / the embedding's rows are cut.
    ``experts``: the routed experts are cut, E_pad / n a member.

    rwkv6 reads ``heads`` for its time mix (d_model / 64 heads: ``wr``,
    ``wk``, ``wv``, ``wg`` columns, ``wo`` rows, ``time_faaaa``) and
    ``mlp`` for its channel mix (``cm_k`` columns, ``cm_v`` rows).
    ``ssm_heads``: Mamba-2's heads (d_inner / head_dim) are cut, checked
    apart from the hybrid's shared attention, which reads the fields
    above.

    ``res_seq``: the rules put the residual stream's sequence on
    ``model`` (the forward drops it for a sequence that does not divide
    into ``n`` blocks, :func:`for_sequence`).  ``kv_seq``: the cut of the
    KV cache's positions (:func:`kv_cut`), or None."""
    n: int
    m: int
    group: Any
    heads: bool
    kv: str
    kv_lo: int
    kv_n: int
    mlp: bool
    shared_mlp: bool
    vocab: bool
    emb_vocab: bool
    experts: bool
    ssm_heads: bool = False
    res_seq: bool = False
    kv_seq: Optional["SeqCut"] = None


@dataclasses.dataclass(frozen=True)
class SeqCut:
    """A sequence axis cut into ``n`` blocks of consecutive positions over
    ``group`` (the mesh axes ``axes``, row-major, the rules' order);
    this member holds block ``m``.  An axis of L positions takes blocks of
    ``size(L)``; the last is padded where L does not divide."""
    n: int
    m: int
    group: Any
    axes: tuple

    def size(self, length: int) -> int:
        return -(-length // self.n)


# the KV caches' logical axes: "batch" claims its mesh axes first, then
# "kv_seq", then "kv_heads" (``partition._physical``)
_CACHE_AXES = ("batch", "kv_seq", "kv_heads")


def kv_cut(mesh=None, rules: Optional[dict] = None) -> Optional[SeqCut]:
    """The cut of a KV cache's positions under ``mesh`` and ``rules``
    (default: the ambient ones): the mesh axes of more than one member
    that "kv_seq" claims after "batch" ("model" for a batch of rows,
    ("data", "model") under the batch-1 rule), or None."""
    mesh = mesh if mesh is not None else partition.current_mesh()
    if mesh is None:
        return None
    rules = partition.current_rules() if rules is None else \
        partition._merged(rules)
    entry = partition._physical(_CACHE_AXES, rules, mesh)[1]
    axes = tuple(a for a in partition._axes(entry) if mesh.shape[a] > 1)
    if not axes:
        return None
    n, m = partition.block(mesh, axes)
    return SeqCut(n=n, m=m, group=mesh.group(axes), axes=axes)


def cache_cut(tp: Optional[Plan]) -> Optional[SeqCut]:
    """The KV cache's cut: the plan's, or without a plan (no model axis)
    the ambient rules' (a cut over ``data`` alone)."""
    return tp.kv_seq if tp is not None else kv_cut()


def for_sequence(tp: Optional[Plan], length: int) -> Optional[Plan]:
    """``tp`` for a forward over ``length`` positions: ``res_seq`` holds
    only where they divide into the members' blocks, as the reference's
    rules test the cell's sequence."""
    if tp is None or not tp.res_seq or length % tp.n == 0:
        return tp
    return dataclasses.replace(tp, res_seq=False)


def seq_group(tp: Optional[Plan]):
    """The model group when the residual stream is cut by sequence, else
    None."""
    return tp.group if tp is not None and tp.res_seq else None


# the families whose residual stream the "res_seq" rule cuts (the
# reference's train rules set it for these only)
SEQ_FAMILIES = ("dense", "moe", "vlm")


def _to_model(ax: str, rules: dict, mesh) -> bool:
    return "model" in partition._axes(
        partition._physical((ax,), rules, mesh)[0])


def plan(cfg, mesh=None, rules: Optional[dict] = None) -> Optional[Plan]:
    """The split of ``cfg``'s model under ``mesh`` and ``rules``
    (default: the ambient ones), or None without a model axis of more than
    one member.  A dimension the rules put on ``model`` is cut only where
    it divides into whole heads or even blocks."""
    mesh = mesh if mesh is not None else partition.current_mesh()
    if mesh is None or mesh.shape["model"] == 1:
        return None
    rules = partition.current_rules() if rules is None else \
        partition._merged(rules)
    n, m = mesh.shape["model"], mesh.index("model")
    kv_seq = kv_cut(mesh, rules)
    if kv_seq is not None and "model" in kv_seq.axes and \
            kv_seq.axes[-1] != "model":
        raise ValueError(f"a KV cache cut over {kv_seq.axes}: the port "
                         "needs 'model' innermost")
    h, kh = cfg.n_heads, cfg.n_kv_heads
    if cfg.family == "ssm":      # rwkv6's time mix: heads of HEAD_SIZE 64
        h = kh = cfg.d_model // 64
    heads = _to_model("heads", rules, mesh) and h % n == 0
    kv, kv_lo, kv_n = "full", 0, kh
    if heads and kh % n == 0:
        kv, kv_lo, kv_n = "cut", m * kh // n, kh // n
    elif heads and (h // kh) % (h // n) == 0:
        # every local query head maps to one KV head
        kv, kv_lo, kv_n = "select", (m * (h // n)) // (h // kh), 1
    elif heads:
        heads = False          # query heads would span KV heads unevenly
    moe = getattr(cfg, "moe", None)
    fs = moe.n_shared_experts * moe.d_shared_expert if moe else 0
    mlp_rule = _to_model("mlp", rules, mesh)
    experts = moe is not None and _to_model("experts", rules, mesh)
    ssm_heads = False
    if cfg.family == "hybrid":   # Mamba-2's heads: d_inner / head_dim
        nh = cfg.ssm.expand * cfg.d_model // cfg.ssm.head_dim
        ssm_heads = _to_model("heads", rules, mesh) and nh % n == 0
    return Plan(n=n, m=m, group=mesh.group("model"), heads=heads, kv=kv,
                kv_lo=kv_lo, kv_n=kv_n,
                mlp=mlp_rule and cfg.d_ff % n == 0,
                shared_mlp=bool(fs) and mlp_rule and fs % n == 0,
                vocab=_to_model("vocab", rules, mesh)
                and cfg.vocab_size % n == 0,
                emb_vocab=_to_model("emb_vocab", rules, mesh)
                and cfg.vocab_size % n == 0,
                experts=experts, ssm_heads=ssm_heads,
                res_seq=_to_model("res_seq", rules, mesh) and
                cfg.family in SEQ_FAMILIES, kv_seq=kv_seq)


# ---------------------------------------------------------------------------
# collectives (differentiable under autograd)
# ---------------------------------------------------------------------------


def _tracked(x: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and x.requires_grad


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _CopyToSlice(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, start, length):
        ctx.group, ctx.start, ctx.length = group, start, length
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        part = g.narrow(-1, ctx.start, ctx.length).contiguous()
        dist.all_reduce(part, group=ctx.group)
        g.narrow(-1, ctx.start, ctx.length).copy_(part)
        return g, None, None, None


class _SumShared(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.contiguous().clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        y = x.contiguous().clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.dim, ctx.size = dim, x.shape[dim]
        ctx.m = dist.get_rank(group)
        return partition._all_gather(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.m * ctx.size, ctx.size).contiguous(), \
            None, None


def copy_to(x: torch.Tensor, group) -> torch.Tensor:
    """Enter a region that computes part of a sum: the identity, whose
    backward sums the gradient over ``group``."""
    if group is None or not _tracked(x):
        return x
    return _CopyTo.apply(x, group)


def copy_to_slice(x: torch.Tensor, group, start: int,
                  length: int) -> torch.Tensor:
    """:func:`copy_to` for the ``length`` last-dimension entries from
    ``start`` only (the whole segments of a cut fused leaf): the identity,
    whose backward sums that part of the gradient over ``group`` and keeps
    the rest, this member's own."""
    if group is None or not _tracked(x):
        return x
    return _CopyToSlice.apply(x, group, start, length)


def sum_shared(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of the members' ``x`` over ``group`` (one ``all_reduce``),
    for a statistic every member goes on to use on its own channels: the
    backward sums the gradient over the group too (each member's gradient
    is the part its own channels give)."""
    if group is None:
        return x
    if _tracked(x):
        return _SumShared.apply(x, group)
    x = x.contiguous()
    dist.all_reduce(x, group=group)
    return x


def reduce_from(x: torch.Tensor, group) -> torch.Tensor:
    """Sum the members' parts over ``group`` (one ``all_reduce``; in place
    on an untracked ``x``, which the caller hands over)."""
    if group is None:
        return x
    if _tracked(x):
        return _ReduceFrom.apply(x, group)
    x = x.contiguous()
    dist.all_reduce(x, group=group)
    return x


def gather_from(x: torch.Tensor, group, dim: int = -1) -> torch.Tensor:
    """Concatenate the members' blocks along ``dim`` (one ``all_gather``);
    backward keeps this member's block of the gradient."""
    dim = dim % x.dim()
    if group is None:
        return x
    if _tracked(x):
        return _GatherFrom.apply(x, group, dim)
    return partition._all_gather(x, dim, group)


# ---------------------------------------------------------------------------
# the sequence collectives (``res_seq``; differentiable under autograd)
# ---------------------------------------------------------------------------


def _block(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    n, m = dist.get_world_size(group), dist.get_rank(group)
    if x.shape[dim] % n:
        raise ValueError(f"a sequence of {x.shape[dim]} does not split into "
                         f"{n} blocks")
    size = x.shape[dim] // n
    return x.narrow(dim, m * size, size).contiguous()


class _GatherSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return partition._all_gather(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return fsdp._reduce_scatter(g, ctx.dim, ctx.group), None, None


class _ScatterSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return fsdp._reduce_scatter(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return partition._all_gather(g, ctx.dim, ctx.group), None, None


class _SplitSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _block(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return partition._all_gather(g, ctx.dim, ctx.group), None, None


class _OwnSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.dim = dim
        ctx.n, ctx.m = dist.get_world_size(group), dist.get_rank(group)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        size = g.shape[ctx.dim] // ctx.n
        out = torch.zeros_like(g)
        out.narrow(ctx.dim, ctx.m * size, size).copy_(
            g.narrow(ctx.dim, ctx.m * size, size))
        return out, None, None


def gather_seq(x: torch.Tensor, group, dim: int = 1) -> torch.Tensor:
    """Enter a region from the sequence-cut stream: the members' blocks
    concatenated along ``dim`` (one ``all_gather``); backward, this
    member's block of the sum of the members' gradients (a
    reduce-scatter)."""
    if group is None:
        return x
    if _tracked(x):
        return _GatherSeq.apply(x, group, dim)
    return partition._all_gather(x, dim, group)


def scatter_seq(x: torch.Tensor, group, dim: int = 1) -> torch.Tensor:
    """Leave a region into the sequence-cut stream: this member's block
    along ``dim`` of the sum of the members' parts (a reduce-scatter);
    backward, the members' gradient blocks concatenated (an
    ``all_gather``)."""
    if group is None:
        return x
    if _tracked(x):
        return _ScatterSeq.apply(x, group, dim)
    return fsdp._reduce_scatter(x, dim, group)


def split_seq(x: torch.Tensor, group, dim: int = 1) -> torch.Tensor:
    """Enter the sequence-cut stream from a tensor whole on every member:
    this member's block along ``dim``; backward, the members' gradient
    blocks concatenated (an ``all_gather``)."""
    if group is None:
        return x
    if _tracked(x):
        return _SplitSeq.apply(x, group, dim)
    return _block(x, dim, group)


def own_seq(x: torch.Tensor, group, dim: int = 1) -> torch.Tensor:
    """The identity for a replicated computation inside a region entered
    by :func:`gather_seq` whose gradient is whole on every member (MoE
    routing): backward keeps this member's block of the gradient along
    ``dim`` and zeroes the rest, so that the entry's sum counts it once."""
    if group is None or not _tracked(x):
        return x
    return _OwnSeq.apply(x, group, dim)
