"""Mixture-of-Experts FFN with two dispatch strategies (the port of
``repro/models/moe.py``, function by function).

``gather`` (default): every member holds the whole token batch, gathers
the tokens routed to ITS experts into a capacity-padded (E_local, C, D)
buffer (a local sort and scatter), runs its experts, scatter-adds the
weighted outputs and sums over the group: one ``all_reduce`` per MoE layer
and no all-to-all.

``a2a`` (expert parallelism, the paper's alltoallv analogue): each member
holds its own sequence shard, routes its tokens, packs per-destination
capacity-padded send buffers, exchanges them with ``all_to_all_single``,
computes its local experts and sends the results back the same way.  The
stages are split out (:func:`a2a_stage_a`, :func:`a2a_dispatch`,
:func:`a2a_stage_b`) so that ``core/bls.py::bls_pipeline`` can put the
dispatch exchange under a bounded lag, as the paper does for the DLRM
exchange.

Where the reference reads a process-wide mesh, the port takes a
``torch.distributed`` process group (``group=None``: one device, no
collective).  Every member holds the reference's global parameters, as the
port's DLRM members hold the whole stack, and slices its experts
``[m · E_local, (m + 1) · E_local)``.

Out-of-range indices: JAX drops out-of-range scatter targets
(``mode="drop"``) and clamps gathers; torch raises.  Dropped slots go to
one sink row past the end of each buffer, which is cut off, and gathers
clamp their indices explicitly.  The scatter-adds that combine a token's
k slots are sums over the k slots in top-k order (deterministic on the
card, where ``index_add_`` of floats is not).

Both modes are held against :func:`moe_ref_dense` (every token through its
experts, no capacity drop).

Inside the model over a mesh (:func:`moe_members`, which the transformer
calls with a ``sharding/tp.py::Plan``) each member holds only its
block of the routed experts (and of the shared experts' hidden width), as
the reference's ``P("model", ...)`` in-specs give each device: ``gather``
sums its experts' outputs and its part of the shared experts in one
``all_reduce``; ``a2a`` takes its ``S / n`` slice of the sequence, exchanges
it, and ``all_gather``s the sequence back.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from repro_torch.configs.base import ModelConfig, MoEConfig
from repro_torch.core.bls import Issued
from repro_torch.models import layers as L
from repro_torch.sharding import tp as TP

# ---------------------------------------------------------------------------
# params
# ---------------------------------------------------------------------------


def padded_experts(moe: MoEConfig, n_shards: int) -> int:
    e = moe.n_experts
    return ((e + n_shards - 1) // n_shards) * n_shards


def init_moe(gen: torch.Generator, cfg: ModelConfig, device,
             n_shards: int = 16):
    """The reference's layout and distributions: routed experts padded to
    ``padded_experts(moe, n_shards)``, the router in f32, the rest in
    ``cfg.dtype``."""
    moe = cfg.moe
    d, f = cfg.d_model, moe.d_expert
    e_pad = padded_experts(moe, n_shards)
    dt = L.dtype_of(cfg.dtype)
    s_in, s_out = d ** -0.5, f ** -0.5
    p = {
        "router": L.truncated_normal(gen, (d, e_pad), s_in, torch.float32,
                                     device),
        "gate": L.truncated_normal(gen, (e_pad, d, f), s_in, dt, device),
        "up": L.truncated_normal(gen, (e_pad, d, f), s_in, dt, device),
        "down": L.truncated_normal(gen, (e_pad, f, d), s_out, dt, device),
    }
    if moe.n_shared_experts:
        fs = moe.n_shared_experts * moe.d_shared_expert
        p["shared"] = L.init_glu_mlp(gen, d, fs, cfg.dtype, device)
        p["shared_gate"] = L.init_dense(gen, d, 1, cfg.dtype, device)
    return p


def moe_specs(cfg: ModelConfig):
    p = {
        "router": ("embed", None),
        "gate": ("experts", "embed", "expert_mlp"),
        "up": ("experts", "embed", "expert_mlp"),
        "down": ("experts", "expert_mlp", "embed"),
    }
    if cfg.moe.n_shared_experts:
        p["shared"] = L.glu_mlp_specs()
        p["shared_gate"] = L.dense_specs("embed", None)
    return p


# ---------------------------------------------------------------------------
# routing + local dispatch machinery
# ---------------------------------------------------------------------------


def route(router_w, x, moe: MoEConfig, e_pad: int):
    """x:(T,D) -> (weights (T,k), expert_idx (T,k), router_probs (T,E_pad)).
    The top k by a stable descending sort: among equal probabilities the
    lower expert comes first, as ``jax.lax.top_k`` orders them.  A bf16
    router (a serving cell's) is widened to f32, as JAX promotes it."""
    logits = x.float() @ router_w.float()                # (T, E_pad)
    if e_pad > moe.n_experts:  # phantom padding experts never win
        mask = torch.arange(e_pad, device=x.device) < moe.n_experts
        logits = torch.where(mask, logits, float("-inf"))
    probs = torch.softmax(logits, dim=-1)
    w, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    w, idx = w[:, :moe.experts_per_token], idx[:, :moe.experts_per_token]
    w = w / torch.clamp(w.sum(-1, keepdim=True), min=1e-9)  # renormalise
    return w, idx, probs


def load_balance_loss(probs, idx, n_experts: int):
    """Switch-style auxiliary loss (train-time)."""
    e = probs.shape[-1]
    hot = torch.nn.functional.one_hot(idx[..., 0], e).float()
    return n_experts * torch.sum(hot.mean(0) * probs.mean(0))


def dispatch_indices(expert_idx, n_exp: int, cap: int):
    """Group token-slots by expert.

    expert_idx: (T, k) possibly containing out-of-range ids (other shards).
    Returns sorted views: fe (expert id), ft (source token), pos (slot within
    expert), valid (in-range and under capacity), order (perm over T*k).
    """
    t, k = expert_idx.shape
    dev = expert_idx.device
    fe = expert_idx.reshape(-1)
    order = torch.argsort(fe, stable=True)
    fe_s = fe[order]
    ft_s = torch.arange(t, device=dev).repeat_interleave(k)[order]
    starts = torch.searchsorted(
        fe_s, torch.arange(n_exp, dtype=fe_s.dtype, device=dev), side="left")
    pos = torch.arange(t * k, device=dev) - \
        starts[torch.clamp(fe_s, 0, n_exp - 1)]
    valid = (fe_s >= 0) & (fe_s < n_exp) & (pos < cap)
    return fe_s, ft_s, pos, valid, order


def capacity(t_tokens: int, k: int, n_buckets: int, factor: float) -> int:
    c = int(t_tokens * k / n_buckets * factor)
    return max(8, -(-c // 8) * 8)  # round up to a multiple of 8


def _expert_mlp(params, buf, act: str):
    """buf:(E,C,D) -> (E,C,D) through per-expert GLU (batched products)."""
    a = L.activation(act)
    h = a(torch.bmm(buf, params["gate"])) * torch.bmm(buf, params["up"])
    return torch.bmm(h, params["down"])


def _scatter_rows(rows, bucket, slot, valid, n_buckets: int, cap: int):
    """The reference's ``zeros((n_buckets, cap, D)).at[bucket,
    slot].set(rows, mode="drop")`` with every invalid row sent to one sink
    row past the end: valid (bucket, slot) pairs are distinct, so the
    result does not depend on the order of the writes."""
    d = rows.shape[-1]
    flat = torch.where(valid, bucket * cap + slot, n_buckets * cap)
    buf = rows.new_zeros((n_buckets * cap + 1, d))
    buf[flat] = rows
    return buf[:-1].view(n_buckets, cap, d)


def _combine(y, order, t: int, k: int):
    """The reference's ``zeros((t, D)).at[ft].add(y)`` over the sorted slots:
    each token's k slots put back in top-k order and summed."""
    slots = torch.empty_like(y)
    slots[order] = y
    return slots.view(t, k, -1).sum(1)


def _moe_local(params, x, moe: MoEConfig, act: str, e_pad: int, cap: int,
               expert_offset: int = 0, n_local: Optional[int] = None):
    """Single-shard MoE over x:(T,D) for experts [offset, offset+n_local)."""
    w, idx, probs = route(params["router"], x, moe, e_pad)
    return _experts_combine(params, x, w, idx, act, cap, expert_offset,
                            n_local if n_local is not None else e_pad), \
        (probs, idx)


def _experts_combine(params, x, w, idx, act: str, cap: int,
                     expert_offset: int, n_local: int):
    """The routed slots of x:(T,D) (weights w, experts idx (T,k)) that fall
    on experts [offset, offset+n_local), through those experts and
    combined per token -> (T,D)."""
    t, k = idx.shape
    fe, ft, pos, valid, order = dispatch_indices(idx - expert_offset,
                                                 n_local, cap)
    fw = w.reshape(-1)[order]
    buf = _scatter_rows(x[ft], fe, pos, valid, n_local, cap)
    out_buf = _expert_mlp(params, buf, act)
    y = out_buf[torch.clamp(fe, 0, n_local - 1), torch.clamp(pos, 0, cap - 1)]
    y = y * (fw * valid)[:, None].to(y.dtype)
    return _combine(y, order, t, k)


def _local_experts(params, m: int, e_loc: int):
    """Member ``m``'s slice of the routed experts (views)."""
    sl = slice(m * e_loc, (m + 1) * e_loc)
    return {"gate": params["gate"][sl], "up": params["up"][sl],
            "down": params["down"][sl]}


def _members(group):
    return dist.get_world_size(group), dist.get_rank(group)


# ---------------------------------------------------------------------------
# gather mode (every member holds every token, all_reduce combine)
# ---------------------------------------------------------------------------


def moe_gather(params, cfg: ModelConfig, x, group=None):
    """x:(B,S,D), the same on every member of ``group`` -> same out.  With
    ``group`` each member runs its expert slice and one ``all_reduce``
    sums the members' outputs; a group of one member computes the local
    branch's values."""
    moe = cfg.moe
    b, s, d = x.shape
    e_pad = params["gate"].shape[0]
    xl = x.reshape(b * s, d)
    cap = capacity(b * s, moe.experts_per_token, e_pad, moe.capacity_factor)
    if group is None:
        out, (probs, idx) = _moe_local(params, xl, moe, cfg.act, e_pad, cap)
    else:
        n_shards, m = _members(group)
        e_loc = e_pad // n_shards
        p_local = dict(_local_experts(params, m, e_loc),
                       router=params["router"])
        out, (probs, idx) = _moe_local(p_local, xl, moe, cfg.act, e_pad, cap,
                                       expert_offset=m * e_loc,
                                       n_local=e_loc)
        dist.all_reduce(out, group=group)
    aux = load_balance_loss(probs, idx, moe.n_experts)
    return _add_shared(params, cfg, x, out.reshape(b, s, d)), aux


def _add_shared(params, cfg: ModelConfig, x, routed, group=None):
    """routed + the gated shared experts (with ``group``: this member's
    part of their hidden width, summed over the group)."""
    if not cfg.moe.n_shared_experts:
        return routed
    shared = L.glu_mlp(params["shared"], x, cfg.act, group)
    g = torch.sigmoid(L.dense(params["shared_gate"], x).float())
    return routed + (shared.float() * g).to(routed.dtype)


# ---------------------------------------------------------------------------
# a2a mode (expert parallel, the paper's alltoallv analogue)
# ---------------------------------------------------------------------------


def a2a_capacities(t_loc: int, moe: MoEConfig, n_shards: int,
                   e_pad: int) -> tuple[int, int]:
    """(c_send, c_exp): slots a member sends each destination, and slots
    each local expert takes from everything it receives."""
    c_send = capacity(t_loc, moe.experts_per_token, n_shards,
                      moe.capacity_factor)
    c_exp = capacity(t_loc * n_shards, moe.experts_per_token, e_pad,
                     moe.capacity_factor)
    return c_send, c_exp


def a2a_stage_a(router_w, xl, moe: MoEConfig, e_pad: int, n_shards: int,
                c_send: int):
    """Route this member's tokens xl:(t_loc,D) and pack them by destination
    member -> (payload (send (P, c_send, D), local-expert ids (P, c_send)
    int32; padding slots carry id E_local, dropped at the receiver), side
    (de, dp, fw, valid, order, probs, idx) for the combine)."""
    e_loc = e_pad // n_shards
    w, idx, probs = route(router_w, xl, moe, e_pad)
    dest = torch.div(idx, e_loc, rounding_mode="floor")
    fe, ft, pos, valid, order = dispatch_indices(dest, n_shards, c_send)
    fw = w.reshape(-1)[order]
    fx = idx.reshape(-1)[order]   # global expert id, sorted by destination
    de = torch.where(valid, fe, n_shards)
    dp = torch.where(valid, pos, 0)
    send = _scatter_rows(xl[ft], fe, pos, valid, n_shards, c_send)
    eid = torch.full((n_shards * c_send + 1,), e_loc, dtype=torch.int32,
                     device=xl.device)
    eid[torch.where(valid, fe * c_send + pos, n_shards * c_send)] = \
        (fx % e_loc).to(torch.int32)
    eid = eid[:-1].view(n_shards, c_send)
    return (send, eid), (de, dp, fw, valid, order, probs, idx)


class _Both:
    """Two in-flight collectives waited on as one."""

    def __init__(self, *works):
        self.works = works

    def wait(self):
        for w in self.works:
            w.wait()


def a2a_dispatch(payload, group) -> Issued:
    """Initiate the dispatch exchange: the token rows and their local-expert
    ids, one ``all_to_all_single`` each, both in flight."""
    send, eid = payload
    recv, recv_eid = torch.empty_like(send), torch.empty_like(eid)
    w1 = dist.all_to_all_single(recv, send, group=group, async_op=True)
    w2 = dist.all_to_all_single(recv_eid, eid, group=group, async_op=True)
    return Issued((recv, recv_eid), _Both(w1, w2), keep=payload)


def a2a_stage_b(experts, act: str, recv_p, side, group, c_exp: int):
    """Run the local experts over the received slots, send the results back
    (one ``all_to_all_single``; reply slots line up with send slots) and
    combine them at the origin -> (t_loc, D)."""
    recv, recv_eid = recv_p
    de, dp, fw, valid, order, _, idx = side
    n_shards, c_send, d = recv.shape
    e_loc = experts["gate"].shape[0]
    rx = recv.reshape(-1, d)
    fe2, ft2, pos2, valid2, _ = dispatch_indices(
        recv_eid.reshape(-1, 1), e_loc, c_exp)
    buf = _scatter_rows(rx[ft2], fe2, pos2, valid2, e_loc, c_exp)
    out_buf = _expert_mlp(experts, buf, act)
    ry = out_buf[torch.clamp(fe2, 0, e_loc - 1),
                 torch.clamp(pos2, 0, c_exp - 1)]
    ry = ry * valid2[:, None].to(ry.dtype)
    # one slot a received row (k = 1): the reference's scatter-add is a
    # permutation
    back = torch.empty_like(ry)
    back[ft2] = ry
    reply = torch.empty_like(recv)
    dist.all_to_all_single(reply, back.view(n_shards, c_send, d),
                           group=group)
    flat = torch.clamp(de * c_send + dp, max=n_shards * c_send - 1)
    y = reply.reshape(n_shards * c_send, d)[flat]
    y = y * (fw * valid)[:, None].to(y.dtype)
    t_loc, k = idx.shape
    return _combine(y, order, t_loc, k)


def moe_a2a(params, cfg: ModelConfig, x, group=None):
    """x:(B,S_loc,D), this member's own sequence shard -> (its shard of the
    output, the balance loss of its tokens), through the explicit
    all-to-all dispatch; without a group, the gather mode."""
    if group is None:
        return moe_gather(params, cfg, x)
    moe = cfg.moe
    n_shards, m = _members(group)
    e_pad = params["gate"].shape[0]
    b, s, d = x.shape
    xl = x.reshape(-1, d)
    c_send, c_exp = a2a_capacities(xl.shape[0], moe, n_shards, e_pad)
    payload, side = a2a_stage_a(params["router"], xl, moe, e_pad, n_shards,
                                c_send)
    recv = a2a_dispatch(payload, group).wait()
    out = a2a_stage_b(_local_experts(params, m, e_pad // n_shards), cfg.act,
                      recv, side, group, c_exp)
    probs, idx = side[-2:]
    aux = load_balance_loss(probs, idx, moe.n_experts)
    return _add_shared(params, cfg, x, out.reshape(x.shape)), aux


def moe_ffn(params, cfg: ModelConfig, x, group=None):
    if cfg.moe.dispatch == "a2a":
        return moe_a2a(params, cfg, x, group)
    return moe_gather(params, cfg, x, group)


def moe_members(params, cfg: ModelConfig, x, tp):
    """x:(B,S,D), the same on every member of the model axis -> (the same
    out on every member, aux), with this member's block of the routed
    experts (E_pad / n from ``tp.m`` · E_pad / n) and of the shared
    experts' hidden width.

    ``gather``: route every token, run the local experts and the local part
    of the shared experts, one ``all_reduce`` sums the members' parts.
    ``a2a``: this member's S / n slice of the sequence through the
    exchange of :func:`moe_a2a`, one ``all_gather`` of the slices; the
    shared experts as a column/row-parallel MLP.  The a2a exchange is not
    differentiable: under autograd it raises, as it does where S does not
    split into n slices (decode: S = 1)."""
    moe = cfg.moe
    if not tp.experts:
        raise ValueError(f"{cfg.name}: the rules leave the routed experts "
                         "whole on a model axis of "
                         f"{tp.n} members; the port cuts them")
    b, s, d = x.shape
    n, m, group = tp.n, tp.m, tp.group
    e_loc = params["gate"].shape[0]
    e_pad = e_loc * n
    xl = x.reshape(b * s, d)
    shared_group = group if tp.shared_mlp else None
    if moe.dispatch == "a2a":
        if s % n:
            raise ValueError(f"moe a2a over {n} members needs the sequence "
                             f"to split into {n} slices: S = {s}, P = {n}")
        if torch.is_grad_enabled() and (x.requires_grad or
                                        params["gate"].requires_grad):
            raise NotImplementedError("moe a2a over members is not "
                                      "differentiable; train with 'gather'")
        xs = x[:, m * (s // n):(m + 1) * (s // n)].reshape(-1, d)
        c_send, c_exp = a2a_capacities(xs.shape[0], moe, n, e_pad)
        payload, side = a2a_stage_a(params["router"], xs, moe, e_pad, n,
                                    c_send)
        recv = a2a_dispatch(payload, group).wait()
        out = a2a_stage_b({k: params[k] for k in ("gate", "up", "down")},
                          cfg.act, recv, side, group, c_exp)
        routed = TP.gather_from(out.view(b, s // n, d), group, dim=1)
        probs, idx = side[-2:]
        return _add_shared(params, cfg, x, routed, shared_group), \
            load_balance_loss(probs, idx, moe.n_experts)
    cap = capacity(b * s, moe.experts_per_token, e_pad, moe.capacity_factor)
    w, idx, probs = route(params["router"], xl, moe, e_pad)
    xe = TP.copy_to(xl, group)
    out = _experts_combine(params, xe, TP.copy_to(w, group), idx, cfg.act,
                           cap, m * e_loc, e_loc).view(b, s, d)
    aux = load_balance_loss(probs, idx, moe.n_experts)
    if moe.n_shared_experts and shared_group is not None:
        # the local part of the shared experts joins the routed sum
        shared = L.glu_mlp(params["shared"], xe.view(b, s, d), cfg.act)
        g = torch.sigmoid(L.dense(params["shared_gate"], x).float())
        out = out + (shared.float() * TP.copy_to(g, group)).to(out.dtype)
        return TP.reduce_from(out, group), aux
    out = TP.reduce_from(out, group)
    return _add_shared(params, cfg, x, out), aux


# ---------------------------------------------------------------------------
# dense reference (oracle for tests; no capacity drops)
# ---------------------------------------------------------------------------


def moe_ref_dense(params, cfg: ModelConfig, x):
    """Every token through all its top-k experts, no capacity: the
    reference's one-hot combine of every expert's output over every token,
    one expert at a time (the same sums without the (E, T, D) buffer)."""
    moe = cfg.moe
    b, s, d = x.shape
    e_pad = params["gate"].shape[0]
    xl = x.reshape(-1, d)
    w, idx, probs = route(params["router"], xl, moe, e_pad)
    hot = torch.nn.functional.one_hot(idx, e_pad).float()      # (T,k,E)
    comb = (hot * w[..., None]).sum(1)                          # (T,E)
    out = torch.zeros((xl.shape[0], d), dtype=torch.float32,
                      device=x.device)
    for e in range(e_pad):
        per_e = _expert_mlp({k: params[k][e:e + 1]
                             for k in ("gate", "up", "down")},
                            xl[None], cfg.act)[0]               # (T,D)
        out += comb[:, e:e + 1] * per_e.float()
    out = out.to(xl.dtype)
    return _add_shared(params, cfg, x, out.reshape(b, s, d)), \
        load_balance_loss(probs, idx, moe.n_experts)
