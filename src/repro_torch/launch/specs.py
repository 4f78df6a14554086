"""Dry-run cell construction (the port of ``repro/launch/specs.py``): per
(arch × shape × mesh) the step function, stand-ins for its arguments
(meta tensors: shape and type, no storage, nothing allocated) and their
layouts.

Sharding policy (DESIGN.md §6), resolved dynamically per arch
(:func:`arch_rules`, copied word for word):
  * weights: TP over ``model`` on flat head/mlp/vocab/expert dims whenever the
    dim divides the axis; FSDP over ``data`` on the d_model dim for training.
  * activations: batch over (pod, data); head-count dims over ``model`` only
    when the *count* divides the axis (else replicated KV/Q heads — the
    standard TP16-with-kv8 fallback).
  * KV caches: sequence-sharded over ``model`` (decode_32k) or
    (data, model) (long_500k, batch=1).
  * whisper-tiny: pure DP (37M params; TP over a 16-way axis would shard
    6-head attention unevenly for zero benefit).

The port reads these rules for the ``model`` and ``data`` axes of the
parameters (``models/api.py::param_layout``); activations are not
sequence-parallel (``res_seq`` and ``kv_seq`` are ROADMAP A14f-5).  On
``model`` they cut every family but whisper: the transformer families
(dense, MoE, VLM), rwkv6's time mix (heads) and channel mix ("mlp"), and
zamba2's Mamba-2 heads (its fused ``in_proj`` and conv segment by segment)
and shared block; whisper's model rules are all None.  Under the train
rules every family, whisper included, is fully sharded over ``data`` on
its d_model ("embed") dimension, as the reference's (``sharding/fsdp.py``
gathers the blocks where the forward uses them).

Where the cells differ from the reference's:
  * A stand-in is a meta tensor (:func:`sds`), the counterpart of
    ``jax.ShapeDtypeStruct``.  :func:`param_shapes` runs the port's own
    ``init`` on the meta device, which draws nothing, so each family's
    layout has one source.
  * The reference jits a step over global arrays and lets GSPMD cut them
    by ``NamedSharding``s.  The port runs one process a member, so a
    :class:`Cell` holds each argument as this member holds it: its block
    of every parameter and optimizer leaf under the port's layout
    (``api.param_layout``), its rows of a serving batch, and the cache
    ``api.make_cache`` builds for its rows and heads.  A train cell holds
    its rows of the batch too: the train step takes a batch of its
    block's rows as this member's (``train/steps.py``).  Each cell keeps
    the layouts beside (:class:`partition.Layout` in place of
    ``NamedSharding``).
  * A DLRM cell holds this member's tables (and, training, their AdamW
    state): the port's ``forward_distributed`` takes the member's shard,
    where the reference's ``shard_map`` cuts a replicated stack.  The
    train cell's gradient is the function's: the reference's table
    gradient through its uint8 wire is zero (ROADMAP C2).
  * ``Cell.lower`` becomes :meth:`Cell.trace` (nothing is lowered in
    torch), and the reference's donated arguments are the port's in-place
    updates (``Cell.in_place``).
"""
from __future__ import annotations

import contextlib
from typing import Optional, Union

import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.configs import base as cb
from repro_torch.configs.base import DLRMConfig, ShapeConfig
from repro_torch.models import api
from repro_torch.models import dlrm as dlrm_mod
from repro_torch.sharding import partition
from repro_torch.train import optimizer as opt_mod
from repro_torch.train import steps as steps_mod

F32, BF16, I32 = torch.float32, torch.bfloat16, torch.int32

# Decoder lengths for the enc-dec (whisper) cells: the assigned seq_len is
# the ACOUSTIC length; targets use whisper's own max_target_positions.
WHISPER_DEC_TRAIN = 448
WHISPER_DEC_PREFILL = 256
WHISPER_ENC_DECODE = 1536  # ~whisper's 1500-frame cap, padded to shard 16-way


def sds(shape, dtype):
    """A stand-in: a meta tensor of ``shape`` and ``dtype``."""
    return torch.empty(shape, dtype=dtype, device="meta")


# ---------------------------------------------------------------------------
# rules
# ---------------------------------------------------------------------------


def arch_rules(cfg, mesh, shape: ShapeConfig) -> dict:
    rules: dict = {}
    md = mesh.shape["model"]
    if isinstance(cfg, DLRMConfig):
        return rules  # DLRM shards via explicit shard_map specs
    h, kh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    if cfg.name.startswith("whisper"):
        for r in ("heads", "kv_heads", "mlp", "vocab", "experts",
                  "emb_vocab", "emb_col"):
            rules[r] = None
    else:
        g = h // kh
        rules["heads"] = "model" if (h * hd) % md == 0 else None
        rules["kv_heads"] = "model" if (kh * hd) % md == 0 else None
        rules["act_heads"] = "model" if h % md == 0 else None
        # score-tensor sharding: exactly one of kv / group / q-chunk axes
        rules["act_kv"] = "model" if kh % md == 0 else None
        rules["act_groups"] = "model" if (kh % md and g % md == 0) else None
        rules["act_qchunk"] = "model" if (kh % md and g % md) else None
        rules["mlp"] = "model" if cfg.d_ff % md == 0 else None
        rules["vocab"] = "model" if cfg.vocab_size % md == 0 else None
        rules["emb_vocab"] = rules["vocab"]
    # NOTE (§Perf iter 4): column-sharding the embedding table in training
    # (emb_vocab=None, emb_col=model) makes the token gather shard-local, but
    # the measured win was ~0.1 s of 55 s AND the combination with sharded
    # token inputs trips a GSPMD partitioner bug (dynamic-slice 8192 from a
    # 512 operand after spmd-partitioning) — reverted to row sharding.
    if shape.kind == "train":
        # FSDP: d_model dims of weights over data (dedup keeps activations
        # batch-major since "batch" claims the data axis first)
        nd = mesh.shape.get("data", 1)
        rules["embed"] = "data" if cfg.d_model % nd == 0 else None
        # sequence parallelism on the residual stream: the per-layer carry
        # stack saved for backward shrinks by the model axis
        if cfg.family in ("dense", "moe", "vlm") and \
                shape.seq_len % md == 0:
            rules["res_seq"] = "model"
    if shape.kind == "decode":
        if shape.global_batch == 1:
            rules["batch"] = None
            rules["kv_seq"] = ("data", "model")
        else:
            rules["kv_seq"] = "model"
    if shape.kind == "prefill":
        rules["kv_seq"] = "model"
    return rules


# ---------------------------------------------------------------------------
# batch input specs
# ---------------------------------------------------------------------------


def input_specs(cfg, shape: ShapeConfig) -> dict:
    """Stand-ins for every model input of this cell (the global batch)."""
    b, s = shape.global_batch, shape.seq_len
    if isinstance(cfg, DLRMConfig):
        t_pad = dlrm_mod.padded_tables(cfg, 16)
        return {
            "dense": sds((b, cfg.n_dense_features), F32),
            "idx": sds((b, t_pad, 1), I32),
            "mask": sds((b, t_pad, 1), F32),
            **({"labels": sds((b,), F32)} if shape.kind == "train" else {}),
        }
    out: dict = {}
    if cfg.family == "audio":
        sd = WHISPER_DEC_TRAIN if shape.kind == "train" else \
            WHISPER_DEC_PREFILL
        if shape.kind == "decode":
            out["tokens"] = sds((b, 1), I32)
        else:
            out["frames"] = sds((b, s, cfg.d_frontend), F32)
            out["tokens"] = sds((b, sd), I32)
            if shape.kind == "train":
                out["labels"] = sds((b, sd), I32)
        return out
    if cfg.frontend == "vision_patches" and shape.kind != "decode":
        nf = cfg.n_frontend_tokens
        out["patches"] = sds((b, nf, cfg.d_frontend), F32)
        out["tokens"] = sds((b, s - nf), I32)
        if shape.kind == "train":
            out["labels"] = sds((b, s), I32)
        return out
    out["tokens"] = sds((b, 1 if shape.kind == "decode" else s), I32)
    if shape.kind == "train":
        out["labels"] = sds((b, s), I32)
    return out


def _batch_shardings(cfg, shape: ShapeConfig, batch_tree, mesh,
                     rules) -> partition.Layout:
    def axes_for(name, leaf):
        if name in ("tokens", "labels"):
            return ("batch", "seq")[:leaf.ndim] if leaf.ndim == 2 else \
                ("batch",)
        if name == "frames":
            return ("batch", "seq", None)
        if name == "patches":
            return ("batch", None, None)
        if name in ("dense",):
            return ("batch", None)
        if name in ("idx", "mask"):
            return ("batch", "table_shard", None)
        return tuple([None] * leaf.ndim)

    return partition.Layout(mesh, {
        k: partition.spec(*axes_for(k, v), mesh=mesh, rules=rules)
        for k, v in batch_tree.items()})


# ---------------------------------------------------------------------------
# param / state shapes (meta tensors only — nothing is allocated)
# ---------------------------------------------------------------------------


def param_shapes(cfg, n_shards: int = 16, dtype: Optional[torch.dtype] = None):
    """Stand-ins for ``init``'s tree (the f32 masters; a DLRM's leaves in
    its own type).  With ``dtype`` every f32 leaf takes that type, the MoE
    routers included, as the reference's does."""
    if isinstance(cfg, DLRMConfig):
        shapes = dlrm_mod.init_dlrm(0, cfg, n_shards=n_shards, device="meta")
    else:
        shapes = api.init(0, cfg, device="meta", n_shards=n_shards,
                          dtype="float32")
    if dtype is not None:
        shapes = opt_mod._like(
            shapes, lambda a: sds(a.shape, dtype) if a.dtype == F32 else a)
    return shapes


def param_spec_tree(cfg):
    if isinstance(cfg, DLRMConfig):
        return dlrm_mod.dlrm_specs(cfg)
    return api.specs(cfg)


def tree_shardings(spec_tree, mesh, rules) -> partition.Layout:
    """Every leaf's logical axes resolved against ``mesh`` under ``rules``
    (the reference's layout, which the port narrows for parameters)."""
    return partition.tree_layout(spec_tree, mesh, rules)


def nbytes(tree) -> int:
    """The bytes of a tree's tensors (stand-ins or not)."""
    return sum(t.numel() * t.element_size() for t in opt_mod.leaves(tree)
               if isinstance(t, torch.Tensor))


# ---------------------------------------------------------------------------
# cells
# ---------------------------------------------------------------------------


def _fake_like(x):
    """A fake tensor like the stand-in ``x`` (inside a ``FakeTensorMode``);
    anything that is not a tensor as it is."""
    if isinstance(x, torch.Tensor):
        return torch.empty(x.shape, dtype=x.dtype, device="cpu")
    return x


def _stand_in(x):
    return sds(x.shape, x.dtype) if isinstance(x, torch.Tensor) else x


class Cell:
    """One (arch × shape) dry-run program, ready to trace under a mesh.

    ``args`` are stand-ins of the step's arguments as this member holds
    them (see the module docstring), ``layouts`` the layout of each (None
    for a cache, which ``api.make_cache`` builds per member), and
    ``ref_params`` the stand-ins of this member's parameter blocks under
    the reference's rules (``tree_shardings``), which the dry run compares
    with the port's.  ``in_place`` names the arguments the step updates in
    place, where the reference donates them."""

    def __init__(self, arch: str, shape: ShapeConfig, fn, args, layouts,
                 rules, static_cfg, in_place=(), ref_params=None):
        self.arch, self.shape = arch, shape
        self.fn, self.args, self.layouts = fn, args, layouts
        self.rules, self.cfg = rules, static_cfg
        self.in_place = in_place
        self.ref_params = ref_params
        self.name = f"{arch}/{shape.name}"

    def trace(self, mesh, *modes):
        """Run ``fn`` once on fake tensors like this member's ``args``
        under ``partition.axis_rules(mesh, rules)`` and a
        ``FakeTensorMode`` -> the outputs' stand-ins.  ``modes`` (dispatch
        modes: the dry run's counters) are entered inside the fake mode,
        around ``fn``; one with ``track_external`` (a memory tracker) is
        first given the arguments, so that it counts them as held before
        the step, views of them included.  The reference's ``lower``
        compiles against placeholder devices; torch compiles nothing, so
        the port traces: every op runs on the CPU's fake tensors (the
        kernels' plain versions: a CUDA kernel is a ``ctypes`` call that
        takes no fake tensor), and the process group is the caller's (the
        fake backend in the dry run)."""
        with FakeTensorMode(allow_non_fake_inputs=True), \
                partition.axis_rules(mesh, self.rules), \
                contextlib.ExitStack() as stack:
            args = opt_mod._like(self.args, _fake_like)
            held = [t for t in opt_mod.leaves(args)
                    if isinstance(t, torch.Tensor)]
            for m in modes:
                if hasattr(m, "track_external"):
                    m.track_external(*held)
                stack.enter_context(m)
            out = self.fn(*args)
        return opt_mod._like(out, _stand_in)


def build_cell(arch_name: str, shape_name: Union[str, ShapeConfig], mesh,
               overrides: Optional[dict] = None) -> Cell:
    """The cell of ``arch_name`` at the shape named ``shape_name`` (or a
    ``ShapeConfig`` given whole: a cell cut to a smaller batch) for this
    member of ``mesh``."""
    spec = cb.get_arch(arch_name)
    cfg = spec.config
    shape = shape_name if isinstance(shape_name, ShapeConfig) else \
        next(s for s in spec.shapes if s.name == shape_name)
    rules = arch_rules(cfg, mesh, shape)
    if overrides:
        rules.update(overrides)
    batch = input_specs(cfg, shape)
    bshard = _batch_shardings(cfg, shape, batch, mesh, rules)
    pspec = param_spec_tree(cfg)

    if isinstance(cfg, DLRMConfig):
        return _build_dlrm_cell(arch_name, cfg, shape, batch, bshard, pspec,
                                mesh, rules)

    if shape.kind == "train":
        params = param_shapes(cfg)
        opt_state = opt_mod.adamw_init(params)
        # the step takes this member's rows of the global batch
        step = steps_mod.make_train_step(cfg, accum_steps=cfg.train_accum,
                                         global_batch=shape.global_batch)
        pshard = api.param_layout(cfg, mesh, rules)
        oshard = opt_mod.adamw_layout(pshard)
        ref = partition.shard_tree(params,
                                   tree_shardings(pspec, mesh, rules))
        return Cell(arch_name, shape, step,
                    (partition.shard_tree(params, pshard),
                     partition.shard_tree(opt_state, oshard),
                     partition.shard_tree(batch, bshard)),
                    (pshard, oshard, bshard), rules, cfg,
                    in_place=(0, 1), ref_params=ref)

    serve_cfg = cfg
    params = param_shapes(cfg, dtype=BF16)
    pshard = api.param_layout(cfg, mesh, rules)
    ref = partition.shard_tree(params, tree_shardings(pspec, mesh, rules))
    pblocks = partition.shard_tree(params, pshard)
    local = partition.shard_tree(batch, bshard)
    if shape.kind == "prefill":
        step = steps_mod.make_prefill_step(serve_cfg)
        return Cell(arch_name, shape, step, (pblocks, local),
                    (pshard, bshard), rules, cfg, ref_params=ref)

    # decode: the cache of this member's rows and heads
    with partition.axis_rules(mesh, rules):
        cache = api.make_cache(serve_cfg, local["tokens"].shape[0],
                               shape.seq_len, dtype="bfloat16",
                               device="meta")
    step = steps_mod.make_serve_step(serve_cfg)
    tshard = partition.Layout(mesh, bshard.specs["tokens"])
    return Cell(arch_name, shape, step, (pblocks, local["tokens"], cache),
                (pshard, tshard, None), rules, cfg, in_place=(2,),
                ref_params=ref)


def _build_dlrm_cell(arch_name, cfg, shape, batch, bshard, pspec, mesh,
                     rules, *, bound: int = 4, microbatches: int = 16):
    params = param_shapes(cfg, dtype=F32)
    ref = partition.shard_tree(params, tree_shardings(pspec, mesh, rules))
    # forward_distributed takes this member's tables: the model axis cuts
    # the stack as the reference's shard_map does
    pshard = tree_shardings(pspec, mesh, {**rules, "table_shard": "model"})
    group = mesh.group("model")
    local = partition.shard_tree(batch, bshard)
    if shape.kind == "train":
        data_groups, _ = steps_mod.data_members(mesh)

        def train_fn(p, opt_state, b):
            # the reference's value_and_grad of bce_loss over the
            # unpipelined forward, the cosine schedule and AdamW, in place
            loss, grads = dlrm_mod.loss_and_grads(
                p, cfg, b, bound=0, microbatches=1, group=group,
                data_groups=data_groups)
            lr = opt_mod.cosine_schedule(opt_state["count"])
            p, opt_state = opt_mod.adamw_update(grads, opt_state, p, lr)
            return p, opt_state, {"loss": loss}

        oshard = opt_mod.adamw_layout(pshard)
        return Cell(arch_name, shape, train_fn,
                    (partition.shard_tree(params, pshard),
                     partition.shard_tree(opt_mod.adamw_init(params),
                                          oshard), local),
                    (pshard, oshard, bshard), rules, cfg, in_place=(0, 1),
                    ref_params=ref)

    @torch.no_grad()
    def serve_fn(p, b):
        # the BLS-enabled inference step (paper Listing 2): bound k over a
        # microbatch stream, drained in-program
        logits = dlrm_mod.forward_distributed(
            p, cfg, b["dense"], b["idx"], b["mask"],
            bound=bound, microbatches=microbatches, restore_order=False,
            group=group)
        return torch.sigmoid(logits)

    return Cell(arch_name, shape, serve_fn,
                (partition.shard_tree(params, pshard), local),
                (pshard, bshard), rules, cfg, ref_params=ref)


def cells_for(arch_name: str):
    """(shape, skip_reason|None) for every assigned shape of an arch."""
    spec = cb.get_arch(arch_name)
    return [(s, spec.skips.get(s.name)) for s in spec.shapes]
