"""Arch-agnostic train / prefill / serve step builders (the port of
``repro/train/steps.py``):

  train_step  : fwd + loss + bwd + clip + AdamW, with gradient accumulation
  prefill_step: no-grad forward over the prompt, last position's logits
  serve_step  : one greedy decode step against a cache / recurrent state

Under an ambient mesh (``sharding/partition.py::axis_rules``) the train
step is data- and tensor-parallel: each data member takes its slice of the
batch (over ``data``, and ``pod`` on the multi-pod grid: the "batch"
rule's axes), or is given only its rows, the model runs tensor-parallel
over the model axis and fully sharded over ``data`` where the train rules
put "embed" there (``sharding/fsdp.py``), the gradients are all-reduced
over the batch's axes (a data-cut leaf's already summed over ``data`` by
its gather's backward) and divided by their size (the GSPMD sum of the
reference's mean loss), and the clipping norm counts each cut leaf's
blocks once across the model axis and the data axis.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from repro_torch.configs.base import ModelConfig
from repro_torch.models import api
from repro_torch.sharding import fsdp, partition
from repro_torch.train import optimizer as opt


def data_members(mesh) -> tuple[list, int]:
    """(the process groups of the mesh axes that the "batch" rule names,
    their number of members): the axes over which a train step's batch
    is cut and its gradient averaged (``data``, and ``pod`` too on the
    multi-pod grid); ([], 1) without a mesh."""
    if mesh is None:
        return [], 1
    entry = partition.spec("batch", mesh=mesh)[0]
    nd, _ = partition.block(mesh, entry)
    groups = [g for g in map(mesh.group, partition._axes(entry))
              if g is not None]
    return groups, nd


def make_train_step(cfg: ModelConfig, *, peak_lr: float = 3e-4,
                    grad_clip: float = 1.0, total_steps: int = 10_000,
                    accum_steps: int = 1, attn_impl: str = "auto",
                    wkv_impl: str = "auto",
                    global_batch: Optional[int] = None):
    """(params, opt_state, batch) -> (params, opt_state, metrics {"loss",
    "grad_norm", "lr"}, f32 0-d tensors).  The forward runs with
    ``remat=True`` (``cfg.remat``), the loss is ``api.loss``.  With
    ``accum_steps`` > 1 the batch is split into that many microbatches of
    consecutive rows, as the reference's reshape does: each one's backward
    adds into the leaves' ``.grad`` in place (the reference's second f32
    tree is not kept), and the summed loss and gradients are scaled by
    1 / accum_steps, the reference's mean.  Parameters (f32 masters from
    ``api.init(..., dtype="float32")``) and the optimizer state are
    updated in place and returned; ``attn_impl`` and ``wkv_impl`` as in
    ``api.forward``.

    Under a mesh the batch is the whole one, whose rows the step cuts, or
    this member's rows: a batch of ``global_batch`` divided by the data
    members' rows (the "batch" rule's block, as
    ``launch/multihost.py::form_global_array`` forms it) is taken as
    this member's.  Leaves that the layout cuts over ``data`` (FSDP,
    ``sharding/fsdp.py``) come back from the backward already summed over
    the data members and skip the data all-reduce; they take the same
    mean."""
    if accum_steps < 1:
        raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")

    def loss_fn(params, batch):
        logits, aux = api.forward(params, cfg, batch, remat=True,
                                  attn_impl=attn_impl, wkv_impl=wkv_impl)
        return api.loss(cfg, logits, batch["labels"], aux)

    def members(batch):
        """(this data member's batch, the groups of the batch's mesh axes,
        their members, the leaves' model cut flags, model group, the
        leaves' data cut flags, the FSDP group) under the ambient mesh."""
        mesh = partition.current_mesh()
        if mesh is None:
            return batch, [], 1, None, None, None, None
        groups, nd = data_members(mesh)
        entry = partition.spec("batch", mesh=mesh)[0]
        _, i = partition.block(mesh, entry)
        n = batch["tokens"].shape[0]
        own = global_batch is not None and nd > 1 and n * nd == global_batch
        if global_batch is not None and not own and n != global_batch:
            raise ValueError(f"batch {n} is neither the global batch "
                             f"{global_batch} nor this member's "
                             f"{global_batch // nd} rows")
        if nd > 1 and not own:
            if n % nd:
                raise ValueError(f"batch {n} does not split over {nd} data "
                                 "members")
            lo = i * (n // nd)
            batch = {k: v[lo:lo + n // nd] for k, v in batch.items()}
        layout = api.param_layout(cfg)
        cut = None
        if mesh.shape["model"] > 1:
            cut = opt.leaves(partition.cut_flags(layout))
        fg = fsdp.group()
        dcut = None if fg is None else opt.leaves(partition.map_specs(
            lambda _, s: fsdp.data_dim(s) is not None, layout.specs))
        return batch, groups, nd, cut, mesh.group("model"), dcut, fg

    def train_step(params, opt_state, batch):
        batch, data_groups, nd, cut, model_group, dcut, fg = members(batch)
        n = batch["tokens"].shape[0]
        if n % accum_steps:
            raise ValueError(f"batch {n} does not split into {accum_steps} "
                             f"microbatches")
        mb = n // accum_steps
        flat = opt.leaves(params)
        for p in flat:
            p.grad = None
            p.requires_grad_(True)
        try:
            loss = None
            for i in range(accum_steps):
                part = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
                micro = loss_fn(params, part)
                micro.backward()
                micro = micro.detach()
                loss = micro if loss is None else loss + micro
            grads = [torch.zeros_like(p) if p.grad is None else p.grad
                     for p in flat]
        finally:
            for p in flat:
                p.requires_grad_(False)
                p.grad = None
        with torch.no_grad():
            if accum_steps > 1:
                inv = 1.0 / accum_steps
                loss = loss * inv
                for g in grads:
                    g.mul_(inv)
            if data_groups:
                loss = loss.reshape(1)
                summed = [False] + (dcut or [False] * len(grads))
                for t, done in zip([loss] + grads, summed):
                    for g in data_groups:
                        # the FSDP gather's reduce-scatter summed it
                        if not (done and g is fg):
                            dist.all_reduce(t, group=g)
                    t.mul_(1.0 / nd)
                loss = loss[0]
            grads, grad_norm = opt.clip_by_global_norm(
                grads, grad_clip, cut=cut, group=model_group,
                data_cut=dcut, data_group=fg)
            lr = opt.cosine_schedule(opt_state["count"], peak_lr=peak_lr,
                                     total=total_steps)
            params, opt_state = opt.adamw_update(grads, opt_state, params,
                                                 lr)
        del grads
        return params, opt_state, {"loss": loss, "grad_norm": grad_norm,
                                   "lr": lr}

    return train_step


def make_prefill_step(cfg: ModelConfig):
    def prefill_step(params, batch):
        with torch.no_grad():
            logits, _ = api.forward(params, cfg, batch, remat=False,
                                    last_only=True)
        return logits

    return prefill_step


def make_serve_step(cfg: ModelConfig):
    """(params, tokens (B,1), cache) -> (next tokens (B,1) int32, cache):
    greedy, the first index of the largest logit, as ``jnp.argmax``."""
    def serve_step(params, tokens, cache):
        with torch.no_grad():
            logits, cache = api.decode_step(params, cfg, tokens, cache)
        next_tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
        return next_tok[:, None], cache

    return serve_step
