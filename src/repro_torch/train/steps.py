"""Arch-agnostic train / prefill / serve step builders (the port of
``repro/train/steps.py``):

  train_step  : fwd + loss + bwd + clip + AdamW, with gradient accumulation
  prefill_step: no-grad forward over the prompt, last position's logits
  serve_step  : one greedy decode step against a cache / recurrent state

Under an ambient mesh (``sharding/partition.py::axis_rules``) the train
step is data- and tensor-parallel: each data member takes its slice of the
batch, the model runs tensor-parallel over the model axis, the gradients
are all-reduced over the data axis and divided by its size (the GSPMD sum
of the reference's mean loss), and the clipping norm counts each cut leaf's
blocks once across the model axis.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.configs.base import ModelConfig
from repro_torch.models import api
from repro_torch.sharding import partition
from repro_torch.train import optimizer as opt


def make_train_step(cfg: ModelConfig, *, peak_lr: float = 3e-4,
                    grad_clip: float = 1.0, total_steps: int = 10_000,
                    accum_steps: int = 1, attn_impl: str = "auto",
                    wkv_impl: str = "auto"):
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
    ``api.forward``."""
    if accum_steps < 1:
        raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")

    def loss_fn(params, batch):
        logits, aux = api.forward(params, cfg, batch, remat=True,
                                  attn_impl=attn_impl, wkv_impl=wkv_impl)
        return api.loss(cfg, logits, batch["labels"], aux)

    def members(batch):
        """(this data member's batch, data group, data size, the leaves'
        cut flags, model group) under the ambient mesh."""
        mesh = partition.current_mesh()
        if mesh is None:
            return batch, None, 1, None, None
        nd = mesh.shape["data"]
        if nd > 1:
            n = batch["tokens"].shape[0]
            if n % nd:
                raise ValueError(f"batch {n} does not split over {nd} data "
                                 "members")
            lo = mesh.index("data") * (n // nd)
            batch = {k: v[lo:lo + n // nd] for k, v in batch.items()}
        cut = None
        if mesh.shape["model"] > 1:
            cut = opt.leaves(partition.cut_flags(api.param_layout(cfg)))
        return batch, mesh.group("data"), nd, cut, mesh.group("model")

    def train_step(params, opt_state, batch):
        batch, data_group, nd, cut, model_group = members(batch)
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
            if data_group is not None:
                loss = loss.reshape(1)
                for t in [loss] + grads:
                    dist.all_reduce(t, group=data_group)
                    t.mul_(1.0 / nd)
                loss = loss[0]
            grads, grad_norm = opt.clip_by_global_norm(
                grads, grad_clip, cut=cut, group=model_group)
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
