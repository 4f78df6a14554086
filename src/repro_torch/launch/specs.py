"""Per-arch logical-axis rules (the port of ``arch_rules`` in
``repro/launch/specs.py``, copied word for word).

Sharding policy, resolved per arch:
  * weights: TP over ``model`` on flat head/mlp/vocab/expert dims whenever the
    dim divides the axis; FSDP over ``data`` on the d_model dim for training.
  * activations: batch over (pod, data); head-count dims over ``model`` only
    when the *count* divides the axis (else replicated KV/Q heads — the
    standard TP16-with-kv8 fallback).
  * KV caches: sequence-sharded over ``model`` (decode_32k) or
    (data, model) (long_500k, batch=1).
  * whisper-tiny: pure DP (37M params; TP over a 16-way axis would shard
    6-head attention unevenly for zero benefit).

The port reads these rules for the ``model`` axis only: parameters are
whole on every data member (no FSDP) and activations are not
sequence-parallel; see ``models/api.py::param_layout``.  They cut every
family but whisper: the transformer families (dense, MoE, VLM), rwkv6's
time mix (heads) and channel mix ("mlp"), and zamba2's Mamba-2 heads
(its fused ``in_proj`` and conv segment by segment) and shared block;
whisper's rules are all None, so it runs data-parallel (replicated on a
model axis).  The rest of the reference's module (the dry-run cells:
input specs, batch and state shardings, step lowering) is the launch
tooling, ROADMAP A14f.
"""
from __future__ import annotations

from repro_torch.configs.base import DLRMConfig, ShapeConfig


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
