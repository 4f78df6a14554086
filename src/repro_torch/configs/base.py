"""Model configs, shape cells and the arch registry (the port's own copy
of ``repro/configs/base.py``).

The fields keep the reference's names, defaults and meanings, so a config
built here describes the same model as its reference twin.  Options the
port does not implement yet are still carried (the port's entry points
raise ``NotImplementedError`` when one is set, naming the ROADMAP item).
The registry holds the archs the port has configs for: the DLRM ones, the
dense LMs ``gemma2-9b``, ``qwen3-14b``, ``chatglm3-6b`` and ``qwen2-72b``,
the MoE LMs ``qwen2-moe-a2.7b`` and ``granite-moe-3b-a800m``, the VLM
``llava-next-mistral-7b``, the encoder-decoder ``whisper-tiny``,
``rwkv6-1.6b`` and the hybrid ``zamba2-2.7b``: every arch of the
reference.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Callable, Optional, Sequence


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int = 0            # routed experts
    experts_per_token: int = 0    # top-k
    d_expert: int = 0             # per-expert FFN hidden dim
    n_shared_experts: int = 0
    d_shared_expert: int = 0      # FFN hidden dim of the shared expert(s)
    capacity_factor: float = 1.25
    router_jitter: float = 0.0
    dispatch: str = "gather"      # gather | a2a


@dataclass(frozen=True)
class SSMConfig:
    d_state: int = 64
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    chunk: int = 128              # chunked-scan block length


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                   # dense | moe | ssm | hybrid | audio | vlm | recsys
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    d_head: int = 0               # 0 -> d_model // n_heads
    # --- attention flavour ---
    rope_theta: float = 10_000.0
    rope_style: str = "neox"      # neox | glm2d (partial/interleaved, chatglm)
    rope_fraction: float = 1.0    # fraction of head dims rotated (chatglm: 0.5)
    qk_norm: bool = False         # qwen3
    qkv_bias: bool = False        # qwen2 / chatglm
    attn_logit_softcap: float = 0.0   # gemma2: 50.0 (0 = off)
    final_logit_softcap: float = 0.0  # gemma2: 30.0
    sliding_window: int = 0       # gemma2 local layers: 4096 (0 = off)
    layer_pattern: str = "global"  # global | local_global (gemma2 alternation)
    post_norms: bool = False      # gemma2 sandwich norms
    norm_plus_one: bool = False   # gemma2 RMSNorm stores w, applies (1+w)
    scale_embeds: bool = False    # gemma2 multiplies embeddings by sqrt(d)
    act: str = "silu"             # silu | gelu | relu2
    tie_embeddings: bool = False
    norm_eps: float = 1e-6
    # --- MoE / SSM / hybrid ---
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    shared_attn_every: int = 0    # zamba2: shared attention block cadence
    # --- enc-dec (whisper) ---
    n_encoder_layers: int = 0     # >0 -> encoder-decoder model
    # --- modality frontend stubs ---
    frontend: str = "none"        # none | audio_frames | vision_patches
    d_frontend: int = 0           # raw stub-embedding dim before projection
    n_frontend_tokens: int = 0    # prefix positions fed from the stub
    # --- training (carried; the port serves only) ---
    remat: str = "full"           # full | none | dots
    train_accum: int = 1          # gradient-accumulation microbatches
    dtype: str = "bfloat16"

    @property
    def head_dim(self) -> int:
        return self.d_head or self.d_model // self.n_heads

    @property
    def is_encdec(self) -> bool:
        return self.n_encoder_layers > 0

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class DLRMConfig:
    """The paper's own model (Naumov et al. reference DLRM)."""

    name: str
    n_dense_features: int = 13
    table_sizes: Sequence[int] = ()
    embed_dim: int = 64                      # s in the paper
    bottom_mlp: Sequence[int] = (512, 256, 64)
    top_mlp: Sequence[int] = (512, 256, 1)
    max_hot: int = 1                 # multi-hot pooling (Setting 1: 100)
    arch_interaction_op: str = "dot"         # dot | cat
    dtype: str = "float32"
    # ref | pallas | interpret | auto; in the port 'pallas' is the CUDA
    # kernel, 'interpret' the plain version (no GPU interpreter exists) and
    # 'auto' the kernel for CUDA tensors, the plain version for CPU ones
    sparse_backend: str = "auto"
    # embedding-bag regime knob of the reference (-1 resident, 0 auto, > 0
    # streamed block height); validated, but the CUDA bag kernel reads rows
    # straight from device memory in every case
    row_block: int = 0
    pool_mode: str = "auto"         # scalar | vector | auto (validated)
    wire_dtype: str = "float32"     # exchange codec: float32 | bfloat16 | int8
    cache_rows: int = 0             # hot-row cache rows per table (0 = off)
    exchange: str = "auto"          # dense | ragged | auto
    ragged_cap: int = 0
    exchange_pipeline: str = "auto"  # mono | ring | auto

    @property
    def n_tables(self) -> int:
        return len(self.table_sizes)

    def replace(self, **kw) -> "DLRMConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    kind: str                     # train | prefill | decode
    seq_len: int
    global_batch: int


TRAIN_4K = ShapeConfig("train_4k", "train", 4_096, 256)
PREFILL_32K = ShapeConfig("prefill_32k", "prefill", 32_768, 32)
DECODE_32K = ShapeConfig("decode_32k", "decode", 32_768, 128)
LONG_500K = ShapeConfig("long_500k", "decode", 524_288, 1)

LM_SHAPES = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)

# DLRM shapes (the paper's own experiments: batch 512, 26 tables, s=64)
DLRM_INFER = ShapeConfig("dlrm_infer", "decode", 1, 512 * 256)
DLRM_TRAIN = ShapeConfig("dlrm_train", "train", 1, 512 * 256)


_REGISTRY: dict[str, "ArchSpec"] = {}


@dataclass(frozen=True)
class ArchSpec:
    config: ModelConfig | DLRMConfig
    smoke: Callable[[], ModelConfig | DLRMConfig]
    shapes: Sequence[ShapeConfig] = LM_SHAPES
    # shape names skipped + reason (e.g. long_500k on full-attention archs)
    skips: dict = field(default_factory=dict)


def register(spec: ArchSpec) -> ArchSpec:
    _REGISTRY[spec.config.name] = spec
    return spec


def get_arch(name: str) -> ArchSpec:
    _ensure_loaded()
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def list_archs() -> list[str]:
    _ensure_loaded()
    return sorted(_REGISTRY)


def _ensure_loaded() -> None:
    # importing the config modules populates the registry
    from repro_torch.configs import (  # noqa: F401
        chatglm3_6b,
        dlrm_kaggle,
        gemma2_9b,
        granite_moe_3b_a800m,
        llava_next_mistral_7b,
        qwen2_72b,
        qwen2_moe_a2_7b,
        qwen3_14b,
        rwkv6_1_6b,
        whisper_tiny,
        zamba2_2_7b,
    )
