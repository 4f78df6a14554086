"""DLRM config and the arch registry (the port's own copy of
``repro/configs/base.py``, DLRM part only).

The fields keep the reference's names, defaults and meanings, so a config
built here describes the same model as its reference twin.  Options the
port does not implement yet are still carried (the port's entry points
raise ``NotImplementedError`` when one is set, naming the ROADMAP item).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Callable, Sequence


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


# DLRM shapes (the paper's own experiments: batch 512, 26 tables, s=64)
DLRM_INFER = ShapeConfig("dlrm_infer", "decode", 1, 512 * 256)
DLRM_TRAIN = ShapeConfig("dlrm_train", "train", 1, 512 * 256)


_REGISTRY: dict[str, "ArchSpec"] = {}


@dataclass(frozen=True)
class ArchSpec:
    config: DLRMConfig
    smoke: Callable[[], DLRMConfig]
    shapes: Sequence[ShapeConfig] = ()
    skips: dict = field(default_factory=dict)


def register(spec: ArchSpec) -> ArchSpec:
    _REGISTRY[spec.config.name] = spec
    return spec


def get_arch(name: str) -> ArchSpec:
    _ensure_loaded()
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def _ensure_loaded() -> None:
    # importing the config module populates the registry
    from repro_torch.configs import dlrm_kaggle  # noqa: F401
