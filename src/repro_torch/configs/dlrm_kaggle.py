"""DLRM on Criteo-Kaggle shapes — the paper's own model and dataset regime
(26 tables, s=64, bottom 512-256-64, top 512-256-1, batch 512/process).
``dlrm-alicpp`` mirrors the paper's converted Ali-CCP dataset (23 tables)."""
from repro_torch.configs.base import (ArchSpec, DLRM_INFER, DLRM_TRAIN,
                                      DLRMConfig, register)
from repro_torch.data.synthetic import (ALI_CCP_TABLE_SIZES,
                                        CRITEO_KAGGLE_TABLE_SIZES)

CONFIG = DLRMConfig(
    name="dlrm-kaggle",
    table_sizes=CRITEO_KAGGLE_TABLE_SIZES,
    embed_dim=64,
    bottom_mlp=(512, 256, 64),
    top_mlp=(512, 256, 1),
    max_hot=100,  # paper Setting 1 heterogeneity ceiling
)

ALICPP = DLRMConfig(
    name="dlrm-alicpp",
    table_sizes=ALI_CCP_TABLE_SIZES,
    embed_dim=64,
    bottom_mlp=(512, 256, 64),
    top_mlp=(512, 256, 1),
    max_hot=1,  # NVTabular averages multi-hot to 1 (paper §V-F)
)


def smoke() -> DLRMConfig:
    return DLRMConfig(
        name="dlrm-kaggle-smoke",
        table_sizes=(100, 50, 80, 60, 90, 40, 70, 30),
        embed_dim=16,
        bottom_mlp=(32, 16),
        top_mlp=(32, 1),
        max_hot=4,
    )


def smoke_alicpp() -> DLRMConfig:
    return DLRMConfig(
        name="dlrm-alicpp-smoke",
        table_sizes=(64, 32, 48, 40, 56, 24, 16),
        embed_dim=16,
        bottom_mlp=(32, 16),
        top_mlp=(32, 1),
        max_hot=1,
    )


register(ArchSpec(config=CONFIG, smoke=smoke,
                  shapes=(DLRM_INFER, DLRM_TRAIN), skips={}))
register(ArchSpec(config=ALICPP, smoke=smoke_alicpp,
                  shapes=(DLRM_INFER, DLRM_TRAIN), skips={}))
