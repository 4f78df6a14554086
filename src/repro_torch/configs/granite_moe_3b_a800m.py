"""granite-moe-3b-a800m [hf:ibm-granite family]: 32L d1536 24H(kv8) moe 40e
top-8 (the assignment's structured field; the hf 1b card is 32e — see
DESIGN.md), d_expert=512, vocab 49155, tied embeddings."""
from repro_torch.configs.base import (ArchSpec, LM_SHAPES, ModelConfig,
                                      MoEConfig, register)

CONFIG = ModelConfig(
    name="granite-moe-3b-a800m", family="moe",
    n_layers=32, d_model=1536, n_heads=24, n_kv_heads=8,
    d_ff=512, vocab_size=49_155, tie_embeddings=True,
    moe=MoEConfig(n_experts=40, experts_per_token=8, d_expert=512),
    train_accum=2,
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="granite-moe-3b-a800m-smoke", family="moe",
        n_layers=2, d_model=48, n_heads=6, n_kv_heads=2,
        d_ff=64, vocab_size=512, tie_embeddings=True,
        moe=MoEConfig(n_experts=5, experts_per_token=2, d_expert=16,
                      capacity_factor=2.0),
        dtype="float32", remat="none",
    )


register(ArchSpec(
    config=CONFIG, smoke=smoke, shapes=LM_SHAPES,
    skips={"long_500k": "full attention; sub-quadratic-only cell"},
))
