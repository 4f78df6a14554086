"""qwen2-moe-a2.7b [hf:Qwen/Qwen1.5-MoE-A2.7B]: 24L d2048 16H(kv16) moe 60e
top-4 + 4 shared experts (d_expert=1408, shared = 4x1408), vocab 151936."""
from repro_torch.configs.base import (ArchSpec, LM_SHAPES, ModelConfig,
                                      MoEConfig, register)

CONFIG = ModelConfig(
    name="qwen2-moe-a2.7b", family="moe",
    n_layers=24, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=1408, vocab_size=151_936, qkv_bias=True, rope_theta=1_000_000.0,
    moe=MoEConfig(n_experts=60, experts_per_token=4, d_expert=1408,
                  n_shared_experts=4, d_shared_expert=1408),
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="qwen2-moe-a2.7b-smoke", family="moe",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=128, vocab_size=512, qkv_bias=True,
        moe=MoEConfig(n_experts=6, experts_per_token=2, d_expert=32,
                      n_shared_experts=2, d_shared_expert=32,
                      capacity_factor=2.0),
        dtype="float32", remat="none",
    )


register(ArchSpec(
    config=CONFIG, smoke=smoke, shapes=LM_SHAPES,
    skips={"long_500k": "full attention at 500k context is quadratic at "
                        "prefill; assignment marks this cell sub-quadratic-"
                        "only (DESIGN.md §5)"},
))
