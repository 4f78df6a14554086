"""zamba2-2.7b [arXiv:2411.15242]: 54 Mamba2 layers d2560 (ssm_state=64,
head 64, expand 2) + ONE shared attention+MLP block (32H MHA head 80, d_ff
10240) invoked every 6 mamba layers with per-invocation KV caches.  Hybrid
with constant mamba state => runs long_500k."""
from repro_torch.configs.base import (ArchSpec, LM_SHAPES, ModelConfig,
                                      SSMConfig, register)

CONFIG = ModelConfig(
    name="zamba2-2.7b", family="hybrid",
    n_layers=54, d_model=2560, n_heads=32, n_kv_heads=32, d_head=80,
    d_ff=10_240, vocab_size=32_000, shared_attn_every=6,
    ssm=SSMConfig(d_state=64, d_conv=4, expand=2, head_dim=64, chunk=128),
    train_accum=4,  # the reference's training setting; the port serves only
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="zamba2-2.7b-smoke", family="hybrid",
        n_layers=4, d_model=64, n_heads=4, n_kv_heads=4, d_head=16,
        d_ff=128, vocab_size=512, shared_attn_every=2,
        ssm=SSMConfig(d_state=16, d_conv=4, expand=2, head_dim=16, chunk=8),
        dtype="float32", remat="none",
    )


register(ArchSpec(config=CONFIG, smoke=smoke, shapes=LM_SHAPES, skips={}))
