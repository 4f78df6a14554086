"""rwkv6-1.6b "Finch" [arXiv:2404.05892]: 24L d2048 attention-free with
data-dependent decay (head size 64 -> 32 heads), channel-mix d_ff 7168,
vocab 65536.  Constant-size recurrent state => runs ALL four shape cells
including long_500k."""
from repro_torch.configs.base import ArchSpec, LM_SHAPES, ModelConfig, register

CONFIG = ModelConfig(
    name="rwkv6-1.6b", family="ssm",
    n_layers=24, d_model=2048, n_heads=32, n_kv_heads=32,
    d_ff=7168, vocab_size=65_536,
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="rwkv6-1.6b-smoke", family="ssm",
        n_layers=2, d_model=128, n_heads=2, n_kv_heads=2,
        d_ff=256, vocab_size=512,
        dtype="float32", remat="none",
    )


register(ArchSpec(config=CONFIG, smoke=smoke, shapes=LM_SHAPES, skips={}))
