"""chatglm3-6b [arXiv:2406.12793]: 28L d4096 32H(kv2 multi-query) d_ff 13696,
vocab 65024; partial ("2d") interleaved rotary on half the head dims, QKV
bias."""
from repro_torch.configs.base import ArchSpec, LM_SHAPES, ModelConfig, register

CONFIG = ModelConfig(
    name="chatglm3-6b", family="dense",
    n_layers=28, d_model=4096, n_heads=32, n_kv_heads=2,
    d_ff=13_696, vocab_size=65_024, qkv_bias=True,
    rope_style="glm2d", rope_fraction=0.5,
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="chatglm3-6b-smoke", family="dense",
        n_layers=3, d_model=64, n_heads=8, n_kv_heads=2,
        d_ff=128, vocab_size=512, qkv_bias=True,
        rope_style="glm2d", rope_fraction=0.5,
        dtype="float32", remat="none",
    )


register(ArchSpec(
    config=CONFIG, smoke=smoke, shapes=LM_SHAPES,
    skips={"long_500k": "full attention; sub-quadratic-only cell"},
))
