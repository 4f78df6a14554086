"""qwen3-14b [hf:Qwen/Qwen3 family]: 40L d5120 40H(kv8, head 128) d_ff 17408,
vocab 151936, per-head qk-norm, no QKV bias."""
from repro_torch.configs.base import ArchSpec, LM_SHAPES, ModelConfig, register

CONFIG = ModelConfig(
    name="qwen3-14b", family="dense",
    n_layers=40, d_model=5120, n_heads=40, n_kv_heads=8, d_head=128,
    d_ff=17_408, vocab_size=151_936, qk_norm=True,
    rope_theta=1_000_000.0,
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="qwen3-14b-smoke", family="dense",
        n_layers=3, d_model=64, n_heads=8, n_kv_heads=2, d_head=16,
        d_ff=128, vocab_size=512, qk_norm=True,
        dtype="float32", remat="none",
    )


register(ArchSpec(
    config=CONFIG, smoke=smoke, shapes=LM_SHAPES,
    skips={"long_500k": "full attention; sub-quadratic-only cell"},
))
