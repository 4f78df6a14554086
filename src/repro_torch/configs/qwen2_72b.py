"""qwen2-72b [arXiv:2407.10671]: 80L d8192 64H(kv8) d_ff 29568, vocab 152064,
GQA with QKV bias."""
from repro_torch.configs.base import ArchSpec, LM_SHAPES, ModelConfig, register

CONFIG = ModelConfig(
    name="qwen2-72b", family="dense",
    n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8,
    d_ff=29_568, vocab_size=152_064, qkv_bias=True,
    rope_theta=1_000_000.0,
    train_accum=4,  # the reference's training setting; the port serves only
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="qwen2-72b-smoke", family="dense",
        n_layers=4, d_model=64, n_heads=8, n_kv_heads=2,
        d_ff=192, vocab_size=512, qkv_bias=True,
        dtype="float32", remat="none",
    )


register(ArchSpec(
    config=CONFIG, smoke=smoke, shapes=LM_SHAPES,
    skips={"long_500k": "full attention; sub-quadratic-only cell "
                        "(and 172 GB of KV at batch 1)"},
))
