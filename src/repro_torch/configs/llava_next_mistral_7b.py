"""llava-next-mistral-7b [hf:llava-hf/llava-v1.6-mistral-7b-hf]: mistral-7B
backbone (32L d4096 32H kv8 d_ff 14336 vocab 32000) + anyres vision frontend
STUB: input_specs feeds precomputed CLIP patch embeddings (d=1024) for the
anyres tiles (4 tiles + base = 5 x 576 = 2880 prefix positions), projected by
a linear adapter."""
from repro_torch.configs.base import ArchSpec, LM_SHAPES, ModelConfig, register

CONFIG = ModelConfig(
    name="llava-next-mistral-7b", family="vlm",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=14_336, vocab_size=32_000,
    frontend="vision_patches", d_frontend=1024, n_frontend_tokens=2880,
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="llava-next-mistral-7b-smoke", family="vlm",
        n_layers=3, d_model=64, n_heads=8, n_kv_heads=2,
        d_ff=128, vocab_size=512,
        frontend="vision_patches", d_frontend=32, n_frontend_tokens=8,
        dtype="float32", remat="none",
    )


register(ArchSpec(
    config=CONFIG, smoke=smoke, shapes=LM_SHAPES,
    skips={"long_500k": "full attention; sub-quadratic-only cell"},
))
