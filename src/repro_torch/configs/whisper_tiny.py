"""whisper-tiny [arXiv:2212.04356]: 4L encoder + 4L decoder, d384 6H d_ff
1536, vocab 51865, enc-dec with conv frontend STUB (input_specs provides
precomputed mel-frame embeddings, d_frontend=80).  The assigned 32k decode
cell is applied mechanically (real Whisper caps sources at 1500 frames —
DESIGN.md §5)."""
from repro_torch.configs.base import ArchSpec, LM_SHAPES, ModelConfig, register

CONFIG = ModelConfig(
    name="whisper-tiny", family="audio",
    n_layers=4, d_model=384, n_heads=6, n_kv_heads=6,
    d_ff=1536, vocab_size=51_865, n_encoder_layers=4,
    frontend="audio_frames", d_frontend=80,
    rope_style="none", act="gelu", tie_embeddings=True,
    train_accum=2,  # halve the 32k-frame encoder activation set
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="whisper-tiny-smoke", family="audio",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=128, vocab_size=512, n_encoder_layers=2,
        frontend="audio_frames", d_frontend=20,
        rope_style="none", act="gelu", tie_embeddings=True,
        dtype="float32", remat="none",
    )


register(ArchSpec(
    config=CONFIG, smoke=smoke, shapes=LM_SHAPES,
    skips={"long_500k": "full attention enc-dec; sub-quadratic-only cell"},
))
