"""gemma2-9b [arXiv:2408.00118]: 42L d3584 16H(kv8, head 256) d_ff 14336,
vocab 256000; alternating local(4096)/global attention, attn softcap 50,
final softcap 30, sandwich (post) norms, (1+w) RMSNorm, scaled embeddings,
GeGLU, tied embeddings."""
from repro_torch.configs.base import ArchSpec, LM_SHAPES, ModelConfig, register

CONFIG = ModelConfig(
    name="gemma2-9b", family="dense",
    n_layers=42, d_model=3584, n_heads=16, n_kv_heads=8, d_head=256,
    d_ff=14_336, vocab_size=256_000,
    attn_logit_softcap=50.0, final_logit_softcap=30.0,
    sliding_window=4096, layer_pattern="local_global",
    post_norms=True, norm_plus_one=True, scale_embeds=True,
    act="gelu", tie_embeddings=True,
    train_accum=2,
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="gemma2-9b-smoke", family="dense",
        n_layers=4, d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
        d_ff=128, vocab_size=512,
        attn_logit_softcap=50.0, final_logit_softcap=30.0,
        sliding_window=8, layer_pattern="local_global",
        post_norms=True, norm_plus_one=True, scale_embeds=True,
        act="gelu", tie_embeddings=True, dtype="float32", remat="none",
    )


register(ArchSpec(
    config=CONFIG, smoke=smoke, shapes=LM_SHAPES,
    skips={"long_500k": "global layers are full attention; sub-quadratic-"
                        "only cell"},
))
