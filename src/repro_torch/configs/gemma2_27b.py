"""gemma2-27b [arXiv:2408.00118; hf]: local/global alternating attention,
logit softcaps, GeGLU."""
from ..models.common import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="gemma2-27b", n_layers=46, d_model=4608, n_heads=32,
        n_kv_heads=16, d_ff=36864, vocab_size=256000, head_dim=128,
        block_pattern=("attn_local", "attn"), window=4096,
        attn_softcap=50.0, final_softcap=30.0,
        mlp_kind="geglu", rope_theta=10000.0, tie_embeddings=True)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="gemma2-smoke", n_layers=4, d_model=64, n_heads=4,
        n_kv_heads=2, d_ff=160, vocab_size=256, head_dim=16,
        block_pattern=("attn_local", "attn"), window=32,
        attn_softcap=50.0, final_softcap=30.0, mlp_kind="geglu")
