"""phi4-mini-3.8b [arXiv:2412.08905; hf]: dense, RoPE, SwiGLU, GQA."""
from ..models.common import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="phi4-mini-3.8b", n_layers=32, d_model=3072, n_heads=24,
        n_kv_heads=8, d_ff=8192, vocab_size=200064, head_dim=128,
        block_pattern=("attn",), mlp_kind="swiglu", rope_theta=10000.0,
        tie_embeddings=True)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="phi4-mini-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=2, d_ff=128, vocab_size=256, head_dim=16,
        block_pattern=("attn",), mlp_kind="swiglu")
