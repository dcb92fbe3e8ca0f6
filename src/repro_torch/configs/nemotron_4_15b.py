"""nemotron-4-15b [arXiv:2402.16819]: dense, GQA, squared-ReLU MLP."""
from ..models.common import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="nemotron-4-15b", n_layers=32, d_model=6144, n_heads=48,
        n_kv_heads=8, d_ff=24576, vocab_size=256000, head_dim=128,
        block_pattern=("attn",), mlp_kind="relu2", rope_theta=10000.0,
        tie_embeddings=False)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="nemotron-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=2, d_ff=192, vocab_size=256, head_dim=16,
        block_pattern=("attn",), mlp_kind="relu2", tie_embeddings=False)
