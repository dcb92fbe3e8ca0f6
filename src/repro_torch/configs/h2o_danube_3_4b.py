"""h2o-danube-3-4b [arXiv:2401.16818]: llama+mistral mix with sliding-
window attention (subquadratic KV => long_500k eligible)."""
from ..models.common import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="h2o-danube-3-4b", n_layers=24, d_model=3840, n_heads=32,
        n_kv_heads=8, d_ff=10240, vocab_size=32000, head_dim=120,
        block_pattern=("attn_local",), window=4096, mlp_kind="swiglu",
        rope_theta=10000.0, tie_embeddings=False, subquadratic=True)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="danube-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=2, d_ff=128, vocab_size=256, head_dim=16,
        block_pattern=("attn_local",), window=32, mlp_kind="swiglu",
        tie_embeddings=False, subquadratic=True)
