"""internvl2-1b [arXiv:2404.16821; hf]: InternViT + InternLM2 backbone.
The vision frontend is a STUB: input_specs() provides precomputed patch
embeddings (B, n_img_tokens, D) fed through a learned projector."""
from ..models.common import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="internvl2-1b", n_layers=24, d_model=896, n_heads=14,
        n_kv_heads=2, d_ff=4864, vocab_size=151655, head_dim=64,
        block_pattern=("attn",), mlp_kind="swiglu", family="vlm",
        n_img_tokens=256, rope_theta=1000000.0, tie_embeddings=True)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="internvl2-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=2, d_ff=128, vocab_size=256, head_dim=16,
        block_pattern=("attn",), mlp_kind="swiglu", family="vlm",
        n_img_tokens=16)
