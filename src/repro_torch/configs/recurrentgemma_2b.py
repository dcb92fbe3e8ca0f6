"""recurrentgemma-2b [arXiv:2402.19427; hf]: Griffin — RG-LRU recurrent
blocks + local attention, 2:1 pattern (subquadratic)."""
from ..models.common import ModelConfig


def config() -> ModelConfig:
    # 26 layers: 8 x (rglru, rglru, attn_local) groups + 2 remainder rglru
    return ModelConfig(
        name="recurrentgemma-2b", n_layers=26, d_model=2560, n_heads=10,
        n_kv_heads=1, d_ff=7680, vocab_size=256000, head_dim=256,
        block_pattern=("rglru", "rglru", "attn_local"), window=2048,
        mlp_kind="geglu", rope_theta=10000.0, tie_embeddings=True,
        subquadratic=True)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma-smoke", n_layers=3, d_model=64, n_heads=4,
        n_kv_heads=1, d_ff=128, vocab_size=256, head_dim=16,
        block_pattern=("rglru", "rglru", "attn_local"), window=32,
        mlp_kind="geglu", subquadratic=True)
