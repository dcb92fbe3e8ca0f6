"""granite-moe-1b-a400m [hf:ibm-granite/granite-3.0-1b-a400m-base]:
32 experts, top-8, per-expert d_ff 512."""
from ..models.common import ModelConfig, MoEConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="granite-moe-1b-a400m", n_layers=24, d_model=1024, n_heads=16,
        n_kv_heads=8, d_ff=512, vocab_size=49155, head_dim=64,
        block_pattern=("attn",), mlp_kind="swiglu",
        moe=MoEConfig(n_experts=32, top_k=8, d_expert=512),
        rope_theta=10000.0, tie_embeddings=True)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="granite-moe-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=2, d_ff=64, vocab_size=256, head_dim=16,
        block_pattern=("attn",), mlp_kind="swiglu",
        moe=MoEConfig(n_experts=8, top_k=2, d_expert=64, group_size=64))
