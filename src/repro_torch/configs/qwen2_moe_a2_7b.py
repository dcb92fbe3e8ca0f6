"""qwen2-moe-a2.7b [hf:Qwen/Qwen1.5-MoE-A2.7B]: 60 routed experts top-4
(padded to 64 for 16-way EP) + shared expert (4x width, sigmoid-gated)."""
from ..models.common import ModelConfig, MoEConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-moe-a2.7b", n_layers=24, d_model=2048, n_heads=16,
        n_kv_heads=16, d_ff=1408, vocab_size=151936, head_dim=128,
        block_pattern=("attn",), mlp_kind="swiglu",
        moe=MoEConfig(n_experts=60, top_k=4, d_expert=1408,
                      n_shared=1, d_shared=5632),
        rope_theta=1000000.0, tie_embeddings=False)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-moe-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=4, d_ff=64, vocab_size=256, head_dim=16,
        block_pattern=("attn",), mlp_kind="swiglu",
        moe=MoEConfig(n_experts=6, top_k=2, d_expert=64, n_shared=1,
                      d_shared=128, group_size=64), tie_embeddings=False)
