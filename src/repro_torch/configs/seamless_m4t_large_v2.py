"""seamless-m4t-large-v2 [arXiv:2308.11596; hf]: enc-dec backbone.
The audio frontend is a STUB: input_specs() provides precomputed frame
embeddings (B, S_enc, D); the text decoder is the scheduled workload."""
from ..models.common import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="seamless-m4t-large-v2", n_layers=24, d_model=1024, n_heads=16,
        n_kv_heads=16, d_ff=8192, vocab_size=256206, head_dim=64,
        block_pattern=("attn",), mlp_kind="gelu", family="encdec",
        n_enc_layers=24, rope_theta=10000.0, tie_embeddings=False)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="seamless-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=4, d_ff=128, vocab_size=256, head_dim=16,
        block_pattern=("attn",), mlp_kind="gelu", family="encdec",
        n_enc_layers=2, tie_embeddings=False)
