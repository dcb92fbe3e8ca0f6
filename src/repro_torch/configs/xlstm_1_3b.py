"""xlstm-1.3b [arXiv:2405.04517]: 48 blocks, 7:1 mLSTM:sLSTM, d_ff=0
(projections live inside the blocks).  FSDP-only sharding: the matrix
memory is head-structured (4 heads) and does not TP-shard at 16-way;
see DESIGN.md §5 (subquadratic => long_500k eligible)."""
from ..models.common import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="xlstm-1.3b", n_layers=48, d_model=2048, n_heads=4,
        n_kv_heads=4, d_ff=0, vocab_size=50304, head_dim=512,
        block_pattern=("mlstm",) * 7 + ("slstm",), mlp_kind="none",
        tie_embeddings=False, sharding="fsdp", subquadratic=True)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="xlstm-smoke", n_layers=4, d_model=64, n_heads=2,
        n_kv_heads=2, d_ff=0, head_dim=32, vocab_size=256,
        block_pattern=("mlstm", "mlstm", "mlstm", "slstm"), mlp_kind="none",
        tie_embeddings=False, sharding="fsdp", subquadratic=True)
