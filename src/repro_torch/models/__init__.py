"""The model zoo's architectures, for serving:

  common      - ModelConfig, parameter draws, rms_norm / softcap / rope
  mlp         - SwiGLU, GeGLU, squared-ReLU and GELU feed-forward blocks
  attention   - GQA attention, KV caches, the einsum and kernel paths,
                bidirectional and cross-attention
  moe         - token-choice top-k MoE with an optional shared expert
  rglru       - the Griffin recurrent block (RG-LRU)
  xlstm       - the mLSTM and sLSTM blocks
  transformer - Transformer, Block; train_logits, prefill, decode_step,
                and the encoder of an encoder-decoder model
"""
from . import attention, common, mlp, moe, rglru, transformer, xlstm

__all__ = ["attention", "common", "mlp", "moe", "rglru", "transformer",
           "xlstm"]
