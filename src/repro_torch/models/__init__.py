"""The model zoo's dense decoder-only language models, for serving:

  common      - ModelConfig, parameter draws, rms_norm / softcap / rope
  mlp         - SwiGLU, GeGLU, squared-ReLU and GELU feed-forward blocks
  attention   - GQA attention, KV caches, the einsum and kernel paths
  transformer - Transformer, Block; train_logits, prefill, decode_step
"""
from . import attention, common, mlp, transformer

__all__ = ["attention", "common", "mlp", "transformer"]
