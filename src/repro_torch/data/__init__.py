"""The deterministic synthetic data stream (numpy)."""
from .pipeline import DataConfig, synthetic_stream

__all__ = ["DataConfig", "synthetic_stream"]
