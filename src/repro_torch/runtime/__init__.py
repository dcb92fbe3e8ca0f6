"""Step factories (runtime.steps: training, prefill and decode) and
gradient compression (runtime.compression)."""
from . import compression, steps

__all__ = ["compression", "steps"]
