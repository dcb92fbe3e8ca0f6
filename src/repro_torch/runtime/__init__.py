"""Step factories (runtime.steps): the serving path's prefill and decode."""
from . import steps

__all__ = ["steps"]
