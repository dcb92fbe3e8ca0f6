"""Step factories (runtime.steps: training, prefill and decode), gradient
compression (runtime.compression), the slot-ordered gradient all-reduce
(runtime.collectives) and the sharded solver's process group
(runtime.sharding)."""
from . import collectives, compression, sharding, steps

__all__ = ["collectives", "compression", "sharding", "steps"]
