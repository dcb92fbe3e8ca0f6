"""Fault tolerance: checkpoints and straggler detection."""
from . import checkpoint, straggler
from .checkpoint import CheckpointManager
from .straggler import HeartbeatMonitor

__all__ = ["CheckpointManager", "HeartbeatMonitor", "checkpoint", "straggler"]
