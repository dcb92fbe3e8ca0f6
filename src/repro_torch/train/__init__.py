"""Training: AdamW with a cosine schedule and global-norm clipping."""
from . import optimizer
from .optimizer import AdamWConfig, adamw_init, adamw_update

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "optimizer"]
