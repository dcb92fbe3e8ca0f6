"""The port's one device rule.

Entry points take `device="cuda"` by default and run on the card; only
an explicit `device="cpu"` runs on the host (the CPU tests do).  A CUDA
device that is asked for and absent raises: there is no silent fallback.
"""
from __future__ import annotations

import torch


def resolve(device: str | torch.device = "cuda") -> torch.device:
    """Validate `device` ("cuda", "cuda:N" or "cpu") and return it as a
    torch.device.  Raises RuntimeError when CUDA is asked for and no card
    is available, ValueError for any other device type."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device={str(device)!r} asked for, but torch.cuda."
                f"is_available() is False; pass device='cpu' to run on "
                f"the host")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        return dev
    if dev.type == "cpu":
        return dev
    raise ValueError(f"device must be 'cuda' or 'cpu', got {str(device)!r}")
