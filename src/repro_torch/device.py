"""Explicit device resolution for the port.

Every entry point of ``repro_torch`` takes a ``device`` argument (default
``"cuda"``) and resolves it here.  Asking for CUDA on a host without a
usable card raises ``RuntimeError``: the port never moves work to the CPU
behind the caller's back.  Callers that want the CPU say ``device="cpu"``.
"""
from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """The ``torch.device`` for ``device``.  Raises ``RuntimeError`` when
    CUDA is asked for and ``torch.cuda.is_available()`` is False."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(device)!r} asked for, but CUDA is not "
                "available on this host; pass device='cpu' to run on the "
                "CPU"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {str(device)!r}")
    return dev
