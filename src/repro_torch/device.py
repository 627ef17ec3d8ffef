"""Explicit device resolution for the port.

Every entry point of ``repro_torch`` takes a ``device`` argument (default
``"cuda"``) and resolves it here.  Asking for CUDA on a host without a
usable card raises ``RuntimeError``: the port never moves work to the CPU
behind the caller's back.  Callers that want the CPU say ``device="cpu"``.

``resolve_devices`` builds the device list a serving session shards over
(the sharded engine, K5): where the reference shards over the devices
JAX sees, the port takes an explicit list of ``torch.device``.
"""
from __future__ import annotations

import torch

__all__ = ["resolve_device", "resolve_devices"]


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


def resolve_devices(
    device: str | torch.device = "cuda", devices=None
) -> tuple[torch.device, ...]:
    """The devices a session on ``device`` shards over.  By default every
    visible CUDA device when ``device`` is a CUDA device, else
    ``(device,)``.  An explicit ``devices`` list may name one device more
    than once (several shards on one card, or on the CPU); every entry
    must be of ``device``'s type."""
    dev = resolve_device(device)
    if devices is None:
        if dev.type == "cuda":
            return tuple(
                torch.device("cuda", i)
                for i in range(torch.cuda.device_count())
            )
        return (dev,)
    out = tuple(resolve_device(d) for d in devices)
    if not out:
        raise ValueError("devices must name at least one device")
    if any(d.type != dev.type for d in out):
        raise ValueError(
            f"devices {[str(d) for d in out]} must all be {dev.type} "
            f"devices, like the session's {dev}"
        )
    return out
