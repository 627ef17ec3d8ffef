"""Hand-written Hopper kernels of the port, with their plain PyTorch
versions beside them.  ``build`` compiles the CUDA sources at first use.

No kernel here has a backward pass, as none of the reference's Pallas
kernels has one (``jax.grad`` through them raises).  An entry that would
be differentiated raises ``KernelGradientError`` on either device: the
card's launch returns a tensor with no ``grad_fn`` (a gradient through
it would be cut silently), and the CPU's plain version would give a
gradient the reference cannot.  Training takes ``use_flash=False``."""
from __future__ import annotations

import torch

__all__ = ["KernelGradientError", "refuse_autograd"]


class KernelGradientError(RuntimeError):
    """A kernel entry was called where autograd would differentiate it."""


def refuse_autograd(kernel: str, *tensors: torch.Tensor) -> None:
    """Raise ``KernelGradientError`` when grad mode is on and any of
    ``tensors`` requires grad."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise KernelGradientError(
            f"{kernel} has no backward pass: the reference's Pallas kernel "
            "has none either (jax.grad raises through it), so no gradient "
            "flows through this entry on any device; train with "
            "use_flash=False, or call it under torch.no_grad()"
        )
