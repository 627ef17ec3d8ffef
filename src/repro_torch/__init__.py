"""repro_torch — the PyTorch/CUDA port of ``repro``.

A second package beside the JAX reference, mirroring it module for module
(``repro.serving.server`` -> ``repro_torch.serving.server``, ...).  It
imports ``torch`` and ``numpy`` and nothing of JAX or of ``repro``; the
tests hold it against the reference on identical inputs.

This slice serves a single compressed forest end to end
(``serving.ForestServer.from_forest(...).predict / serve / serve_safe``)
through two hand-written Hopper kernels in
``kernels/tree_predict/csrc/tree_predict.cu``.  The device is explicit:
entry points take ``device`` (default ``"cuda"``) and never fall back to
the CPU; kernel wrappers dispatch on the device of the tensors they are
given (see ``device.resolve_device``).
"""

from .device import resolve_device

__all__ = ["resolve_device"]
