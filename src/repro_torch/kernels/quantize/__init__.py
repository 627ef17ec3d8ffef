"""The §7 uniform quantizer kernel (K6) for Hopper, with its plain
PyTorch version."""
