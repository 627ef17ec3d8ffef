"""Flash attention (K7) for Hopper, with its plain PyTorch version."""
