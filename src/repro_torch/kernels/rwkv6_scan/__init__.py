"""The WKV6 recurrence kernel (K8) for Hopper, with its plain PyTorch
version."""
