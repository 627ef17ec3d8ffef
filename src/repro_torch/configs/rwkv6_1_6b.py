"""Config for --arch rwkv6-1.6b (exact published numbers live in
configs/registry.py; this module is the per-arch entry point the spec
asks for and is what `--arch rwkv6-1.6b` resolves)."""
from .registry import get_config

CONFIG = get_config("rwkv6-1.6b")
SMOKE = CONFIG.smoke()
