"""Config for --arch starcoder2-3b (exact published numbers live in
configs/registry.py; this module is the per-arch entry point the spec
asks for and is what `--arch starcoder2-3b` resolves)."""
from .registry import get_config

CONFIG = get_config("starcoder2-3b")
SMOKE = CONFIG.smoke()
