"""Config for --arch qwen2.5-3b (exact published numbers live in
configs/registry.py; this module is the per-arch entry point the spec
asks for and is what `--arch qwen2.5-3b` resolves)."""
from .registry import get_config

CONFIG = get_config("qwen2.5-3b")
SMOKE = CONFIG.smoke()
