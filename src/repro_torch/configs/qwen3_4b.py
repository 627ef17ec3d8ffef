"""Config for --arch qwen3-4b (exact published numbers live in
configs/registry.py; this module is the per-arch entry point the spec
asks for and is what `--arch qwen3-4b` resolves)."""
from .registry import get_config

CONFIG = get_config("qwen3-4b")
SMOKE = CONFIG.smoke()
