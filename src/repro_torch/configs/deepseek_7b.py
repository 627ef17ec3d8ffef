"""Config for --arch deepseek-7b (exact published numbers live in
configs/registry.py; this module is the per-arch entry point the spec
asks for and is what `--arch deepseek-7b` resolves)."""
from .registry import get_config

CONFIG = get_config("deepseek-7b")
SMOKE = CONFIG.smoke()
