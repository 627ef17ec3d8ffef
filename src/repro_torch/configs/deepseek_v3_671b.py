"""Config for --arch deepseek-v3-671b (exact published numbers live in
configs/registry.py; this module is the per-arch entry point the spec
asks for and is what `--arch deepseek-v3-671b` resolves)."""
from .registry import get_config

CONFIG = get_config("deepseek-v3-671b")
SMOKE = CONFIG.smoke()
