"""Config for --arch musicgen-large (exact published numbers live in
configs/registry.py; this module is the per-arch entry point the spec
asks for and is what `--arch musicgen-large` resolves)."""
from .registry import get_config

CONFIG = get_config("musicgen-large")
SMOKE = CONFIG.smoke()
