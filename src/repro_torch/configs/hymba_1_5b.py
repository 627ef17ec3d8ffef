"""Config for --arch hymba-1.5b (exact published numbers live in
configs/registry.py; this module is the per-arch entry point the spec
asks for and is what `--arch hymba-1.5b` resolves)."""
from .registry import get_config

CONFIG = get_config("hymba-1.5b")
SMOKE = CONFIG.smoke()
