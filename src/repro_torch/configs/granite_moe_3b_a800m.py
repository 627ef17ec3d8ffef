"""Config for --arch granite-moe-3b-a800m (exact published numbers live in
configs/registry.py; this module is the per-arch entry point the spec
asks for and is what `--arch granite-moe-3b-a800m` resolves)."""
from .registry import get_config

CONFIG = get_config("granite-moe-3b-a800m")
SMOKE = CONFIG.smoke()
