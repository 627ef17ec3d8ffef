"""Config for --arch internvl2-76b (exact published numbers live in
configs/registry.py; this module is the per-arch entry point the spec
asks for and is what `--arch internvl2-76b` resolves)."""
from .registry import get_config

CONFIG = get_config("internvl2-76b")
SMOKE = CONFIG.smoke()
