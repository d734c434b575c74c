"""The architecture configs, their smoke variants and the shape registry.
Counterpart of ``repro.configs``."""
from .registry import ARCH_IDS, get_config, get_smoke_config  # noqa: F401
from .shapes import SHAPES, applicable, cell_list  # noqa: F401
