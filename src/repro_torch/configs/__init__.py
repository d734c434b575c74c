"""Architecture configs the port serves, with their smoke variants."""
from .registry import ARCH_IDS, get_config, get_smoke_config  # noqa: F401
