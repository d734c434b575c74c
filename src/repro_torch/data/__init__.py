"""Input pipeline pieces the port needs."""
from .pipeline import ByteTokenizer  # noqa: F401
