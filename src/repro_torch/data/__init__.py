"""Input pipeline: a copy of ``repro.data``."""
from .pipeline import (ByteTokenizer, DataPipeline,  # noqa: F401
                       synthetic_batch)
