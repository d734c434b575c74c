"""Byte-level tokenizer, the part of ``repro.data.pipeline`` the serving
path needs."""
from __future__ import annotations

import numpy as np


class ByteTokenizer:
    vocab_size = 256

    def encode(self, text: str) -> np.ndarray:
        return np.frombuffer(text.encode("utf-8"), np.uint8).astype(np.int32)

    def decode(self, ids) -> str:
        return bytes(int(i) % 256 for i in ids).decode("utf-8", "replace")
