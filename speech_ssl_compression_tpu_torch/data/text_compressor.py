"""Filename/text compression for large manifests.

The port's copy of ``speech_ssl_compression_tpu/data/text_compressor.py``
(reference fairseq_code/text_compressor.py:1-43): levels none, low and
high (zlib 1 and 9); the reference's optional unishox2 backend maps to
zlib-high. The bytes are JAX's at each level.
"""

from __future__ import annotations

import zlib
from enum import Enum


class TextCompressionLevel(Enum):
    none = 0
    low = 1
    high = 2


class TextCompressor:
    def __init__(self, level: TextCompressionLevel,
                 max_input_byte_length: int = 2**16):
        # max_input_byte_length exists for reference API parity
        # (fairseq_code/text_compressor.py:3-6, where it feeds unishox2's
        # chunking); zlib has no such limit, so it is accepted and ignored.
        self.level = level

    def compress(self, text: str) -> bytes:
        if self.level == TextCompressionLevel.low:
            return zlib.compress(text.encode(), level=1)
        if self.level == TextCompressionLevel.high:
            return zlib.compress(text.encode(), level=9)
        return text.encode()

    def decompress(self, compressed: bytes) -> str:
        if self.level == TextCompressionLevel.none:
            return compressed.decode()
        return zlib.decompress(compressed).decode()
