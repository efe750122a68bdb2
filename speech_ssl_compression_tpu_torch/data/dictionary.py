"""Label dictionaries for HuBERT targets.

The port's copy of ``speech_ssl_compression_tpu/data/dictionary.py``: a
minimal fairseq-style Dictionary (file format "symbol count" per line;
indices <s>=0, <pad>=1, </s>=2, <unk>=3, then the file's symbols in order),
``LabelEncoder`` and the raw-cluster-id lookup table the collate step
encodes with.
"""

from __future__ import annotations

from typing import List

import numpy as np


class Dictionary:
    def __init__(self, symbols: List[str]):
        self.specials = ["<s>", "<pad>", "</s>", "<unk>"]
        self.symbols = self.specials + list(symbols)
        self.index = {s: i for i, s in enumerate(self.symbols)}

    @classmethod
    def load(cls, path: str) -> "Dictionary":
        symbols = []
        with open(path) as f:
            for line in f:
                line = line.strip()
                if line:
                    symbols.append(line.split(" ")[0])
        return cls(symbols)

    def __len__(self):
        return len(self.symbols)

    def pad(self) -> int:
        return 1

    def eos(self) -> int:
        return 2

    def unk(self) -> int:
        return 3

    def encode_line(self, line: str, append_eos: bool = False,
                    add_if_not_exist: bool = False) -> np.ndarray:
        ids = [self.index.get(tok, self.unk()) for tok in line.split()]
        if append_eos:
            ids.append(self.eos())
        return np.array(ids, np.int64)


class LabelEncoder:
    """A label line -> dictionary indices, no eos, unknown symbols <unk>
    (JAX ``LabelEncoder``; reference runner.py:25-34)."""

    def __init__(self, dictionary: Dictionary):
        self.dictionary = dictionary

    def __call__(self, label: str) -> np.ndarray:
        return self.dictionary.encode_line(
            label, append_eos=False, add_if_not_exist=False)


def build_label_lookup(dictionary: Dictionary) -> np.ndarray:
    """Raw nonnegative cluster id -> dictionary index, in the dict file's
    symbol order (a frequency-sorted dict.km.txt permutes ids). Negative
    numeric symbols stay out of the table and, like any id outside it,
    encode as <unk>."""
    numeric = [int(s) for s in dictionary.symbols[4:]
               if s.lstrip("-").isdigit()]
    nonneg = [x for x in numeric if x >= 0]
    hi = (max(nonneg) + 1) if nonneg else 0
    lut = np.full(max(hi, 1), dictionary.unk(), np.int32)
    for raw in nonneg:
        lut[raw] = dictionary.index[str(raw)]
    return lut
