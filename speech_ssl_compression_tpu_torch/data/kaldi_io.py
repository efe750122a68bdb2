"""Kaldi binary archives (.ark/.scp): reading and writing feature matrices.

The port's copy of ``speech_ssl_compression_tpu/data/kaldi_io.py``, numpy
only, from the Kaldi format specification (the capability of the
reference's vendored preprocess/kaldiark.py).

Payloads at an scp offset:
  * binary marker \\0B + "FM " / "DM ": an uncompressed float / double
    matrix (rows and cols as \\x04-prefixed int32, row-major data);
  * "CM ": compressed matrix format 1 (GlobalHeader {min f32, range f32,
    rows i32, cols i32}, per-column 8-byte percentile headers, uint8
    codes, column-major);
  * "CM2 ": format 2 (uint16 linear codes).

Also the scp index, the Kaldi mean/variance accumulator text file of the
LibriSpeech preprocessing release (sum / sumsq / frame-count lines ->
mean and std) and the cluster-label text lines. A parsed matrix is
float64, as JAX's is (an ``FM`` matrix too), and a written one is JAX's
bytes.
"""

from __future__ import annotations

import os
import struct
from typing import BinaryIO, Dict, Tuple

import numpy as np


def _expect(f: BinaryIO, token: bytes):
    got = f.read(len(token))
    if got != token:
        raise ValueError(f"expected {token!r}, got {got!r}")


def _read_basic_int32(f: BinaryIO) -> int:
    size = f.read(1)
    if size != b"\x04":
        raise ValueError(f"expected int32 size byte, got {size!r}")
    return struct.unpack("<i", f.read(4))[0]


def parse_feat_matrix(f: BinaryIO) -> np.ndarray:
    """Parse one feature matrix at the current file position (after seeking
    to the scp offset)."""
    _expect(f, b"\x00B")
    token = f.read(3)
    if token == b"FM ":
        rows = _read_basic_int32(f)
        cols = _read_basic_int32(f)
        data = np.frombuffer(f.read(rows * cols * 4), dtype="<f4")
        return data.reshape(rows, cols).astype(np.float64)
    if token == b"DM ":
        rows = _read_basic_int32(f)
        cols = _read_basic_int32(f)
        data = np.frombuffer(f.read(rows * cols * 8), dtype="<f8")
        return data.reshape(rows, cols)
    if token == b"CM ":
        return _parse_compressed_1(f)
    if token == b"CM2":
        _expect(f, b" ")  # Kaldi tokens are space-terminated: 'CM2 '
        return _parse_compressed_2(f)
    raise ValueError(f"unsupported kaldi matrix token {token!r}")


def _parse_compressed_1(f: BinaryIO) -> np.ndarray:
    min_value, value_range, rows, cols = struct.unpack("<ffii", f.read(16))
    headers = np.frombuffer(f.read(cols * 8), dtype="<u2").reshape(cols, 4)
    pct = min_value + value_range * headers.astype(np.float64) / 65535.0
    codes = np.frombuffer(f.read(cols * rows), dtype=np.uint8)
    codes = codes.reshape(cols, rows).astype(np.float64)

    p0 = pct[:, 0:1]
    p25 = pct[:, 1:2]
    p75 = pct[:, 2:3]
    p100 = pct[:, 3:4]
    out = np.where(
        codes <= 64,
        p0 + (p25 - p0) * codes / 64.0,
        np.where(
            codes <= 192,
            p25 + (p75 - p25) * (codes - 64.0) / 128.0,
            p75 + (p100 - p75) * (codes - 192.0) / 63.0,
        ),
    )
    return out.T  # column-major storage -> (rows, cols)


def _parse_compressed_2(f: BinaryIO) -> np.ndarray:
    min_value, value_range, rows, cols = struct.unpack("<ffii", f.read(16))
    codes = np.frombuffer(f.read(rows * cols * 2), dtype="<u2")
    out = min_value + codes.astype(np.float64) * value_range / 65535.0
    return out.reshape(rows, cols)


# ---------------------------------------------------------------------------
# writers (testing + exporting features back to kaldi consumers)
# ---------------------------------------------------------------------------

def write_feat_matrix(f: BinaryIO, mat: np.ndarray, compress: bool = False):
    f.write(b"\x00B")
    if not compress:
        mat32 = np.ascontiguousarray(mat, dtype="<f4")
        f.write(b"FM ")
        f.write(b"\x04" + struct.pack("<i", mat.shape[0]))
        f.write(b"\x04" + struct.pack("<i", mat.shape[1]))
        f.write(mat32.tobytes())
        return
    rows, cols = mat.shape
    mn = float(mat.min())
    rng = float(max(mat.max() - mn, 1e-10))
    f.write(b"CM ")
    f.write(struct.pack("<ffii", mn, rng, rows, cols))
    to_u16 = lambda v: np.clip(
        np.round((v - mn) / rng * 65535.0), 0, 65535
    ).astype("<u2")
    cols_sorted = np.sort(mat, axis=0)
    headers = np.zeros((cols, 4), dtype="<u2")
    quart = [0, max(rows // 4 - 1, 0), max(3 * rows // 4 - 1, 0), rows - 1]
    for c in range(cols):
        headers[c] = to_u16(cols_sorted[quart, c])
    f.write(headers.tobytes())
    pct = mn + rng * headers.astype(np.float64) / 65535.0
    codes = np.zeros((cols, rows), dtype=np.uint8)
    for c in range(cols):
        p0, p25, p75, p100 = pct[c]
        v = mat[:, c]
        low = np.clip(np.round((v - p0) / max(p25 - p0, 1e-10) * 64), 0, 64)
        mid = np.clip(
            64 + np.round((v - p25) / max(p75 - p25, 1e-10) * 128), 65, 192
        )
        high = np.clip(
            192 + np.round((v - p75) / max(p100 - p75, 1e-10) * 63), 193, 255
        )
        codes[c] = np.where(v <= p25, low, np.where(v <= p75, mid, high)).astype(
            np.uint8
        )
    f.write(codes.tobytes())


# ---------------------------------------------------------------------------
# scp / stats
# ---------------------------------------------------------------------------

def read_scp(scp_path: str, data_dir: str | None = None) -> Dict[str, Tuple[str, int]]:
    """Parse 'utt path:offset' lines. When ``data_dir`` is given, the path's
    basename is re-rooted there (reference read_scp_file behavior)."""
    out = {}
    with open(scp_path) as fp:
        for line in fp:
            line = line.strip()
            if not line:
                continue
            key, path = line.split(" ", 1)
            loc, off = path.rsplit(":", 1)
            if data_dir is not None:
                loc = os.path.join(data_dir, os.path.basename(loc))
            out[key] = (loc, int(off))
    return out


def read_mean_var(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """Kaldi-style accumulator text file: line1 '[sum,...]',
    line2 '[sumsq,...]', line3 frame count -> (mean, std)."""
    with open(path) as fp:
        s = np.array(fp.readline().strip()[1:-1].split(","), dtype=float)
        sq = np.array(fp.readline().strip()[1:-1].split(","), dtype=float)
        n = int(fp.readline().strip())
    mean = s / n
    std = np.sqrt(sq / n - mean**2)
    return mean, std


def read_text_labels(path: str, offset: int) -> np.ndarray:
    """Cluster-label line at a byte offset: space-separated ints."""
    with open(path, "r") as fp:
        fp.seek(offset)
        return np.array(list(map(int, fp.readline().strip().split(" "))))
