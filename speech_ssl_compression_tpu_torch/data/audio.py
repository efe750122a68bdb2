"""Audio reading: native FLAC (and Ogg Vorbis) decoding through ctypes, WAV
through scipy, and zip-slice manifest paths.

The port's copy of ``speech_ssl_compression_tpu/data/audio.py``
(``read_audio`` and what it calls, ``read_ogg``, ``write_ogg`` and
``is_sf_audio_data``). The decoder is the repository's C++ library built from
``native/audio/`` with ``make`` at first use, as the JAX package builds it;
decoded FLAC PCM is checked against the STREAMINFO MD5.
"""

from __future__ import annotations

import ctypes
import hashlib
import io
import mmap
import os
import pathlib
import subprocess
from typing import Tuple

import numpy as np

_NATIVE_DIR = pathlib.Path(__file__).resolve().parents[2] / "native" / "audio"
_LIB_PATH = _NATIVE_DIR / "libsslc_audio.so"
_lib = None
_AUDIO_EXTS = (".npy", ".wav", ".flac", ".ogg")


class _FlacInfo(ctypes.Structure):
    _fields_ = [
        ("sample_rate", ctypes.c_int32),
        ("channels", ctypes.c_int32),
        ("bits_per_sample", ctypes.c_int32),
        ("total_samples", ctypes.c_int64),
        ("md5", ctypes.c_uint8 * 16),
    ]


def _ensure_lib():
    """Build (``make -C native/audio``) if the library is missing or
    predates the Ogg codec, load it once and declare its entry points."""
    global _lib
    if _lib is not None:
        return _lib
    stale = (_LIB_PATH.exists()
             and b"sslc_ogg_available" not in _LIB_PATH.read_bytes())
    if stale or not _LIB_PATH.exists():
        subprocess.run(["make", "-C", str(_NATIVE_DIR), "clean", "all"],
                       check=True, capture_output=True)
    lib = ctypes.CDLL(str(_LIB_PATH))
    pcm_out = ctypes.POINTER(ctypes.POINTER(ctypes.c_int32))
    lib.flac_decode_file.restype = ctypes.c_int
    lib.flac_decode_file.argtypes = [ctypes.c_char_p, pcm_out,
                                     ctypes.POINTER(_FlacInfo)]
    lib.flac_decode_buffer.restype = ctypes.c_int
    lib.flac_decode_buffer.argtypes = [ctypes.c_char_p, ctypes.c_int64,
                                       pcm_out, ctypes.POINTER(_FlacInfo)]
    lib.flac_free.argtypes = [ctypes.POINTER(ctypes.c_int32)]
    lib.sslc_ogg_available.restype = ctypes.c_int
    lib.sslc_ogg_encode_available.restype = ctypes.c_int
    lib.sslc_ogg_decode.restype = ctypes.c_int
    lib.sslc_ogg_decode.argtypes = [
        ctypes.c_char_p, ctypes.c_size_t,
        ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int64),
    ]
    lib.sslc_ogg_encode.restype = ctypes.c_int
    lib.sslc_ogg_encode.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_int32,
        ctypes.c_int32, ctypes.c_float,
        ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.POINTER(ctypes.c_size_t),
    ]
    lib.sslc_ogg_free.argtypes = [ctypes.c_void_p]
    _lib = lib
    return lib


def read_ogg_bytes(data: bytes,
                   origin: str = "<bytes>") -> Tuple[np.ndarray, int]:
    """An in-memory Ogg Vorbis stream -> (float32 (C, T), sr), through the
    system's libvorbisfile."""
    lib = _ensure_lib()
    if not lib.sslc_ogg_available():
        raise IOError(f"Ogg stream at {origin}: libvorbisfile is not "
                      "available on this system — re-encode as FLAC or WAV")
    pcm = ctypes.POINTER(ctypes.c_float)()
    channels, rate, frames = ctypes.c_int32(), ctypes.c_int32(), ctypes.c_int64()
    rc = lib.sslc_ogg_decode(data, len(data), ctypes.byref(pcm),
                             ctypes.byref(channels), ctypes.byref(rate),
                             ctypes.byref(frames))
    if rc != 0:
        raise IOError(f"Ogg Vorbis decode failed ({rc}): {origin}")
    c, n = int(channels.value), int(frames.value)
    wav = np.ctypeslib.as_array(pcm, shape=(c * n,)).copy().reshape(c, n)
    lib.sslc_ogg_free(pcm)
    return wav, int(rate.value)


def read_ogg(path: str) -> Tuple[np.ndarray, int]:
    """An Ogg Vorbis file -> (float32 (C, T), sr)."""
    with open(path, "rb") as f:
        return read_ogg_bytes(f.read(), origin=path)


def write_ogg(path: str, wav: np.ndarray, sample_rate: int,
              quality: float = 0.4) -> None:
    """(C, T) or (T,) float32 in [-1, 1] -> an Ogg Vorbis file
    (libvorbisenc VBR at ``quality``), for tests and fixtures."""
    lib = _ensure_lib()
    if not lib.sslc_ogg_encode_available():
        raise IOError("libvorbis/libvorbisenc not available on this system")
    wav = np.asarray(wav, np.float32)
    wav = np.ascontiguousarray(wav[None, :] if wav.ndim == 1 else wav)
    out = ctypes.POINTER(ctypes.c_uint8)()
    out_len = ctypes.c_size_t()
    rc = lib.sslc_ogg_encode(
        wav.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), wav.shape[1],
        wav.shape[0], int(sample_rate), ctypes.c_float(quality),
        ctypes.byref(out), ctypes.byref(out_len))
    if rc != 0:
        raise IOError(f"Ogg Vorbis encode failed ({rc}): {path}")
    data = ctypes.string_at(out, out_len.value)
    lib.sslc_ogg_free(out)
    with open(path, "wb") as f:
        f.write(data)


def _finish_flac(rc, out, info, origin, verify_md5):
    lib = _ensure_lib()
    if rc != 0:
        raise IOError(f"FLAC decode failed ({rc}): {origin}")
    data = np.ctypeslib.as_array(
        out, shape=(info.total_samples * info.channels,)).copy()
    lib.flac_free(out)
    if verify_md5 and any(info.md5):
        bps = info.bits_per_sample
        raw = None
        if bps == 16:
            raw = data.astype("<i2").tobytes()
        elif bps == 8:
            raw = data.astype("<i1").tobytes()
        elif bps == 24:
            b = data.astype("<i4").tobytes()
            raw = b"".join(b[i:i + 3] for i in range(0, len(b), 4))
        if raw is not None and hashlib.md5(raw).digest() != bytes(info.md5):
            raise IOError(f"FLAC MD5 mismatch decoding {origin}")
    scale = float(1 << (info.bits_per_sample - 1))
    wav = (data.astype(np.float32) / scale).reshape(-1, info.channels).T
    return wav, int(info.sample_rate)


def read_flac(path: str, verify_md5: bool = True) -> Tuple[np.ndarray, int]:
    """A FLAC file -> (float32 (channels, n_samples) in [-1, 1], sr),
    scaled by 2**(bps - 1) as torchaudio.load does."""
    lib = _ensure_lib()
    out, info = ctypes.POINTER(ctypes.c_int32)(), _FlacInfo()
    rc = lib.flac_decode_file(os.fsencode(str(path)), ctypes.byref(out),
                              ctypes.byref(info))
    return _finish_flac(rc, out, info, path, verify_md5)


def read_flac_bytes(data: bytes, verify_md5: bool = True,
                    origin: str = "<bytes>") -> Tuple[np.ndarray, int]:
    lib = _ensure_lib()
    out, info = ctypes.POINTER(ctypes.c_int32)(), _FlacInfo()
    rc = lib.flac_decode_buffer(data, len(data), ctypes.byref(out),
                                ctypes.byref(info))
    return _finish_flac(rc, out, info, origin, verify_md5)


def _normalize_pcm(pcm: np.ndarray) -> np.ndarray:
    """(T,) or (T, C) integer/float PCM -> (C, T) float32 in [-1, 1]."""
    if pcm.dtype == np.int16:
        wav = pcm.astype(np.float32) / 32768.0
    elif pcm.dtype == np.int32:
        wav = pcm.astype(np.float32) / 2147483648.0
    elif pcm.dtype == np.uint8:
        wav = (pcm.astype(np.float32) - 128.0) / 128.0
    else:
        wav = pcm.astype(np.float32)
    return wav[None, :] if wav.ndim == 1 else wav.T


def read_wav(path) -> Tuple[np.ndarray, int]:
    from scipy.io import wavfile

    sr, data = wavfile.read(path)
    return _normalize_pcm(data), int(sr)


def parse_path(path) -> Tuple[str, list]:
    """(file_path, slice_ptr): [] for a plain audio or feature file,
    [byte_offset, byte_length] for a zip-slice ``archive.zip:offset:length``
    (reference audio_utils.py:7-29)."""
    path = str(path)
    if os.path.splitext(path)[1].lower() in _AUDIO_EXTS:
        return path, []
    file_path, *slice_ptr = path.split(":")
    if len(slice_ptr) != 2:
        raise ValueError(
            f"invalid audio path (want file.zip:offset:length): {path}")
    if not os.path.isfile(file_path):
        raise FileNotFoundError(f"File not found: {file_path}")
    return file_path, [int(i) for i in slice_ptr]


def read_from_stored_zip(zip_path: str, offset: int, length: int) -> bytes:
    with open(zip_path, "rb") as f:
        with mmap.mmap(f.fileno(), length=0, access=mmap.ACCESS_READ) as m:
            return m[offset:offset + length]


def is_sf_audio_data(data: bytes) -> bool:
    """True when the bytes start with a wav, flac or ogg magic (reference
    audio_utils.py:40-44)."""
    return len(data) >= 3 and data[:3] in (b"RIF", b"fLa", b"Ogg")


def read_audio_bytes(data: bytes,
                     origin: str = "<bytes>") -> Tuple[np.ndarray, int]:
    if data[:3] == b"fLa":
        return read_flac_bytes(data, origin=origin)
    if data[:3] == b"RIF":
        return read_wav(io.BytesIO(data))
    if data[:3] == b"Ogg":
        return read_ogg_bytes(data, origin=origin)
    raise ValueError(f"unsupported in-memory audio format: {origin}")


def read_audio(path: str) -> Tuple[np.ndarray, int]:
    """A FLAC, WAV or Ogg file, or a zip slice of one -> (float32 (C, T)
    in [-1, 1], sample rate)."""
    file_path, slice_ptr = parse_path(path)
    if slice_ptr:
        data = read_from_stored_zip(file_path, *slice_ptr)
        if not is_sf_audio_data(data):
            raise ValueError(f"zip slice is not audio data: {path}")
        return read_audio_bytes(data, origin=path)
    p = file_path.lower()
    if p.endswith(".flac"):
        return read_flac(file_path)
    if p.endswith(".wav"):
        return read_wav(file_path)
    if p.endswith(".npy"):
        raise ValueError(f"{path} is a feature dump, not audio — load it "
                         "with np.load")
    if p.endswith(".ogg"):
        return read_ogg(file_path)
    raise ValueError(f"unsupported audio format: {path}")
