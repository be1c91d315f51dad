"""ctypes loader for the repo's native core (native/libkwt_native.so).

The C++ library under native/ belongs to the repo; this is the port's own
loader for the parts it uses: audio decode and resampling, BPE decoding
and the edit distances of the WER filter and metrics. It builds
the library with `make -C native/` when the shared object is missing.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
from functools import lru_cache

import numpy as np

_NATIVE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "native",
)
_LIB_PATH = os.path.join(_NATIVE_DIR, "libkwt_native.so")

_i64 = ctypes.c_int64
_i32 = ctypes.c_int32
_u8p = ctypes.POINTER(ctypes.c_uint8)
_i32p = ctypes.POINTER(ctypes.c_int32)
_i64p = ctypes.POINTER(ctypes.c_int64)
_u32p = ctypes.POINTER(ctypes.c_uint32)
_f32p = ctypes.POINTER(ctypes.c_float)


@lru_cache(maxsize=1)
def load() -> ctypes.CDLL:
    if not os.path.exists(_LIB_PATH):
        subprocess.run(["make", "-C", _NATIVE_DIR], check=True, capture_output=True)
    lib = ctypes.CDLL(_LIB_PATH)

    lib.kwt_levenshtein.restype = _i64
    lib.kwt_levenshtein.argtypes = [_u32p, _i64, _u32p, _i64]
    lib.kwt_levenshtein_batch.restype = None
    lib.kwt_levenshtein_batch.argtypes = [
        _u32p, _i64p, _u32p, _i64p, _i64, _i64p, _i64p, _i32,
    ]

    lib.kwt_bpe_new.restype = ctypes.c_void_p
    lib.kwt_bpe_new.argtypes = [_u8p, _i64p, _i32, _i32p, _i32]
    lib.kwt_bpe_decode.restype = _i64
    lib.kwt_bpe_decode.argtypes = [ctypes.c_void_p, _i32p, _i64, _u8p, _i64]

    lib.kwt_audio_decode.restype = _i64
    lib.kwt_audio_decode.argtypes = [_u8p, _i64, _i32, _f32p, _i64, _i32p]
    lib.kwt_resample.restype = _i64
    lib.kwt_resample.argtypes = [_f32p, _i64, _i32, _i32, _f32p, _i64]
    return lib


def _as_u32p(a: np.ndarray):
    return a.ctypes.data_as(_u32p)


def levenshtein(a: np.ndarray, b: np.ndarray) -> int:
    """Edit distance between two uint32 symbol arrays."""
    lib = load()
    a = np.ascontiguousarray(a, np.uint32)
    b = np.ascontiguousarray(b, np.uint32)
    return int(lib.kwt_levenshtein(_as_u32p(a), len(a), _as_u32p(b), len(b)))


def levenshtein_batch(
    hyps: list[np.ndarray], refs: list[np.ndarray], n_threads: int = 0
) -> tuple[np.ndarray, np.ndarray]:
    """Batched distances; returns (dist[n], ref_len[n])."""
    lib = load()
    hyp_off = np.zeros(len(hyps) + 1, np.int64)
    ref_off = np.zeros(len(refs) + 1, np.int64)
    np.cumsum([len(h) for h in hyps], out=hyp_off[1:])
    np.cumsum([len(r) for r in refs], out=ref_off[1:])
    hyp = (
        np.concatenate([np.asarray(h, np.uint32) for h in hyps])
        if hyp_off[-1]
        else np.zeros(1, np.uint32)
    )
    ref = (
        np.concatenate([np.asarray(r, np.uint32) for r in refs])
        if ref_off[-1]
        else np.zeros(1, np.uint32)
    )
    dist = np.zeros(len(hyps), np.int64)
    ref_len = np.zeros(len(refs), np.int64)
    lib.kwt_levenshtein_batch(
        _as_u32p(hyp),
        hyp_off.ctypes.data_as(_i64p),
        _as_u32p(ref),
        ref_off.ctypes.data_as(_i64p),
        len(hyps),
        dist.ctypes.data_as(_i64p),
        ref_len.ctypes.data_as(_i64p),
        n_threads,
    )
    return dist, ref_len


def decode_audio(data: bytes, target_rate: int = 16000) -> tuple[np.ndarray, int]:
    """FLAC/WAV/MP3 bytes -> (mono fp32 at target_rate, native_rate)."""
    lib = load()
    # generous bound: FLAC worst case ~ size in samples; WAV exact
    max_out = max(len(data) * 4, 16000)
    for _ in range(3):
        out = np.zeros(max_out, np.float32)
        rate = _i32(0)
        buf = np.frombuffer(data, np.uint8)
        n = lib.kwt_audio_decode(
            buf.ctypes.data_as(_u8p), len(data), target_rate,
            out.ctypes.data_as(_f32p), max_out, ctypes.byref(rate),
        )
        if n == -2:
            max_out *= 4
            continue
        if n < 0:
            raise ValueError("unsupported or corrupt audio payload")
        return out[:n].copy(), rate.value
    raise ValueError("audio decode buffer overflow")


def resample(audio: np.ndarray, sr_in: int, sr_out: int) -> np.ndarray:
    lib = load()
    audio = np.ascontiguousarray(audio, np.float32)
    max_out = int(len(audio) * (sr_out / sr_in)) + 16
    out = np.zeros(max_out, np.float32)
    n = lib.kwt_resample(
        audio.ctypes.data_as(_f32p), len(audio), sr_in, sr_out,
        out.ctypes.data_as(_f32p), max_out,
    )
    if n < 0:
        raise ValueError("resample buffer overflow")
    return out[:n].copy()
