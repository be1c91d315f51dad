"""nvcc build and ctypes loading of the port's CUDA kernels (csrc/*.cu).

Each source compiles into its own shared library with a plain C interface
(no PyTorch headers, so a build takes seconds), under build/torch_kernels/
of the checkout, named by a hash of the source and the shared headers
(csrc/*.cuh), so an edited kernel is rebuilt. The first use builds every
missing library, one nvcc process per source, all started together.
Nothing here runs at import time: the CPU tests import every module of the
package on machines without nvcc.
"""
from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "torch_kernels")
SOURCES = (
    "flash_attention_sm90", "flash_attention_f32", "flash_attention_bwd",
    "flash_attention_bwd_f32", "decode_attention", "decode_attention_ring",
    "decode_attention_beam", "mel", "layer_norm", "conv_stem", "conv_stem_f32",
    "flash_attention_int8", "vpu_cal",
)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
# C signatures of each library's entry points: first the index of the card
# the tensors are on (the entry launches there and keeps its set-up per card,
# csrc/card.cuh), pointers and the stream as c_void_p (ctypes would
# otherwise pass 32-bit ints and cut them)
SIGNATURES = {
    "flash_attention_sm90": {
        "kwt_flash_attention_sm90_fwd": [_I, _P, _P, _P, _P, _P, _P, _P],
        "kwt_flash_attention_sm90_fwd_nomax": [_I, _P, _P, _P, _P, _P, _P, _P, _P],
    },
    "flash_attention_f32": {
        "kwt_flash_attention_f32": [_I, _P, _P, _P, _P, _P, _P, _P],
        "kwt_flash_attention_f32_nomax": [_I, _P, _P, _P, _P, _P, _P, _P, _P],
    },
    "flash_attention_bwd": {
        "kwt_flash_attention_bwd": [_I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P],
    },
    "flash_attention_bwd_f32": {
        "kwt_flash_attention_bwd_f32": [_I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P],
    },
    "decode_attention": {
        "kwt_decode_attention": [
            _I, _P, _L, _P, _P, _P, _P, _P, _I, _P, _I, _I, _I, _I, _I, _I, _I, _P,
        ],
        "kwt_decode_attention_heads": [
            _I, _P, _L, _P, _P, _P, _P, _P, _I, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P,
        ],
    },
    "decode_attention_ring": {
        "kwt_decode_attention_ring": [
            _I, _P, _L, _P, _P, _P, _P, _P, _I, _P, _P, _I, _I, _I, _I, _I, _P,
        ],
        "kwt_decode_attention_ring_f32": [
            _I, _P, _L, _P, _P, _P, _P, _P, _I, _P, _P, _I, _I, _I, _I, _I, _P,
        ],
    },
    "decode_attention_beam": {
        "kwt_decode_attention_beam": [
            _I, _P, _L, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P,
        ],
        "kwt_decode_attention_beam_f32": [
            _I, _P, _L, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P,
        ],
    },
    "mel": {
        "kwt_log_mel": [_I, _P, _I, _P, _P, _P, _P, _P, _I, _L, _I, _I, _P],
    },
    "layer_norm": {
        "kwt_layer_norm": [_I, _P, _P, _P, _P, _I, _I, _P, _P, _I, _I, _F, _P],
    },
    "conv_stem": {
        "kwt_conv_stem": [_I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P],
    },
    "conv_stem_f32": {
        "kwt_conv_stem_f32": [_I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P],
    },
    "flash_attention_int8": {
        "kwt_flash_attention_int8": [_I, _P, _P, _P, _P, _P, _P, _P, _I, _P],
        "kwt_flash_attention_int8_nomax": [_I, _P, _P, _P, _P, _P, _P, _P, _I, _P],
    },
    "vpu_cal": {
        "kwt_vpu_cal": [_I, _P, _P, _I, _I, _I, _I, _P],
    },
}

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
_functions: dict[tuple[str, str], object] = {}


def source_path(name: str) -> str:
    return os.path.join(CSRC_DIR, f"{name}.cu")


def library_path(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in [source_path(name), *sorted(glob.glob(os.path.join(CSRC_DIR, "*.cuh")))]:
        with open(path, "rb") as f:
            h.update(f.read())
    digest = h.hexdigest()
    return os.path.join(BUILD_DIR, f"{name}-{digest[:12]}.so")


def nvcc_path() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(cuda_home, "bin", "nvcc")
    found = cand if os.path.exists(cand) else shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels build on a CUDA machine")
    return found


def build_all() -> dict[str, float]:
    """Compile every source whose library is missing, all in parallel.
    Returns seconds per compiled source; raises with nvcc's output if any
    build fails. The ptxas report (registers, spills) is kept beside each
    library as <name>.ptxas.txt."""
    todo = [n for n in SOURCES if not os.path.exists(library_path(n))]
    if not todo:
        return {}
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = nvcc_path()
    procs = {}
    t0 = time.perf_counter()
    for name in todo:
        tmp = library_path(name) + f".{os.getpid()}.tmp"
        procs[name] = (tmp, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", tmp, source_path(name)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        ))
    seconds, failures = {}, []
    for name, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        with open(os.path.join(BUILD_DIR, f"{name}.ptxas.txt"), "w") as f:
            f.write(log)
        if proc.returncode != 0:
            failures.append(f"--- nvcc {name}.cu (rc {proc.returncode}) ---\n{log}")
            continue
        os.replace(tmp, library_path(name))
    if failures:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failures))
    return seconds


def library(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, building the kernels first if
    any library is missing."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            if not os.path.exists(library_path(name)):
                build_all()
            lib = ctypes.CDLL(library_path(name))
            for fn, argtypes in SIGNATURES[name].items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = _I
            _libs[name] = lib
        return lib


def function(name: str, fn: str):
    """The ctypes entry point `fn` of csrc/<name>.cu, looked up once (the
    wrappers call it on every launch, so the lookup stays off that path)."""
    f = _functions.get((name, fn))
    if f is None:
        f = _functions[(name, fn)] = getattr(library(name), fn)
    return f


def stream_handle(device) -> int:
    """The raw handle of PyTorch's current stream on `device` (a
    torch.device or a card index), read without building a
    torch.cuda.Stream object."""
    import torch

    index = device if isinstance(device, int) else device.index
    return torch._C._cuda_getCurrentRawStream(
        torch.cuda.current_device() if index is None else index)
