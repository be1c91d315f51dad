"""K8 (csrc/flash_attention_int8.cu) on the card: where its consumer warps
spend their cycles.

The kernel is built with clock64() stamps in its consumer warpgroups,
textual patches at fixed lines of the source (each must be found once: a
kernel edit that moves one makes this tool raise ValueError naming it).
The stamped build is checked against the twin, then one run of the main
kernel per mode (qk, qkpv) at the encoder's shape (B=16, T=1500, 20
heads, D=64) prints the mean cycles per consumer warp in each phase of its
loop (STAMP_PHASES; the stamps themselves take some cycles), one JSON line
per mode with the card's name. The build goes to build/k8_probe/ with
ops/_build.py's nvcc flags.

Usage: python -m kotoba_whisper_tpu_torch.tools.k8_probe
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess

import numpy as np
import torch

from kotoba_whisper_tpu_torch.ops import _build
from kotoba_whisper_tpu_torch.ops import flash_attention as fa

BATCH, T, HEADS = 16, 1500, 20

# the buckets of the stamps: each gets the cycles since the stamp before it
STAMP_PHASES = (
    "item top (the previous epilogue)", "Q quantize", "pass 1 (qkpv)", "K/V full waits",
    "turn waits", "wgmma issue", "S wait", "dequantize + softmax", "P V wait",
    "last P V", "end", "tile 0, rescale + pack", "Q full wait",
)
_STAMP_DEFS = """
__device__ unsigned long long g_stamps[132 * 8][16];
#define KWT_STAMP(i) { const long long t_ = clock64(); st_acc[i] += t_ - t_last; t_last = t_; }
"""
_STAMP_ENTRY = """
extern "C" int kwt_k8_stamps(void* dst, int zero) {
  if (zero) {
    static unsigned long long z[132 * 8][16];
    return (int)cudaMemcpyToSymbol(g_stamps, z, sizeof(z));
  }
  return (int)cudaMemcpyFromSymbol(dst, g_stamps, sizeof(g_stamps));
}
"""


def _once(src, old, new):
    if src.count(old) != 1:
        raise ValueError(f"k8_probe: {old[:70]!r} is not in the kernel source exactly once")
    return src.replace(old, new)


def stamped_source(src):
    """The kernel source with KWT_STAMP(i) in the consumer loop (bucket i
    of STAMP_PHASES) and kwt_k8_stamps(dst, zero) to read or clear them."""
    s = _once(src, "namespace {\n\nusing namespace kwt_sm90;",
              "namespace {\n\nusing namespace kwt_sm90;" + _STAMP_DEFS)
    top = ("    uint32_t kc = 0, vc = 0, qi = 0;\n"
           "    for (int w = blockIdx.x; w < n_work; w += gridDim.x, ++qi) {\n")
    s = _once(s, top, "    unsigned long long st_acc[16] = {0};\n"
              "    long long t_last = clock64();\n" + top + "      KWT_STAMP(0);\n")
    s = _once(s, "      mbar_wait(&s.q_full[qs], (qi >> 1) & 1);\n",
              "      mbar_wait(&s.q_full[qs], (qi >> 1) & 1);\n      KWT_STAMP(12);\n")
    s = _once(s, "      mbar_arrive(&s.q_empty[qs]);\n",
              "      mbar_arrive(&s.q_empty[qs]);\n      KWT_STAMP(1);\n")
    s = _once(s, "          m_log2[r] = m_row[r] * kLog2e;\n        }\n      }\n",
              "          m_log2[r] = m_row[r] * kLog2e;\n        }\n      }\n      KWT_STAMP(2);\n")
    head = "      for (int j = 1; j < n_tiles; ++j, ++kc, ++vc) {\n"
    a = s.index(head)
    b = s.index("      {\n        const int vst = vc % kVStages;", a)
    loop = _once(s[a:b], head, head + "        KWT_STAMP(11);\n")
    loop = _once(loop, "        named_bar_sync(1 + c, kTurn);\n",
                 "        KWT_STAMP(3);\n        named_bar_sync(1 + c, kTurn);\n"
                 "        KWT_STAMP(4);\n")
    loop = _once(loop, "        named_bar_arrive(next_turn, kTurn);\n",
                 "        named_bar_arrive(next_turn, kTurn);\n        KWT_STAMP(5);\n")
    loop = _once(loop, "        fence_acc(si);\n", "        fence_acc(si);\n        KWT_STAMP(6);\n")
    loop = _once(loop, "        wgmma_wait<0>();\n        fence_acc(oacc);\n",
                 "        KWT_STAMP(7);\n        wgmma_wait<0>();\n        fence_acc(oacc);\n"
                 "        KWT_STAMP(8);\n")
    s = s[:a] + loop + s[b:]
    epilogue = "      // ---- epilogue: full row sums over the quad, normalise, store"
    s = _once(s, epilogue, "      KWT_STAMP(9);\n" + epilogue)
    s = _once(s, "    // the last consumer hands its last turn over too",
              "    KWT_STAMP(10);\n    if (lane == 0 && blockIdx.x < 132)\n"
              "      for (int i = 0; i < 16; ++i)\n"
              "        g_stamps[blockIdx.x * 8 + (threadIdx.x >> 5) - 4][i] = st_acc[i];\n"
              "    // the last consumer hands its last turn over too")
    return s + _STAMP_ENTRY


def _compile(src, out_dir):
    """The stamped source -> its loaded library."""
    os.makedirs(out_dir, exist_ok=True)
    path, so = os.path.join(out_dir, "stamps.cu"), os.path.join(out_dir, "stamps.so")
    with open(path, "w") as f:
        f.write(src)
    proc = subprocess.run(
        [_build.nvcc_path(), *_build.NVCC_FLAGS, "-I", _build.CSRC_DIR, "-o", so, path],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode:
        raise RuntimeError(f"k8_probe: nvcc failed:\n{proc.stdout}")
    lib = ctypes.CDLL(os.path.abspath(so))
    lib.kwt_flash_attention_int8.argtypes = (
        _build.SIGNATURES["flash_attention_int8"]["kwt_flash_attention_int8"])
    lib.kwt_k8_stamps.argtypes = [ctypes.c_void_p, ctypes.c_int]
    return lib


def main(argv=None):
    argparse.ArgumentParser(description=__doc__,
                            formatter_class=argparse.RawDescriptionHelpFormatter).parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("k8_probe: no CUDA device; it measures the card")
    src = open(_build.source_path("flash_attention_int8")).read()
    lib = _compile(stamped_source(src), os.path.join(os.path.dirname(_build.BUILD_DIR), "k8_probe"))
    card = torch.cuda.get_device_name(0)
    g = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = (torch.randn(BATCH, T, HEADS, 64, generator=g, device="cuda").to(torch.bfloat16)
               for _ in range(3))
    records = []
    for mode in ("qk", "qkpv"):
        pv8 = mode == "qkpv"
        meta, plan = fa._int8_plan((q.shape, q.stride()), (k.shape, k.stride()),
                                   (v.shape, v.stride()), pv8)
        k8, ks = fa.quantize_k_rows(k)
        v_in, vs = fa.quantize_v_cols(v) if pv8 else (v, None)
        ro, _ = fa.flash_attention_int8_reference(q, k8, ks, v_in, vs, pv8)
        scratch = torch.empty(meta[-1], dtype=torch.uint8, device="cuda")
        o = torch.empty_like(q)
        lse = torch.empty(BATCH, HEADS, T, device="cuda")

        def launch(phases):
            rc = lib.kwt_flash_attention_int8(
                q.get_device(), q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
                scratch.data_ptr(), plan, phases, torch.cuda.current_stream().cuda_stream)
            if rc:
                raise RuntimeError(f"k8_probe: launch failed, cudaError {rc}")

        launch(3)
        torch.cuda.synchronize()
        err = float((o.float() - ro.float()).abs().max())
        if not err < 5e-3:  # the card test's bound
            raise RuntimeError(f"k8_probe: the stamped {mode} build is off the twin by {err}")
        launch(2)  # warm
        lib.kwt_k8_stamps(None, 1)
        launch(2)
        torch.cuda.synchronize()
        buf = np.zeros((132 * 8, 16), dtype=np.uint64)
        lib.kwt_k8_stamps(buf.ctypes.data, 0)
        cyc = buf[:, :len(STAMP_PHASES)].astype(np.float64)
        total = cyc.sum(1)
        used = total > 0
        rec = {"mode": mode, "batch": BATCH, "t": T, "card": card, "max_abs_err": err,
               "cycles_per_warp": float(total[used].mean()),
               "share_pct": {p: float(100 * cyc[used, i].mean() / total[used].mean())
                             for i, p in enumerate(STAMP_PHASES)}}
        print(json.dumps(rec), flush=True)
        records.append(rec)
    return records


if __name__ == "__main__":
    main()
