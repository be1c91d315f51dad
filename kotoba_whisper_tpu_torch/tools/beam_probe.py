"""K2's int4 beam form (csrc/decode_attention_beam.cu) on the card: what
its grid, its ring, its registers and each part of its per-tile chain
cost, in its full form (16-row tiles, a 16-stage ring: the route) and a
half form no path runs (rows 8-15 of the tile, which hold no beam at
K <= 8, dropped from Q, S, P and O; a ring of 4, 6 or 8 stages).

The beam source, without its fp32 form (which the probe does not run),
is built in variants, textual patches at fixed places (each must be found
once: a kernel edit that moves one makes this tool raise ValueError naming
it). Every variant first takes TWO_FORMS: the kernel templated on its
ring's stages and on the half form, `__launch_bounds__`' minimum named
kCtasPerSm, and a C entry `kwt_decode_attention_beam` with a `stages`
argument before kv_mode (16: the full form; 4, 6, 8: the half form). Then:
- "as_is" (registers for two CTAs an SM);
- "bounds3", "bounds4": asking registers for three or four CTAs an SM;
- knockouts, which compute wrong values and are timed only: "no_dequant"
  (K and V words reach the mma as they are, one shift for the LOP3 +
  bf16x2 FMA of each pair), "no_scales" (the producer's scale copies read
  nothing), "no_mma" (each m16n8k16 becomes one FADD of its operands'
  bits).
One nvcc process a variant, all started together, into build/beam_probe/
with ops/_build.py's nvcc flags (progress on stderr). Each variant runs
beam search's cross call (12 groups x 5 beams over T=1500, 20 heads, bf16
q, packed int4 K/V with bf16 per-head scales) in each form at 1, 2, 3, 4,
6 and 8 key shares (`beam_plan`'s splits), device ms from a replayed CUDA
graph; the unpatched variants are first held to the twin (max |err|
2e-3). One JSON line: by variant and form its registers and spill bytes
(ptxas) and ms by shares, with the card's name and power limit.

Usage: python -m kotoba_whisper_tpu_torch.tools.beam_probe
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys
import time

import torch

from kotoba_whisper_tpu_torch.models import whisper
from kotoba_whisper_tpu_torch.ops import _build
from kotoba_whisper_tpu_torch.ops import decode_attention as da
from kotoba_whisper_tpu_torch.tools.kernel_time import graph_ms

GROUPS, BEAMS, T, HEADS = 12, 5, 1500, 20
SHARES = (1, 2, 3, 4, 6, 8)
CHECKED = ("as_is", "bounds3", "bounds4")  # unpatched arithmetic
# (ring stages, half form): TWO_FORMS' entry picks the half form by its ring
FORMS = {"full": (16, False), "half_r4": (4, True), "half_r6": (6, True), "half_r8": (8, True)}

# The kernel in two forms: (old, new) in order, each old found once.
TWO_FORMS = (
    ("  static constexpr int kStages = 16, kRowBytes = 32, kHeadCols = 32;\n};\n",
     "  static constexpr int kStages = 16, kRowBytes = 32, kHeadCols = 32;\n};\n"
     "constexpr int kHalfRows = 8;  // the half form's most beams\n"
     "constexpr int kCtasPerSm = 2;  // __launch_bounds__' minimum\n"),
    ("template <typename KV>\nstruct __align__(1024) Smem {\n"
     "  static constexpr int kS = Mode<KV>::kStages;\n",
     "template <typename KV, int kS>\nstruct __align__(1024) Smem {\n"),
    ("__device__ __forceinline__ void ldsm_x4_trans(",
     "// d += a b over one m16n8k16 tile; kHalf: a's rows 8-15 are zero, so only\n"
     "// rows 0-7 (d[0], d[1]) are carried and rows 8-15's results dropped.\n"
     "template <bool kHalf>\n"
     "__device__ __forceinline__ void mma_tile(float* d, const uint32_t* a, uint32_t b0, "
     "uint32_t b1) {\n"
     "  if constexpr (kHalf) {\n"
     "    float x, y;\n"
     "    asm volatile(\n"
     "        \"mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
     "{%4, %5, %6, %7}, \"\n"
     "        \"{%8, %9}, {%0, %1, %10, %10};\\n\"\n"
     "        : \"+f\"(d[0]), \"+f\"(d[1]), \"=f\"(x), \"=f\"(y)\n"
     "        : \"r\"(a[0]), \"r\"(0u), \"r\"(a[2]), \"r\"(0u), \"r\"(b0), \"r\"(b1), "
     "\"f\"(0.f));\n"
     "  } else {\n"
     "    mma_bf16(d, a, b0, b1);\n"
     "  }\n"
     "}\n\n"
     "__device__ __forceinline__ void ldsm_x4_trans("),
    ("template <typename KV>\n__global__ void __launch_bounds__(kThreads, 2)\n",
     "template <typename KV, int kS, bool kHalf>\n"
     "__global__ void __launch_bounds__(kThreads, kCtasPerSm)\n"),
    ("  constexpr int kS = Mode<KV>::kStages;\n  constexpr int kRowBytes", "  constexpr int kRowBytes"),
    ("  Smem<KV>& s = *reinterpret_cast<Smem<KV>*>(", "  Smem<KV, kS>& s = *reinterpret_cast<Smem<KV, kS>*>("),
    ("    const bool upper = rows > 8;  // rows r + 8 hold beams\n",
     "    const bool upper = !kHalf && rows > 8;  // rows r + 8 hold beams\n"
     "    constexpr int kHalves = kHalf ? 1 : 2;   // 8-row halves that hold beams\n"),
    ("        uint4 lo = make_uint4(0, 0, 0, 0), hi = lo;\n        if (row < rows) {\n",
     "        uint4 lo = make_uint4(0, 0, 0, 0), hi = lo;\n"
     "        if ((!kHalf || half == 0) && row < rows) {\n"),
    ("mma_bf16(sc[nb], qa[ks], b[2 * ks], b[2 * ks + 1]);",
     "mma_tile<kHalf>(sc[nb], qa[ks], b[2 * ks], b[2 * ks + 1]);"),
    ("        for (int half = 0; half < 2; ++half) {\n          float& s0 = sc[nb][2 * half];\n",
     "        for (int half = 0; half < kHalves; ++half) {\n"
     "          float& s0 = sc[nb][2 * half];\n"),
    ("      for (int half = 0; half < 2; ++half) {\n        mx[half] = fmaxf(",
     "      for (int half = 0; half < kHalves; ++half) {\n        mx[half] = fmaxf("),
    ("        for (int half = 0; half < 2; ++half) {\n          if (half == 1 && !upper) {\n",
     "        for (int half = 0; half < kHalves; ++half) {\n"
     "          if (half == 1 && !upper) {\n"),
    ("      for (int half = 0; half < 2; ++half) l_run[half] = l_run[half] * corr[half] + sum[half];",
     "      for (int half = 0; half < kHalves; ++half)\n"
     "        l_run[half] = l_run[half] * corr[half] + sum[half];"),
    ("        oacc[nb][2] *= corr[1];\n        oacc[nb][3] *= corr[1];\n",
     "        if (!kHalf) {\n          oacc[nb][2] *= corr[1];\n"
     "          oacc[nb][3] *= corr[1];\n        }\n"),
    ("          pa[j][2 * odd + 1] = pack_bf16x2(",
     "          pa[j][2 * odd + 1] = kHalf ? 0u : pack_bf16x2("),
    ("mma_bf16(oacc[nb], pa[j], bv[nb][0], bv[nb][1]);",
     "mma_tile<kHalf>(oacc[nb], pa[j], bv[nb][0], bv[nb][1]);"),
    ("      l_run[half] += __shfl_xor_sync(0xffffffffu, l_run[half], 1);\n",
     "      if (kHalf && half == 1) {  // rows 8-15 hold no beam: no key seen\n"
     "        if (c == 0) {\n"
     "          s.m[warp][r + 8] = -INFINITY;\n"
     "          s.l[warp][r + 8] = 0.f;\n"
     "        }\n"
     "        continue;\n"
     "      }\n"
     "      l_run[half] += __shfl_xor_sync(0xffffffffu, l_run[half], 1);\n"),
    ("template <typename KV>\nint launch(",
     "template <typename KV, int kS = Mode<KV>::kStages, bool kHalf = false>\nint launch("),
    ("sizeof(Smem<KV>)", "sizeof(Smem<KV, kS>)"),
    ("        beam_kernel<KV>, cudaFuncAttributeMaxDynamicSharedMemorySize",
     "        beam_kernel<KV, kS, kHalf>, cudaFuncAttributeMaxDynamicSharedMemorySize"),
    ("      &cfg, beam_kernel<KV>, tk, tv,", "      &cfg, beam_kernel<KV, kS, kHalf>, tk, tv,"),
    ("                                         int kv_mode, void* stream) {",
     "                                         int stages, int kv_mode, void* stream) {"),
    ("      return launch<Int4>(card, q, qs, k, v, k_scale, v_scale, out, groups, t_len, n_heads,\n"
     "                          beams, splits, keys_per_split, kv_mode, s);\n",
     "#define KWT_BEAM(S, HALF)                                                                   \\\n"
     "  if (stages == S)                                                                          \\\n"
     "  return launch<Int4, S, HALF>(card, q, qs, k, v, k_scale, v_scale, out, groups, t_len,     \\\n"
     "                               n_heads, beams, splits, keys_per_split, kv_mode, s)\n"
     "      KWT_BEAM(16, false);\n"
     "      if (beams <= kHalfRows) {\n"
     "        KWT_BEAM(4, true);\n"
     "        KWT_BEAM(6, true);\n"
     "        KWT_BEAM(8, true);\n"
     "      }\n"
     "      break;\n"
     "#undef KWT_BEAM\n"),
)

_BOUNDS = "constexpr int kCtasPerSm = 2;"
_K_PAIRS = ("            b[2 * ks] = i4x2_bf16x2(u[ks >> 1], 2 * (ks & 1));\n"
            "            b[2 * ks + 1] = i4x2_bf16x2(u[ks >> 1], 2 * (ks & 1) + 1);\n")
_V_PAIRS = ("            bv[u][0] = i4x2_bf16x2(ab[u >> 2], u & 3);\n"
            "            bv[u][1] = i4x2_bf16x2(cd[u >> 2], u & 3);\n")
_SCALE_BYTES = "const int bytes = in ? (el + 1 < n_scales || (el & 1) ? 4 : 2) : 0;"
_S_MMA = "mma_tile<kHalf>(sc[nb], qa[ks], b[2 * ks], b[2 * ks + 1]);"
_PV_MMA = "mma_tile<kHalf>(oacc[nb], pa[j], bv[nb][0], bv[nb][1]);"

PATCHES = {
    "as_is": (),
    "bounds3": ((_BOUNDS, "constexpr int kCtasPerSm = 3;"),),
    "bounds4": ((_BOUNDS, "constexpr int kCtasPerSm = 4;"),),
    "no_dequant": (
        (_K_PAIRS, "            b[2 * ks] = u[ks >> 1] >> ks;\n"
                   "            b[2 * ks + 1] = u[ks >> 1] << ks;\n"),
        (_V_PAIRS, "            bv[u][0] = ab[u >> 2] >> u;\n"
                   "            bv[u][1] = cd[u >> 2] >> u;\n")),
    "no_scales": ((_SCALE_BYTES, "const int bytes = 0;"),),
    "no_mma": (
        (_S_MMA, "sc[nb][0] += __uint_as_float(qa[ks][0] ^ b[2 * ks] ^ b[2 * ks + 1]);"),
        (_PV_MMA, "oacc[nb][0] += __uint_as_float(pa[j][0] ^ bv[nb][0] ^ bv[nb][1]);")),
}
# the C entry of TWO_FORMS: the shipped one's arguments with `stages` before kv_mode
ENTRY_ARGTYPES = (_build.SIGNATURES["decode_attention_beam"]["kwt_decode_attention_beam"][:-2]
                  + [ctypes.c_int]
                  + _build.SIGNATURES["decode_attention_beam"]["kwt_decode_attention_beam"][-2:])


_F32_FORM = ("// ---- the fp32 form ---", "}  // namespace\n")
_F32_ENTRY = "// The fp32 form: q (G, K, H, 64) fp32"


def _replace_once(src: str, old: str, new: str) -> str:
    if src.count(old) != 1:
        raise ValueError(f"beam_probe: {old.strip()[:70]!r} is not in the beam source "
                         "exactly once")
    return src.replace(old, new)


def patched_source(src: str, variant: str) -> str:
    """The beam source without its fp32 form, in TWO_FORMS, with `variant`'s
    patches, each applied where its text is found exactly once."""
    for old in (*_F32_FORM, _F32_ENTRY):
        _replace_once(src, old, old)
    a, b = src.index(_F32_FORM[0]), src.index(_F32_FORM[1])
    src = src[:a] + src[b:src.index(_F32_ENTRY)]
    for old, new in (*TWO_FORMS, *PATCHES[variant]):
        src = _replace_once(src, old, new)
    return src


def _ptxas(log: str, stages: int, half: bool) -> dict:
    """Registers and spill bytes of beam_kernel<Int4, stages, half> in an
    nvcc -Xptxas -v log."""
    mangled = f"beam_kernelIN8kwt_sm904Int4ELi{stages}ELb{int(half)}E"
    lines = log.splitlines()
    for i, line in enumerate(lines):
        if "Compiling entry function" in line and mangled in line:
            text = " ".join(lines[i:i + 4])
            regs = re.search(r"Used (\d+) registers", text)
            spill = re.search(r"(\d+) bytes spill stores", text)
            return {"registers": int(regs.group(1)) if regs else None,
                    "spill_store_bytes": int(spill.group(1)) if spill else None}
    return {"registers": None, "spill_store_bytes": None}


def build(out_dir: str) -> dict:
    """Every variant's library, compiled in parallel -> {variant: (lib, ptxas log)}."""
    os.makedirs(out_dir, exist_ok=True)
    src = open(_build.source_path("decode_attention_beam")).read()
    procs = {}
    for variant in PATCHES:
        path = os.path.join(out_dir, f"{variant}.cu")
        with open(path, "w") as f:
            f.write(patched_source(src, variant))
        so = os.path.join(out_dir, f"{variant}.so")
        procs[variant] = (so, subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, "-I", _build.CSRC_DIR, "-o", so, path],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    t0 = time.perf_counter()
    for variant, (so, proc) in procs.items():
        log, _ = proc.communicate()
        print(f"beam_probe: built {variant} ({time.perf_counter() - t0:.1f} s)", file=sys.stderr,
              flush=True)
        if proc.returncode:
            raise RuntimeError(f"beam_probe: nvcc failed on {variant}:\n{log}")
        lib = ctypes.CDLL(os.path.abspath(so))
        lib.kwt_decode_attention_beam.argtypes = ENTRY_ARGTYPES
        libs[variant] = (lib, log)
    return libs


def _run(lib, log, variant, stages, half, tensors) -> dict:
    """One form of one variant: its registers and spill bytes, ms by shares
    (the unpatched variants first held to the twin)."""
    q, k, v, ks, vs, ref, out = tensors
    row = {**_ptxas(log, stages, half), "ms": {}}
    n_tiles = -(-T // da.BEAM_KEY_TILE)
    for shares in SHARES:
        per = -(-n_tiles // shares) * da.BEAM_KEY_TILE

        def call(per=per):
            rc = lib.kwt_decode_attention_beam(
                0, q.data_ptr(), q.stride(1), k.data_ptr(), v.data_ptr(), ks.data_ptr(),
                vs.data_ptr(), out.data_ptr(), GROUPS, T, HEADS, BEAMS, -(-T // per), per,
                stages, da.KV_INT4, torch.cuda.current_stream().cuda_stream)
            if rc:
                raise RuntimeError(f"beam_probe: {variant} launch failed, cudaError {rc}")
            return out

        if variant in CHECKED:
            call()
            torch.cuda.synchronize()
            err = float((out.float() - ref.float()).abs().max())
            if not err <= 2e-3:  # the card test's bound
                raise RuntimeError(f"beam_probe: {variant} is off the twin by {err}")
        row["ms"][f"s{shares}"] = graph_ms(call)
    return row


def main(argv=None) -> dict:
    argparse.ArgumentParser(description=__doc__,
                            formatter_class=argparse.RawDescriptionHelpFormatter).parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("beam_probe: no CUDA device; it measures the card")
    libs = build(os.path.join(os.path.dirname(_build.BUILD_DIR), "beam_probe"))
    g = torch.Generator(device="cuda").manual_seed(0)
    q = torch.randn(GROUPS, BEAMS, HEADS, 64, generator=g, device="cuda").to(torch.bfloat16)
    kv = []
    for _ in range(2):
        x = torch.randn(GROUPS, T, HEADS * 64, generator=g, device="cuda")
        codes, scale = whisper.quantize_kv_heads(x, HEADS, 4)
        kv.append((whisper.pack_int4(codes), scale))
    (k, ks), (v, vs) = kv
    ref = da.decode_attention_reference_beam(q, k, v, n_heads=HEADS, k_scale=ks, v_scale=vs)
    tensors = (q, k, v, ks, vs, ref, torch.empty_like(q))
    rec = {"variants": {}, "device": torch.cuda.get_device_name(0)}
    for variant, (lib, log) in libs.items():
        rec["variants"][variant] = {form: _run(lib, log, variant, stages, half, tensors)
                                    for form, (stages, half) in FORMS.items()}
        print(f"beam_probe: {variant} {rec['variants'][variant]}", file=sys.stderr, flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    rec["nvidia_smi"] = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else None
    print(json.dumps(rec), flush=True)
    return rec


if __name__ == "__main__":
    main()
