"""K2's int4 beam form (csrc/decode_attention_beam.cu `beam_int4_kernel`:
keys as mma.sync's M, 8-beam tiles) on the card: what its warps, its CTAs
an SM, its ring, its key shares and each part of its per-tile chain cost.

The beam source, without its fp32 form (which the probe does not run),
is built in variants, textual patches at fixed places (each must be found
once: a kernel edit that moves one makes this tool raise ValueError naming
it):
- "as_is": the shipped kernel (`kInt4Warps`, `kInt4CtasPerSm`,
  `kInt4Stages` as they are);
- the sweep, SWEEP's (consumer warps, CTAs an SM that `__launch_bounds__`
  asks registers for, ring stages), e.g. "w4_c4" (4 warps, 4 CTAs an SM,
  an 8-stage ring);
- knockouts of the shipped kernel, which compute wrong values and are
  timed only: "no_dequant" (K and V words reach the mma as they are, one
  shift for the LOP3 + bf16x2 FMA of each pair), "no_scales" (the
  producer's scale copies read nothing), "no_mma" (each m16n8k16 becomes
  one FADD of its operands' bits).
One nvcc process a variant, all started together, into build/beam_probe/
with ops/_build.py's nvcc flags (progress on stderr). Each variant runs
beam search's cross call (12 groups x 5 beams over T=1500, 20 heads, bf16
q, packed int4 K/V with bf16 per-head scales) through the shipped C entry
at 1, 2, 3, 4, 6 and 8 key shares (`beam_plan`'s splits), device ms from a
replayed CUDA graph; the unpatched variants are first held to the twin
(max |err| 2e-3). One JSON line: by variant its registers and spill bytes
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
# the kernel's shape: (consumer warps, CTAs an SM, ring stages)
SHAPE = ("constexpr int kInt4Warps = {}, kInt4CtasPerSm = {}, kInt4Stages = {};"
         .format(da.BEAM_INT4_WARPS, da.BEAM_INT4_CTAS_PER_SM, da.BEAM_INT4_STAGES))
# the sweep's shapes, but the shipped one ("as_is")
SWEEP = {name: shape for name, shape in (
    ("w4_c2", (4, 2, 16)), ("w6_c2", (6, 2, 16)), ("w8_c2", (8, 2, 16)), ("w8_c2_s8", (8, 2, 8)),
    ("w8_c2_s20", (8, 2, 20)), ("w4_c3", (4, 3, 12)), ("w8_c3", (8, 3, 8)), ("w4_c4", (4, 4, 8)))
    if shape != (da.BEAM_INT4_WARPS, da.BEAM_INT4_CTAS_PER_SM, da.BEAM_INT4_STAGES)}

_K_PAIRS = ("            kp[hf][2 * ks] = i4x2_bf16x2(u[ks >> 1], 2 * (ks & 1));\n"
            "            kp[hf][2 * ks + 1] = i4x2_bf16x2(u[ks >> 1], 2 * (ks & 1) + 1);\n")
_V_PAIRS = ("          const uint32_t a[4] = {i4x2_bf16x2(ab[u0 >> 2], u0 & 3), "
            "i4x2_bf16x2(ab[u1 >> 2], u1 & 3),\n"
            "                                 i4x2_bf16x2(cd[u0 >> 2], u0 & 3), "
            "i4x2_bf16x2(cd[u1 >> 2], u1 & 3)};\n")
_SCALE_BYTES = "const int bytes = in ? (el + 1 < n_scales || (el & 1) ? 4 : 2) : 0;"
_S_MMA = "mma_bf16(sc[mb], a, qb[ks][0], qb[ks][1]);"
_PV_MMA = "mma_bf16(oacc[mb], a, pb[j][0], pb[j][1]);"

PATCHES = {
    "as_is": (),
    **{name: ((SHAPE, f"constexpr int kInt4Warps = {w}, kInt4CtasPerSm = {c}, "
                      f"kInt4Stages = {st};"),)
       for name, (w, c, st) in SWEEP.items()},
    "no_dequant": (
        (_K_PAIRS, "            kp[hf][2 * ks] = u[ks >> 1] >> ks;\n"
                   "            kp[hf][2 * ks + 1] = u[ks >> 1] << ks;\n"),
        (_V_PAIRS, "          const uint32_t a[4] = {ab[u0 >> 2] >> u0, ab[u1 >> 2] >> u1,\n"
                   "                                 cd[u0 >> 2] >> u0, cd[u1 >> 2] >> u1};\n")),
    "no_scales": ((_SCALE_BYTES, "const int bytes = 0;"),),
    "no_mma": (
        (_S_MMA, "sc[mb][0] += __uint_as_float(a[0] ^ qb[ks][0] ^ qb[ks][1]);"),
        (_PV_MMA, "oacc[mb][0] += __uint_as_float(a[0] ^ pb[j][0] ^ pb[j][1]);")),
}
CHECKED = ("as_is", *SWEEP)  # unpatched arithmetic

_F32_FORM = ("// ---- the fp32 form ---", "}  // namespace\n")
_F32_ENTRY = "// The fp32 form: q (G, K, H, 64) fp32"


def replace_once(src: str, old: str, new: str, tool: str = "beam_probe") -> str:
    if src.count(old) != 1:
        raise ValueError(f"{tool}: {old.strip()[:70]!r} is not in the source exactly once")
    return src.replace(old, new)


def patched_source(src: str, variant: str) -> str:
    """The beam source without its fp32 form, with `variant`'s patches, each
    applied where its text is found exactly once."""
    for old in (*_F32_FORM, _F32_ENTRY, SHAPE):
        replace_once(src, old, old)
    a, b = src.index(_F32_FORM[0]), src.index(_F32_FORM[1])
    src = src[:a] + src[b:src.index(_F32_ENTRY)]
    for old, new in PATCHES[variant]:
        src = replace_once(src, old, new)
    return src


def variant_shape(variant: str) -> tuple[int, int, int]:
    """(warps, CTAs an SM, stages) of the kernel a variant builds."""
    return SWEEP.get(variant, (da.BEAM_INT4_WARPS, da.BEAM_INT4_CTAS_PER_SM,
                               da.BEAM_INT4_STAGES))


def ptxas(log: str, kernel: str) -> dict:
    """Registers and spill bytes of the entry function whose mangled name
    holds `kernel` in an nvcc -Xptxas -v log."""
    lines = log.splitlines()
    for i, line in enumerate(lines):
        if "Compiling entry function" in line and kernel in line:
            text = " ".join(lines[i:i + 4])
            regs = re.search(r"Used (\d+) registers", text)
            spill = re.search(r"(\d+) bytes spill stores", text)
            return {"registers": int(regs.group(1)) if regs else None,
                    "spill_store_bytes": int(spill.group(1)) if spill else None}
    return {"registers": None, "spill_store_bytes": None}


def build_variants(out_dir: str, sources: dict, module: str, entry: str,
                   tool: str = "beam_probe") -> dict:
    """Each {variant: source} compiled by its own nvcc, all started together,
    into out_dir with ops/_build.py's flags -> {variant: (lib, ptxas log)},
    `entry` (of _build.SIGNATURES[module]) typed."""
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for variant, text in sources.items():
        path = os.path.join(out_dir, f"{variant}.cu")
        with open(path, "w") as f:
            f.write(text)
        so = os.path.join(out_dir, f"{variant}.so")
        procs[variant] = (so, subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, "-I", _build.CSRC_DIR, "-o", so, path],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    t0 = time.perf_counter()
    for variant, (so, proc) in procs.items():
        log, _ = proc.communicate()
        print(f"{tool}: built {variant} ({time.perf_counter() - t0:.1f} s)", file=sys.stderr,
              flush=True)
        if proc.returncode:
            raise RuntimeError(f"{tool}: nvcc failed on {variant}:\n{log}")
        lib = ctypes.CDLL(os.path.abspath(so))
        getattr(lib, entry).argtypes = _build.SIGNATURES[module][entry]
        libs[variant] = (lib, log)
    return libs


def nvidia_smi() -> str | None:
    """The card's name and power limit, as nvidia-smi gives them."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    return smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else None


def _run(lib, log, variant, tensors) -> dict:
    """One variant: its registers and spill bytes, ms by shares (the
    unpatched variants first held to the twin)."""
    q, k, v, ks, vs, ref, out = tensors
    row = {**ptxas(log, "beam_int4_kernel"), "ms": {}}
    n_tiles = -(-T // da.BEAM_KEY_TILE)
    for shares in SHARES:
        per = -(-n_tiles // shares) * da.BEAM_KEY_TILE

        def call(per=per):
            rc = lib.kwt_decode_attention_beam(
                0, q.data_ptr(), q.stride(1), k.data_ptr(), v.data_ptr(), ks.data_ptr(),
                vs.data_ptr(), out.data_ptr(), GROUPS, T, HEADS, BEAMS, -(-T // per), per,
                da.KV_INT4, torch.cuda.current_stream().cuda_stream)
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
    src = open(_build.source_path("decode_attention_beam")).read()
    libs = build_variants(os.path.join(os.path.dirname(_build.BUILD_DIR), "beam_probe"),
                          {variant: patched_source(src, variant) for variant in PATCHES},
                          "decode_attention_beam", "kwt_decode_attention_beam")
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
    rec = {"variants": {}, "shapes": {v: variant_shape(v) for v in PATCHES},
           "device": torch.cuda.get_device_name(0)}
    for variant, (lib, log) in libs.items():
        rec["variants"][variant] = _run(lib, log, variant, tensors)
        print(f"beam_probe: {variant} {rec['variants'][variant]}", file=sys.stderr, flush=True)
    rec["nvidia_smi"] = nvidia_smi()
    print(json.dumps(rec), flush=True)
    return rec


if __name__ == "__main__":
    main()
