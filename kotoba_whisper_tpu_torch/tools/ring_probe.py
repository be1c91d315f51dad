"""K2's ring kernel (csrc/decode_attention_ring.cu `ring_kernel`: the self
and ring calls over int8 and bf16 K/V) on the card: what its threads a CTA,
its heads a CTA and its per-head scale copies cost.

The ring source is built in variants, textual patches at fixed places
(each must be found once: a kernel edit that moves one makes this tool
raise ValueError naming it):
- "as_is": the shipped kernel (`kThreads` 256);
- "t128": 128 threads a CTA;
- "no_cap": `__launch_bounds__` without its CTAs an SM (no 64-register
  cap);
- "plain_words": the per-head scale words by plain 4-byte loads stored to
  shared memory before each thread's arrival on K's barrier, in place of
  the cp.asyncs counted there;
- knockouts of the per-head form, timed only (they compute wrong values):
  "no_scales" (the scale words are not copied), "no_halves" (each scale
  is read at use as the fp32 word at its head's index, no half picked).
One nvcc process a variant, all started together, into build/ring_probe/
with ops/_build.py's nvcc flags (progress on stderr). Each variant runs,
through its own C entry, at 1, 2 and 4 heads a CTA (RING_HEADS):
- "self_int8h", "self_int8": phase 4's self call (B=16 rows over a T=51
  cache, valid the int 51) over int8 with bf16 per-head scales (the int4
  cache's self K/V) and with fp32 row scales;
- "ring_int8h", "ring_int8": the stream's ring call (W=48 rows over a
  T=176 ring, ring_pos 40, valid lengths over [1, 176]) in the same two
  modes.
Device ms from a replayed CUDA graph (tools/kernel_time.py `graph_ms`);
the variants that keep the arithmetic are first held to the twin (max
|err| 2e-3, the card test's bound). One JSON line: by variant the
registers and spill bytes of the per-row and per-head int8 instantiations
(ptxas) and ms by row and heads, with the card's name and power limit.

Usage: python -m kotoba_whisper_tpu_torch.tools.ring_probe
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import torch

from kotoba_whisper_tpu_torch.ops import _build
from kotoba_whisper_tpu_torch.ops import decode_attention as da
from kotoba_whisper_tpu_torch.tools import kernel_time as kt
from kotoba_whisper_tpu_torch.tools.beam_probe import build_variants, nvidia_smi, ptxas
from kotoba_whisper_tpu_torch.tools.beam_probe import replace_once

THREADS = "constexpr int kThreads = 256;"
_BOUNDS = "__launch_bounds__(kThreads, 1024 / kThreads)"
_COPIES = ("      cp_async4(ks_s + slot * sw + e, ksg + src, bytes);\n"
           "      cp_async4(vs_s + slot * sw + e, vsg + src, bytes);\n")
_WORDS = ("      const uint16_t* k2 = reinterpret_cast<const uint16_t*>(ksg + src);\n"
          "      const uint16_t* v2 = reinterpret_cast<const uint16_t*>(vsg + src);\n"
          "      reinterpret_cast<uint32_t*>(ks_s)[slot * sw + e] =\n"
          "          bytes == 4 ? ksg[src] : bytes ? (uint32_t)k2[0] : 0u;\n"
          "      reinterpret_cast<uint32_t*>(vs_s)[slot * sw + e] =\n"
          "          bytes == 4 ? vsg[src] : bytes ? (uint32_t)v2[0] : 0u;\n")
_ARRIVE = "  cp_async_mbar_arrive_noinc(&bars[0]);\n"
_LOOP = "    for (int i = tid; i < valid * sw; i += kThreads) {"
_K_HALF = "        ksc = bf16_half(ks_w[slot * sw + ((par + hh) >> 1)], (par + hh) & 1);"
_V_HALF = "      vsc = bf16_half(vs_w[slot * sw + ((par + hv) >> 1)], (par + hv) & 1);"

PATCHES = {
    "as_is": (),
    "t128": ((THREADS, "constexpr int kThreads = 128;"),),
    "no_cap": ((_BOUNDS, "__launch_bounds__(kThreads)"),),
    "plain_words": (
        (_COPIES, _WORDS),
        (_ARRIVE, "  if (kHeads) mbar_arrive(&bars[0]);  // release: the stores are seen\n"
                  "  else cp_async_mbar_arrive_noinc(&bars[0]);\n")),
    "no_scales": ((_LOOP, "    for (int i = tid; i < 0; i += kThreads) {"),),
    "no_halves": ((_K_HALF, "        ksc = ks_s[slot * sw + hh];"),
                  (_V_HALF, "      vsc = vs_s[slot * sw + hv];")),
}
CHECKED = ("as_is", "t128", "no_cap", "plain_words")  # the shipped arithmetic
# row -> (rows, slots, per-head scales, ring_pos)
ROWS = {"self_int8h": (kt.SELF_ROWS, kt.SELF_T, True, None),
        "self_int8": (kt.SELF_ROWS, kt.SELF_T, False, None),
        "ring_int8h": (kt.STREAM_B, kt.RING_T, True, kt.RING_POS),
        "ring_int8": (kt.STREAM_B, kt.RING_T, False, kt.RING_POS)}
# ptxas's mangled names of the int8 instantiations (KV int8_t, kHeads)
KERNELS = {"int8h": "ring_kernelIaLb1E", "int8": "ring_kernelIaLb0E"}


def patched_source(src: str, variant: str) -> str:
    """The ring source with `variant`'s patches, each applied where its
    text is found exactly once."""
    for old in (THREADS, _BOUNDS, _COPIES, _ARRIVE, _LOOP, _K_HALF, _V_HALF):
        replace_once(src, old, old, "ring_probe")
    for old, new in PATCHES[variant]:
        src = replace_once(src, old, new, "ring_probe")
    return src


def _inputs() -> dict:
    """{row: (inputs of kernel_time's ring entry, the twin's output)}."""
    out = {}
    for name, (w, t, per_head, ring_pos) in ROWS.items():
        inputs = kt._ring_inputs(w, "int8h" if per_head else "int8", seed=94, t=t,
                                 ring_pos=ring_pos)
        q, k, v, ks, vs, valid, ring = inputs
        ref = da.decode_attention_reference(q, k, v, valid, n_heads=kt.HEADS, k_scale=ks,
                                            v_scale=vs, ring_pos=ring)
        out[name] = (inputs, ref)
    return out


def _run(lib, log, variant, rows) -> dict:
    """One variant: its registers and spill bytes, ms by row and heads (the
    variants that keep the arithmetic first held to the twin)."""
    rec = {**{mode: ptxas(log, name) for mode, name in KERNELS.items()}, "ms": {}}
    for name, (inputs, ref) in rows.items():
        for heads in da.RING_HEADS:
            call = kt._ring_entry(inputs, heads, lib.kwt_decode_attention_ring)
            if variant in CHECKED:
                out = call()
                torch.cuda.synchronize()
                err = float((out.float() - ref.float()).abs().max())
                if not err <= 2e-3:
                    raise RuntimeError(f"ring_probe: {variant} {name} h{heads} is off the twin "
                                       f"by {err}")
            rec["ms"][f"{name} h{heads}"] = kt.graph_ms(call)
    return rec


def main(argv=None) -> dict:
    argparse.ArgumentParser(description=__doc__,
                            formatter_class=argparse.RawDescriptionHelpFormatter).parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("ring_probe: no CUDA device; it measures the card")
    src = open(_build.source_path("decode_attention_ring")).read()
    libs = build_variants(os.path.join(os.path.dirname(_build.BUILD_DIR), "ring_probe"),
                          {variant: patched_source(src, variant) for variant in PATCHES},
                          "decode_attention_ring", "kwt_decode_attention_ring", "ring_probe")
    rows = _inputs()
    rec = {"variants": {}, "plans": {name: da.ring_plan(w, t, kt.HEADS, torch.int8,
                                                        da._n_sms(0), per_head=per_head).heads
                                     for name, (w, t, per_head, _) in ROWS.items()},
           "device": torch.cuda.get_device_name(0)}
    for variant, (lib, log) in libs.items():
        rec["variants"][variant] = _run(lib, log, variant, rows)
        print(f"ring_probe: {variant} {rec['variants'][variant]}", file=sys.stderr, flush=True)
    rec["nvidia_smi"] = nvidia_smi()
    print(json.dumps(rec), flush=True)
    return rec


if __name__ == "__main__":
    main()
