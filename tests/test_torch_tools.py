"""The port's experiment tools (kotoba_whisper_tpu_torch/tools/) on the CPU
at test-tiny: they run, print the JAX tools' JSON keys, and the fused
LayerNorm variant computes the baseline encoder (within 1e-6 in fp32).
On the card they are the timing harnesses; without one they raise.
k8_probe builds K8's source with clock stamps on the card only."""
import json

import numpy as np
import pytest
import torch

from kotoba_whisper_tpu_torch.ops import _build
from kotoba_whisper_tpu_torch.ops import decode_attention as da
from kotoba_whisper_tpu_torch.tools import (
    beam_exp, beam_probe, dec_exp, enc_exp, k8_probe, kernel_time, matmul_cal, ring_probe,
    speed_decomp, stem_exp, step_time, stream_ab, stream_exp, train_exp, vpu_cal,
)

TINY = ["--preset", "test-tiny", "--batch", "2", "--device", "cpu"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny CPU tensors: one intra-op thread, so torch's thread pool does
    not spin-wait on cores the parallel test workers oversubscribe."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _lines(capsys):
    return [json.loads(line) for line in capsys.readouterr().out.splitlines() if line.strip()]


@pytest.mark.parametrize("variant, tol", [
    ("fused_ln", 1e-6), ("fused_ln_pallas", 1e-6), ("int8", None), ("baseline", 0.0),
])
def test_enc_exp_check(capsys, variant, tol):
    rec = enc_exp.main(["--variant", variant, "--check", "--dtype", "float32", *TINY])
    assert _lines(capsys) == [rec]
    assert set(rec) == {"variant", "max_abs_diff", "rel_l2"} and rec["variant"] == variant
    if tol is not None:
        assert rec["max_abs_diff"] <= tol
    else:  # w8a8 moves the encoder, but not far
        assert 0 < rec["rel_l2"] < 5e-2


@pytest.mark.parametrize("variant", ["fused_ln", "int8"])
def test_enc_exp_timing_line(capsys, variant):
    rec = enc_exp.main(["--variant", variant, "--trials", "1", *TINY])
    assert _lines(capsys) == [rec]
    assert {"variant", "batch", "ms_mean", "ms_min", "compile_s"} <= set(rec)
    assert rec["batch"] == 2 and rec["device"] == "cpu"


def test_stem_exp_runs(capsys):
    lines = stem_exp.main(["--trials", "1", *TINY])
    assert _lines(capsys) == lines
    names = [r["name"] for r in lines[:-1]]
    assert names == ["stem_conv", "stem_mm", "stem_mm3", "stem_ncw", "stem_pallas",
                     "stem_conv_nogelu", "stem_conv_tanhgelu", "conv2_only", "encoder"]
    assert all("tflops" in r for r in lines[:-1] if r["name"].startswith("stem"))
    share = lines[-1]
    assert {"stem_share_of_encoder_pct", "stem_mm_vs_conv", "mismatch_max", "batch"} <= set(share)
    assert share["mismatch_max"] < 0.05


def test_stem_exp_runs_in_fp32(capsys):
    """--dtype float32: every variant on an fp32 model (stem_pallas through
    K7's fp32 form on the card, its twin here), the two formulations as
    close as fp32 keeps them."""
    lines = stem_exp.main(["--trials", "1", "--dtype", "float32", *TINY])
    assert _lines(capsys) == lines
    share = lines[-1]
    assert share["dtype"] == "float32" and share["mismatch_max"] < 1e-4


def test_tools_raise_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for run in (lambda: enc_exp.main(["--variant", "baseline", "--preset", "test-tiny"]),
                lambda: stem_exp.main(["--preset", "test-tiny"]),
                lambda: vpu_cal.main(["--iters", "1"])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            run()


def test_beam_probe_patches_fit_the_beam_source():
    """Each of beam_probe's variants applies its patches once to the beam
    source without its fp32 form: the sweep's variants the int4 kernel's
    shape (consumer warps, CTAs an SM, ring stages), which the shipped
    source names as ops/decode_attention.py's BEAM_INT4_* do, the
    knockouts lines of `beam_int4_kernel` (the nibble conversions, the
    scale copies, the mma); every variant but "as_is" changes the source,
    no two alike, and the shipped shape is not swept twice; a patch whose
    text is gone raises."""
    src = open(_build.source_path("decode_attention_beam")).read()
    assert beam_probe.SHAPE in src and "beam_int4_kernel" in src
    base = beam_probe.patched_source(src, "as_is")
    assert "struct __align__(16) F32Smem" not in base and "kwt_decode_attention_beam(" in base
    shipped = (da.BEAM_INT4_WARPS, da.BEAM_INT4_CTAS_PER_SM, da.BEAM_INT4_STAGES)
    assert shipped not in beam_probe.SWEEP.values() and beam_probe.variant_shape("as_is") == shipped
    sources = {variant: beam_probe.patched_source(src, variant) for variant in beam_probe.PATCHES}
    assert len(set(sources.values())) == len(sources)
    for variant, text in sources.items():
        assert (text == base) == (variant == "as_is"), variant
        w, c, st = beam_probe.variant_shape(variant)
        assert (f"constexpr int kInt4Warps = {w}, kInt4CtasPerSm = {c}, kInt4Stages = {st};"
                in text), variant
    with pytest.raises(ValueError, match="exactly once"):
        beam_probe.patched_source(
            src.replace("mma_bf16(oacc[mb], a, pb[j][0], pb[j][1]);", ""), "no_mma")


def test_beam_probe_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        beam_probe.main([])


def test_ring_probe_patches_fit_the_ring_source():
    """Each of ring_probe's variants applies its patches once to the ring
    source: "t128" the ring CTA's threads (256 shipped, as RING_WARPS
    says), "no_cap" its launch bounds, "plain_words" the per-head scale copies and the arrival on K's
    barrier, "no_scales" the copy loop, "no_halves" the two reads of a
    scale at use; every variant but "as_is" changes the source, no two
    alike, and only the knockouts go unchecked; a patch whose text is gone
    raises."""
    src = open(_build.source_path("decode_attention_ring")).read()
    assert ring_probe.THREADS == f"constexpr int kThreads = {32 * da.RING_WARPS};"
    sources = {variant: ring_probe.patched_source(src, variant) for variant in ring_probe.PATCHES}
    assert sources["as_is"] == src and len(set(sources.values())) == len(sources)
    assert "constexpr int kThreads = 128;" in sources["t128"]
    assert "__launch_bounds__(kThreads)\n" in sources["no_cap"]
    assert "cp_async4(ks_s + slot * sw + e" not in sources["plain_words"]
    assert "mbar_arrive(&bars[0]);" in sources["plain_words"]
    assert "bf16_half(vs_w" not in sources["no_halves"]
    assert set(ring_probe.CHECKED) == set(ring_probe.PATCHES) - {"no_scales", "no_halves"}
    with pytest.raises(ValueError, match="exactly once"):
        ring_probe.patched_source(src.replace(ring_probe.THREADS, ""), "as_is")


def test_ring_probe_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ring_probe.main([])


def test_probe_ptxas_reads_the_named_entry():
    """The probes' ptxas reader takes the registers and spill bytes of the
    entry function whose mangled name holds the kernel's, and None where
    the log lacks it."""
    log = ("ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_111ring_kernelIaLb0EEvv' "
           "for 'sm_90a'\nptxas info    : Function properties for x\n"
           "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
           "ptxas info    : Used 40 registers\n"
           "ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_111ring_kernelIaLb1EEvv' "
           "for 'sm_90a'\nptxas info    : Function properties for y\n"
           "    8 bytes stack frame, 8 bytes spill stores, 8 bytes spill loads\n"
           "ptxas info    : Used 64 registers\n")
    assert beam_probe.ptxas(log, ring_probe.KERNELS["int8"]) == {
        "registers": 40, "spill_store_bytes": 0}
    assert beam_probe.ptxas(log, ring_probe.KERNELS["int8h"]) == {
        "registers": 64, "spill_store_bytes": 8}
    assert beam_probe.ptxas(log, "beam_int4_kernel") == {
        "registers": None, "spill_store_bytes": None}


def test_k8_probe_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        k8_probe.main([])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_step_time_budgets_are_bench_budgets(seed):
    """The stream's budgets (step_time.realistic_stops, which phase 4e of
    chip_smoke.py draws too) are bench.py's, draw for draw."""
    from bench import _realistic_stops

    for n, prompt_len in ((192, 4), (48, 4), (7, 3)):
        np.testing.assert_array_equal(
            step_time.realistic_stops(n, prompt_len, np.random.default_rng(seed)),
            _realistic_stops(n, prompt_len, np.random.default_rng(seed)))


def test_step_time_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        step_time.main([])


@pytest.mark.parametrize("tool, argv", [
    (step_time, ["--self"]), (kernel_time, []), (matmul_cal, []), (train_exp, []), (dec_exp, []),
    (beam_exp, []), (stream_exp, []), (stream_exp, ["--lockstep"]), (stream_ab, []),
    (stream_ab, ["--beam"]), (speed_decomp, [])],
    ids=["step_time-self", "kernel_time", "matmul_cal", "train_exp", "dec_exp", "beam_exp",
         "stream_exp", "stream_exp-lockstep", "stream_ab", "stream_ab-beam", "speed_decomp"])
def test_timing_tools_raise_without_a_card(monkeypatch, tool, argv):
    """K2's self-call timing, the kernel timing tool and the experiment
    tools measure the card unless asked for the CPU (--device cpu): without
    a card they raise before any work."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tool.main(argv)


_KERNEL_TIME_GROUPS = {
    "_self_rows": ["self_int8"],
    "_k2_cross_rows": ["k2_int4", "k2_int4_d640", "k2_int4_f32q", "k2_int8", "k2_int8_f32q",
                       "k2_int8_b48", "k2_bf16"],
    "_k1_f32_rows": ["k1_f32", "k1_f32_nomax", "k1_f32_cross", "k4_f32"],
    "_k5_rows": ["k5_f32_causal", "k5_f32_cross"],
    "_k7_f32_rows": ["k7_f32"],
    "_k8_rows": ["k8_f32_qk", "k8_f32_qk_nomax", "k8_f32_qkpv", "k8_f32_qkpv_nomax",
                 "k8_bf16_qk", "k8_bf16_qkpv"],
    "_beam_rows": ["beam_f32", "beam_f32_int8", "beam_f32_int4", "beam_bf16", "beam_bf16_int8",
                   "beam_bf16_int4"],
    "_ring_rows": ["ring_int8", "ring_int8h", "ring_bf16", "ring_int8_w60"],
    "_head_probe_rows": ["k2_int8_heads_bf16q", "k2_int8_heads_bf16q_b48"],
    "_ring_probe_rows": ["ring_int8_heads1", "ring_int8_w60_heads1"],
    "_k9_rows": ["k9_softmax", "k9_exp"]}


def _stub_kernel_time(monkeypatch):
    for fn, names in _KERNEL_TIME_GROUPS.items():
        monkeypatch.setattr(kernel_time, fn, lambda names=names: {n: None for n in names})
    monkeypatch.setattr(kernel_time, "graph_ms", lambda call: 0.0)
    monkeypatch.setattr(kernel_time, "host_us", lambda call: 0.0)
    monkeypatch.setattr(kernel_time, "kernel_split", lambda call: {})


def test_kernel_time_times_every_row(monkeypatch):
    """One run times every row group (K2's self, cross, beam and ring calls,
    K1/K4 fp32, K5 fp32, K7 fp32, K8, the probes, K9 last), each `reps`
    times;
    the rows' names are the ones two trees' records are compared by."""
    _stub_kernel_time(monkeypatch)
    rec = kernel_time.measure(2)
    assert list(rec) == [n for names in _KERNEL_TIME_GROUPS.values() for n in names]
    assert all(len(r["device_ms"]) == 2 for r in rec.values())


def _cpu_randn(monkeypatch):
    monkeypatch.setattr(kernel_time, "_randn",
                        lambda *shape, seed, dtype=torch.bfloat16: torch.randn(
                            *shape, generator=torch.Generator().manual_seed(seed)).to(dtype))


def test_kernel_time_k4_sweep_times_every_card_shape(monkeypatch):
    """--k4-sweep times K4's fp32 form (causal, fp32 q, k and v) once at
    each shape the card tests run it at, named B x Tq x Tk x H, the
    training decoder's first, each beside the wgmma probe on the same
    tensors, the probe held to the twin first; here on the twin."""
    _cpu_randn(monkeypatch)
    calls = []
    fwd = kernel_time.fa.flash_attention_fwd

    def spy(q, k, v, **kw):
        calls.append((tuple(q.shape), tuple(k.shape), q.dtype, kw))
        return fwd(q, k, v, **kw)

    probes = []

    def probe_call(fn, q, k, v):
        assert fn == "probe entry"
        probes.append((tuple(q.shape), tuple(k.shape)))
        return lambda: kernel_time.fa.flash_attention_reference(q, k, v, True)

    monkeypatch.setattr(kernel_time.fa, "flash_attention_fwd", spy)
    monkeypatch.setattr(kernel_time, "_k4_probe", lambda: "probe entry")
    monkeypatch.setattr(kernel_time, "_k4_probe_call", probe_call)
    monkeypatch.setattr(kernel_time, "graph_ms", lambda call: call() and 0.0)
    rec = kernel_time.k4_sweep()
    assert list(rec) == [f"{b}x{tq}x{tk}x{h}{probe}" for b, tq, tk, h in kernel_time.K4_SWEEP
                         for probe in ("", " wgmma_probe")]
    assert probes == [(q, k) for q, k, _, _ in calls]
    assert kernel_time.K4_SWEEP[0] == (8, 128, 128, 20)
    assert len(set(kernel_time.K4_SWEEP)) == len(kernel_time.K4_SWEEP)
    assert [(q, k) for q, k, _, _ in calls] == [((b, tq, h, 64), (b, tk, h, 64))
                                               for b, tq, tk, h in kernel_time.K4_SWEEP]
    assert all(dt == torch.float32 and kw == {"causal": True} for _, _, dt, kw in calls)


def test_kernel_time_k4_sweep_refuses_a_probe_off_the_twin(monkeypatch):
    """A probe whose output is off the twin stops the sweep before it is
    timed."""
    _cpu_randn(monkeypatch)

    def probe_call(fn, q, k, v):
        o, lse = kernel_time.fa.flash_attention_reference(q, k, v, True)
        return lambda: (o, lse + 1e-4)

    monkeypatch.setattr(kernel_time, "_k4_probe", lambda: None)
    monkeypatch.setattr(kernel_time, "_k4_probe_call", probe_call)
    monkeypatch.setattr(kernel_time, "K4_SWEEP", ((1, 65, 65, 1),))
    monkeypatch.setattr(kernel_time, "graph_ms", lambda call: 0.0)
    with pytest.raises(RuntimeError, match="1x65x65x1 is off the twin"):
        kernel_time.k4_sweep()


def test_k4_probe_patches_fit_the_f32_source():
    """Each of the K4 fp32 probe's patches applies once to
    csrc/flash_attention_f32.cu: the shipped source has no causal form of
    the non-causal kernel, the patched one masks its items, walks only
    their causal key tiles and routes a causal call to it."""
    src = open(_build.source_path("flash_attention_f32")).read()
    probe = kernel_time.k4_probe_source(src)
    for old, new in kernel_time.K4_PROBE_PATCHES:
        assert src.count(old) == 1 and probe.count(new) == 1
    assert "n_item" not in src and "if (false) {" not in src
    assert probe.count("causal_tiles(tq, tk, ") == src.count("causal_tiles(tq, tk, ") + 3
    with pytest.raises(ValueError, match="not in the source exactly once"):
        kernel_time.k4_probe_source(probe)


def test_kernel_time_k4_probe_call_takes_the_causal_plan(monkeypatch):
    """The probe's call passes the fp32 C entry the wrapper's causal plan
    (plan[4] == 1: the patched entry routes it to the non-causal kernel)
    and q, k, v, O and the LSE's addresses."""
    calls = []
    monkeypatch.setattr(kernel_time._build, "stream_handle", lambda card: 0)
    q, k, v = (torch.zeros(8, 128, 20, 64) for _ in range(3))
    call = kernel_time._k4_probe_call(lambda *args: calls.append(args) or 0, q, k, v)
    o, lse = call()
    (args,) = calls
    assert o.shape == (8, 128, 20, 64) and lse.shape == (8, 20, 128)
    assert args[1:6] == (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr())
    layout = (q.shape, q.stride())
    assert list(args[6]) == list(kernel_time.fa._f32_plan(layout, layout, layout, True)[1])
    assert list(args[6])[:5] == [8, 128, 128, 20, 1]


def test_kernel_time_k9_rows_run_the_tool_block(monkeypatch):
    """The K9 rows call the calibration wrapper at the JAX tool's block
    (512 x 1536 x 64), softmax and exp; here on the twin, at 2 iterations."""
    _cpu_randn(monkeypatch)
    monkeypatch.setattr(kernel_time, "K9_BLOCK", (512, 1536, 2))
    before = vpu_cal.vpu_cal.launches
    rows = kernel_time._k9_rows()
    assert list(rows) == ["k9_softmax", "k9_exp"]
    soft, exp = (call() for call in rows.values())
    assert soft.shape == exp.shape == (512, 2)
    torch.testing.assert_close(soft[:, 0], torch.full((512,), 2.0))
    assert bool((soft[:, 1] > 2.0).all()) and torch.equal(exp[:, 0], exp[:, 1])
    assert bool((exp[:, 0] > 1536).all()) and vpu_cal.vpu_cal.launches == before  # CPU: the twin


@pytest.mark.parametrize("name, short", [
    ("void (anonymous namespace)::bwd_tc_dq_kernel<false>(float const*, int, Layout)",
     "bwd_tc_dq_kernel<false>"),
    ("fmha_cutlassB_f32_aligned_64x64_k64_sm80(PyTorchMemEffAttention::AttentionBackwardKernel"
     "<cutlass::arch::Sm80, float, true>::Params)", "fmha_cutlassB_f32_aligned_64x64_k64_sm80"),
    ("void at::native::vectorized_elementwise_kernel<4, at::native::FillFunctor<float> >(int)",
     "vectorized_elementwise_kernel<4, at::native::FillFunctor<float> >"),
    ("Memset (Device)", "Memset"),
])
def test_kernel_time_short_kernel_names(name, short):
    """kernels_ms's kernel names: no return type, namespace or parameters."""
    assert kernel_time.short_kernel_name(name) == short


def _stub_head_entries(monkeypatch):
    """CPU tensors for the tool's inputs, a recording stub for the C
    entries and a graph_ms that calls once -> the list of entry calls."""
    calls = []

    def function(name, fn):
        def entry(*args):
            calls.append((fn, args))
            return 0
        return entry

    monkeypatch.setattr(kernel_time, "_randn",
                        lambda *shape, seed, dtype=torch.bfloat16: torch.randn(*shape).to(dtype))
    monkeypatch.setattr(kernel_time._build, "function", function)
    monkeypatch.setattr(kernel_time._build, "stream_handle", lambda card: 0)
    monkeypatch.setattr(kernel_time.da, "_n_sms", lambda card: 132)
    monkeypatch.setattr(kernel_time, "graph_ms", lambda call: call() is None or 0.0)
    return calls


def test_kernel_time_head_probe_takes_the_fp32_plan(monkeypatch):
    """The bf16-q probe rows call the head kernel's entry at B=16 and 48
    with the grid the plan gives fp32 q's int8 calls, bf16 q."""
    calls = _stub_head_entries(monkeypatch)
    rows = kernel_time._head_probe_rows()
    assert list(rows) == ["k2_int8_heads_bf16q", "k2_int8_heads_bf16q_b48"]
    for call in rows.values():
        call()
    for (fn, args), b in zip(calls, (16, 48)):
        plan = da.head_plan(b, 1500, 20, kv_dtype=torch.int8)
        assert fn == "kwt_decode_attention_heads"
        assert args[10:19] == (b, 1500, 20, plan.heads, plan.shares, plan.rows, da.KV_INT8, 0, 0)


def test_kernel_time_sweeps_name_every_grid(monkeypatch):
    """--sweep times the int8 head kernel by heads x shares at 20 and 10
    heads (every head count dividing H), each launch with the grid its name
    says, fp32 q, the shares covering T=1500."""
    calls = _stub_head_entries(monkeypatch)
    heads = kernel_time.head_sweep()
    assert len(heads) == 3 * 6 + 2 * 6
    for (fn, args), name in zip(calls, heads):
        n_heads, hg, shares, rows, mode, q_f32 = args[12:18]
        assert fn == "kwt_decode_attention_heads" and name == f"H{n_heads} h{hg} s{shares}"
        assert shares * rows >= 1500 > (shares - 1) * rows and (mode, q_f32) == (da.KV_INT8, 1)


def _ring_args(args):
    """(W, T, H, heads a CTA, K/V mode) of a ring entry call, whether it
    passed valid rows and whether a ring_pos."""
    return args[11:16], args[7] is not None, args[9] is not None


def test_kernel_time_ring_probe_takes_a_head_a_cta(monkeypatch):
    """The ring probe rows call the ring kernel's entry over int8 with fp32
    row scales at W=48 and 60 (T=176, per-row valid lengths, a ring_pos)
    on a CTA a (row, head)."""
    calls = _stub_head_entries(monkeypatch)
    rows = kernel_time._ring_probe_rows()
    assert list(rows) == ["ring_int8_heads1", "ring_int8_w60_heads1"]
    for call in rows.values():
        call()
    for (fn, args), w in zip(calls, (48, 60)):
        assert fn == "kwt_decode_attention_ring"
        assert _ring_args(args) == ((w, 176, 20, 1, da.KV_INT8), True, True)


def test_ring_probe_times_every_row_at_every_grid(monkeypatch):
    """A ring_probe variant times the self call (B=16, T=51, valid the int
    51, no valid rows or ring_pos) and the stream's ring call (W=48, T=176,
    valid rows, a ring_pos), each over int8 with per-head and with row
    scales, at every heads a CTA of RING_HEADS, through the variant's own C
    entry."""
    calls = _stub_head_entries(monkeypatch)

    class Lib:
        @staticmethod
        def kwt_decode_attention_ring(*args):
            calls.append(("variant", args))
            return 0

    rows = {name: (kernel_time._ring_inputs(w, "int8h" if per_head else "int8", t=t,
                                            ring_pos=ring_pos), None)
            for name, (w, t, per_head, ring_pos) in ring_probe.ROWS.items()}
    rec = ring_probe._run(Lib, "", "no_scales", rows)
    assert list(rec["ms"]) == [f"{name} h{h}" for name in ring_probe.ROWS for h in da.RING_HEADS]
    want = {"self_int8h": (16, 51, da.KV_INT8_HEADS, False),
            "self_int8": (16, 51, da.KV_INT8, False),
            "ring_int8h": (48, 176, da.KV_INT8_HEADS, True),
            "ring_int8": (48, 176, da.KV_INT8, True)}
    for (fn, args), name in zip(calls, rec["ms"]):
        row, heads = name.split(" h")
        w, t, mode, ring = want[row]
        assert fn == "variant"
        assert _ring_args(args) == ((w, t, 20, int(heads), mode), ring, ring)
        assert args[8] == (0 if ring else 51)
    assert len(calls) == len(rec["ms"])


def test_kernel_time_split_keeps_rows_of_several_kernels(monkeypatch):
    """Every run adds each row's device ms by kernel where a call launches
    more than one, and nothing where it launches one."""
    _stub_kernel_time(monkeypatch)
    names = [n for group in _KERNEL_TIME_GROUPS.values() for n in group]
    splits = {"k5_f32_cross": {"a": 0.1, "b": 0.2}, "k7_f32": {"c": 1.0}}
    calls = iter(names)
    monkeypatch.setattr(kernel_time, "kernel_split", lambda call: splits.get(next(calls), {}))
    rec = kernel_time.measure(1)
    assert rec["k5_f32_cross"]["kernels_ms"] == {"a": 0.1, "b": 0.2}
    assert [n for n in names if "kernels_ms" in rec[n]] == ["k5_f32_cross"]
