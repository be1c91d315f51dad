"""The port's experiment tools (kotoba_whisper_tpu_torch/tools/) on the CPU
at test-tiny: they run, print the JAX tools' JSON keys, and the fused
LayerNorm variant computes the baseline encoder (within 1e-6 in fp32).
On the card they are the timing harnesses; without one they raise.
k8_probe builds K8's source with clock stamps on the card only."""
import json

import numpy as np
import pytest
import torch

from kotoba_whisper_tpu_torch.tools import (
    enc_exp, k8_probe, kernel_time, stem_exp, step_time, vpu_cal,
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


@pytest.mark.parametrize("tool, argv", [(step_time, ["--self"]), (kernel_time, [])],
                         ids=["step_time-self", "kernel_time"])
def test_timing_tools_raise_without_a_card(monkeypatch, tool, argv):
    """K2's self-call timing and the kernel timing tool measure the card
    only: without one they raise before any work."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tool.main(argv)
