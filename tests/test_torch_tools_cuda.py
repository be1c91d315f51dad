"""The experiment tools' card paths (marked `cuda`: skipped without a card,
in the fixture; the file imports no JAX, so it runs where only the port is
installed).

- StreamConfig.prefetch / BeamStreamConfig.prefetch on the card: the next
  slice's encode queued behind a round that ended on its refill test, the
  round's state read back through pinned buffers and an event, give the
  same tokens (and beam scores) as prefetch off, on large-v3 widths
  (seeded random bf16 weights, fused, 4 + 4 layers), int8 KV: the greedy
  stream at tools/step_time.run_stream's settings over 96 windows, the
  beam stream at run_beam_stream's over 48, more than the initial fill
  takes (48 rows, 12 groups), and the KWT_STREAM_TRACE line counts
  prefetched refills with prefetch on and none off
  (tests/test_torch_prefetch.py holds both against the JAX package on the
  CPU).
- tools/matmul_cal's fp32 chain equals an fp64 reference within 1e-5
  rel-L2 with torch's TF32 switch on: models/whisper.exact_fp32 turns it
  off (TF32's 10-bit mantissa reads ~1e-3).

Run on a machine with an H100:
    python -m pytest tests/test_torch_tools_cuda.py -q
"""
import contextlib
import dataclasses
import io
import json

import numpy as np
import pytest
import torch

from kotoba_whisper_tpu_torch.core.config import PRESETS, FeatureConfig, SpecialTokens
from kotoba_whisper_tpu_torch.models import whisper
from kotoba_whisper_tpu_torch.models.optimized import fuse_for_inference
from kotoba_whisper_tpu_torch.tools import matmul_cal, step_time

pytestmark = pytest.mark.cuda

STREAM_WINDOWS, BEAM_STREAM_WINDOWS = 96, 48


@pytest.fixture(autouse=True)
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.fixture(scope="module")
def model():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cfg = PRESETS["large-v3"].replace(encoder_layers=4, decoder_layers=4)
    m = whisper.init_params(cfg, torch.Generator(device="cuda").manual_seed(0), device="cuda",
                            dtype=torch.bfloat16)
    return (fuse_for_inference(m), SpecialTokens.for_vocab(cfg.vocab_size),
            FeatureConfig(n_mels=cfg.num_mel_bins))


def traced(fn, monkeypatch):
    """fn() under KWT_STREAM_TRACE -> (its result, the trace line's record)."""
    monkeypatch.setenv("KWT_STREAM_TRACE", "1")
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        out = fn()
    lines = [line for line in err.getvalue().splitlines() if line.startswith("KWT_STREAM_TRACE ")]
    assert len(lines) == 1
    return out, json.loads(lines[0].split(" ", 1)[1])


def test_greedy_stream_prefetch_equals_off(model, monkeypatch):
    m, st, feat = model
    audio, _, stops, opts = step_time.stream_workload(st, feat)
    st_fixed = dataclasses.replace(st, eot=-1)
    out, trace = {}, {}
    for prefetch in (False, True):
        out[prefetch], trace[prefetch] = traced(lambda: step_time.run_stream(
            m, audio[:STREAM_WINDOWS], opts, st_fixed, stops, feat,
            stream=dataclasses.replace(step_time.STREAM, prefetch=prefetch)), monkeypatch)
    assert out[True].shape == (STREAM_WINDOWS, opts.max_length)
    np.testing.assert_array_equal(out[True], out[False])
    assert trace[False]["prefetched"] == 0 and trace[True]["prefetched"] > 0, trace


def test_beam_stream_prefetch_equals_off(model, monkeypatch):
    m, st, feat = model
    audio, _, stops, opts = step_time.beam_stream_workload(st, feat)
    out, trace = {}, {}
    for prefetch in (False, True):
        out[prefetch], trace[prefetch] = traced(lambda: step_time.run_beam_stream(
            m, audio[:BEAM_STREAM_WINDOWS], opts, st, stops, feat,
            stream=dataclasses.replace(step_time.BEAM_STREAM, prefetch=prefetch)), monkeypatch)
    np.testing.assert_array_equal(out[True][0], out[False][0])
    np.testing.assert_array_equal(out[True][1], out[False][1])
    assert np.isfinite(out[True][1]).all()
    assert trace[False]["prefetched"] == 0 and trace[True]["prefetched"] > 0, trace


def test_matmul_cal_float32_chain_is_exact_fp32():
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        x, w1, w2 = matmul_cal.make_operands(3000, 1280, torch.float32, torch.device("cuda"))
        got = matmul_cal.chain(x, w1, w2, 2).double()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
    ref = x.double()
    for _ in range(2):
        ref = ref @ w1.double() @ w2.double()
    rel = float((got - ref).norm() / ref.norm())
    assert rel <= 1e-5, rel
