"""Port's log-mel frontend (K3's plain twin on the CPU) vs the JAX frontend
and vs the JAX Pallas kernel run in interpret mode. Seeded numpy audio;
atol 1e-4 on the final features, the bound tests/test_mel.py uses between
the Pallas and XLA paths (fp32 sums in different orders)."""
import pathlib
import re

import numpy as np
import pytest
import torch

from kotoba_whisper_tpu.core.config import FeatureConfig as JaxFeatureConfig
from kotoba_whisper_tpu.ops import mel as jmel
from kotoba_whisper_tpu.ops.mel_pallas import log_mel_spectrogram_pallas
from kotoba_whisper_tpu_torch.core.config import FeatureConfig
from kotoba_whisper_tpu_torch.ops import mel as tmel


def _audio(seed, b=2):
    cfg = FeatureConfig()
    return (np.random.default_rng(seed).standard_normal((b, cfg.n_samples)) * 0.1).astype(np.float32)


@pytest.mark.parametrize("n_mels", [80, 128])
def test_filterbank_and_dft_tables_match_jax(n_mels):
    np.testing.assert_array_equal(
        tmel.mel_filterbank(201, n_mels, 16000, 0.0, 8000.0),
        jmel.mel_filterbank(201, n_mels, 16000, 0.0, 8000.0),
    )
    np.testing.assert_array_equal(tmel._dft_window_matrix(400), jmel._dft_window_matrix(400))


@pytest.mark.parametrize("n_mels", [80, 128])
def test_log_mel_matches_jax(n_mels):
    audio = _audio(n_mels)
    ref = np.asarray(jmel.log_mel_spectrogram(audio, JaxFeatureConfig(n_mels=n_mels)))
    got = tmel.log_mel_spectrogram(audio, FeatureConfig(n_mels=n_mels), device="cpu").numpy()
    assert got.shape == ref.shape == (2, n_mels, 3000)
    np.testing.assert_allclose(got, ref, atol=1e-4)


@pytest.mark.parametrize("n_mels", [80, 128])
def test_log_mel_matches_pallas_interpret(n_mels):
    audio = _audio(n_mels + 1, b=1)
    ref = np.asarray(log_mel_spectrogram_pallas(
        audio, JaxFeatureConfig(n_mels=n_mels), interpret=True
    ))
    got = tmel.log_mel_spectrogram(audio, FeatureConfig(n_mels=n_mels), device="cpu").numpy()
    np.testing.assert_allclose(got, ref, atol=1e-4)


def test_int16_wire_matches_jax_and_float_path():
    cfg = FeatureConfig(n_mels=128)
    pcm = np.random.default_rng(7).integers(-32768, 32768, (2, cfg.n_samples)).astype(np.int16)
    ref = np.asarray(jmel.log_mel_spectrogram(pcm, JaxFeatureConfig(n_mels=128)))
    got = tmel.log_mel_spectrogram(pcm, cfg, device="cpu").numpy()
    np.testing.assert_allclose(got, ref, atol=1e-4)
    f32 = tmel.log_mel_spectrogram(pcm.astype(np.float32) / 32768.0, cfg, device="cpu").numpy()
    np.testing.assert_array_equal(got, f32)


@pytest.mark.parametrize("n_mels", [80, 128])
def test_filter_ranges_cover_every_nonzero(n_mels):
    """K3 sums each mel over its [lo, hi) bin range only: the range must
    hold every nonzero of the filter (and here, nothing but nonzeros)."""
    fb = tmel.mel_filterbank(201, n_mels, 16000, 0.0, 8000.0)
    lo, hi = tmel.filter_ranges(fb)
    inside = np.zeros_like(fb, dtype=bool)
    for m in range(n_mels):
        inside[lo[m]:hi[m], m] = True
    np.testing.assert_array_equal(inside, fb != 0)
    lo0, hi0 = tmel.filter_ranges(np.zeros((201, 3), np.float32))
    assert (lo0 == hi0).all()


def test_kernel_table_layout():
    """K3's FFT table: the parts of FFT_TABLE_LAYOUT at the offsets
    csrc/mel.cu reads them from (kWin, kRadix, kTw2, kTw3, kSplit, kTable),
    complex parts as (re, im) pairs, with no dense DFT table among them."""
    t = tmel.fft_table(400)
    plan = tmel.fft_plan(400)
    src = (pathlib.Path(tmel.__file__).parent.parent / "csrc" / "mel.cu").read_text()
    consts = {k: int(v) for k, v in re.findall(r"\b(k\w+) = (\d+)", src)}
    kernel_names = {"window": "kWin", "radix": "kRadix", "tw2": "kTw2", "tw3": "kTw3",
                    "split": "kSplit"}
    off = 0
    for name, size in tmel.FFT_TABLE_LAYOUT:
        assert consts[kernel_names[name]] == off, name
        n_values = plan[name].size * (2 if np.iscomplexobj(plan[name]) else 1)
        assert n_values <= size and not t[off + n_values: off + size].any()
        off += size
    assert consts["kTable"] == off == t.size < 2000
    assert (consts["kMaxMels"], consts["kMaxWeights"]) == (tmel.MAX_MELS,
                                                          tmel.MAX_FILTER_WEIGHTS)


@pytest.mark.parametrize("n_mels", [80, 128])
def test_filter_weights_hold_the_filterbank(n_mels):
    """K3's compact filterbank: each mel's run of weights, placed back at
    its bins from lo, rebuilds the dense filterbank exactly."""
    fb = tmel.mel_filterbank(201, n_mels, 16000, 0.0, 8000.0)
    w, lo, off = tmel.filter_weights(fb)
    assert w.shape == (tmel.MAX_FILTER_WEIGHTS,) and off.shape == (n_mels + 1,)
    dense = np.zeros_like(fb)
    for m in range(n_mels):
        run = w[off[m]:off[m + 1]]
        dense[lo[m]:lo[m] + run.size, m] = run
    np.testing.assert_array_equal(dense, fb)
    assert not w[off[-1]:].any()


def test_wrapper_takes_plain_twin_on_cpu():
    audio = torch.from_numpy(_audio(3, b=1))
    before = tmel.log_mel_frames.launches
    out = tmel.log_mel_frames(audio, FeatureConfig())
    torch.testing.assert_close(out, tmel.log_mel_frames_reference(audio, FeatureConfig()))
    assert tmel.log_mel_frames.launches == before
