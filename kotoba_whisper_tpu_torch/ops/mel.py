"""Batched log-mel frontend (WhisperFeatureExtractor numerics).

16 kHz audio, n_fft=400 periodic Hann, hop=160, center reflect padding,
power spectrum, slaney-scale/slaney-norm mel filterbank (80 or 128 bins),
log10 with a 1e-10 floor, per-utterance clamp at max-8, then (x+4)/4.

The framing, DFT, power, mel projection and log10 run in one CUDA kernel
(csrc/mel.cu, K3) for tensors on the card; `log_mel_frames_reference` is
its plain PyTorch twin (the dense Hann-folded DFT as one fp32 product),
used for CPU tensors and to check the kernel. Both take fp32 audio or the
int16 PCM wire (scaled by 1/32768 on device). All arithmetic is fp32 (no
TF32). The kernel computes the DFT as an FFT whose plan lives here:
`fft_plan` builds its window, radix constants and twiddles in float64 with
numpy, `fft_table` rounds them once to the fp32 table the kernel reads,
and `fft_index_maps` spells out the index arithmetic of its stages.
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from kotoba_whisper_tpu_torch.core.config import FeatureConfig
from kotoba_whisper_tpu_torch.core.device import resolve_device
from kotoba_whisper_tpu_torch.ops import _build


def _hz_to_mel_slaney(freq):
    freq = np.asarray(freq, dtype=np.float64)
    f_sp = 200.0 / 3.0
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    mels = freq / f_sp
    return np.where(
        freq >= min_log_hz,
        min_log_mel + np.log(np.maximum(freq, min_log_hz) / min_log_hz) / logstep,
        mels,
    )


def _mel_to_hz_slaney(mels):
    mels = np.asarray(mels, dtype=np.float64)
    f_sp = 200.0 / 3.0
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    freqs = f_sp * mels
    return np.where(
        mels >= min_log_mel,
        min_log_hz * np.exp(logstep * (mels - min_log_mel)),
        freqs,
    )


@lru_cache(maxsize=8)
def mel_filterbank(
    n_freqs: int, n_mels: int, sampling_rate: int, fmin: float, fmax: float
) -> np.ndarray:
    """Triangular slaney-scale mel filterbank, slaney-normalized:
    (n_freqs, n_mels) float32."""
    fft_freqs = np.linspace(0.0, sampling_rate / 2.0, n_freqs)
    mel_min = _hz_to_mel_slaney(fmin)
    mel_max = _hz_to_mel_slaney(fmax)
    mel_pts = np.linspace(mel_min, mel_max, n_mels + 2)
    filter_freqs = _mel_to_hz_slaney(mel_pts)

    fdiff = np.diff(filter_freqs)
    slopes = filter_freqs[np.newaxis, :] - fft_freqs[:, np.newaxis]
    down = -slopes[:, :-2] / fdiff[:-1]
    up = slopes[:, 2:] / fdiff[1:]
    fb = np.maximum(0.0, np.minimum(down, up))

    enorm = 2.0 / (filter_freqs[2 : n_mels + 2] - filter_freqs[:n_mels])
    fb *= enorm[np.newaxis, :]
    return fb.astype(np.float32)


@lru_cache(maxsize=4)
def _dft_window_matrix(n_fft: int) -> np.ndarray:
    """Hann-windowed real-DFT matrix (n_fft, 2*(n_fft//2+1)) fp32: columns
    [0:n_bins] give Re(X_k), [n_bins:] give -Im(X_k) (only |X|^2 is used)."""
    n_bins = n_fft // 2 + 1
    n = np.arange(n_fft, dtype=np.float64)
    window = 0.5 * (1.0 - np.cos(2.0 * np.pi * n / n_fft))
    k = np.arange(n_bins, dtype=np.float64)
    ang = 2.0 * np.pi * np.outer(n, k) / n_fft
    w_re = np.cos(ang) * window[:, None]
    w_im = np.sin(ang) * window[:, None]
    return np.concatenate([w_re, w_im], axis=1).astype(np.float32)


# K3's FFT: the real n_fft-point DFT of a frame as an N = n_fft/2-point
# complex FFT of z[n] = w[2n] x[2n] + i w[2n+1] x[2n+1], in Stockham stages
# of (radix R, span Ns of the stages before it), then the real split
#   X[k] = (Z[k] + conj Z[N-k]) / 2 - i e^{-2 pi i k / n_fft} (Z[k] - conj Z[N-k]) / 2
# for k = 0..N (Z[N] = Z[0]). 200 = 8 * 5 * 5.
FFT_STAGES = ((8, 1), (5, 8), (5, 40))
# the fp32 table's parts, in order, and their lengths in floats; complex
# values are (re, im) pairs (csrc/mel.cu kWin, kRadix, kTw2, kTw3, kSplit)
FFT_TABLE_LAYOUT = (("window", 400), ("radix", 8), ("tw2", 64), ("tw3", 320), ("split", 402))
# the most mels and filter nonzeros K3's shared memory holds (csrc/mel.cu
# kMaxMels, kMaxWeights); slaney filters over 201 bins have at most 2 * 201
MAX_MELS, MAX_FILTER_WEIGHTS = 128, 512


@lru_cache(maxsize=4)
def fft_plan(n_fft: int = 400) -> dict[str, np.ndarray]:
    """K3's FFT plan in float64: the periodic Hann window (n_fft,); the
    radix constants [cos(pi/4), cos(2pi/5), sin(2pi/5), cos(4pi/5),
    sin(4pi/5)]; per stage after the first, the twiddles
    e^{-2 pi i t r / (Ns R)} as (R-1, Ns) complex for r = 1..R-1, t < Ns
    (t fastest, so neighbouring butterflies read neighbouring words); the
    split's e^{-2 pi i k / n_fft} for k = 0..n_fft/2."""
    n = n_fft // 2
    if np.prod([r for r, _ in FFT_STAGES]) != n:
        raise ValueError(f"K3's FFT stages are planned for n_fft=400, got {n_fft}")
    t = np.arange(n_fft, dtype=np.float64)
    plan = {
        "window": 0.5 * (1.0 - np.cos(2.0 * np.pi * t / n_fft)),
        "radix": np.array([np.cos(np.pi / 4), np.cos(2 * np.pi / 5), np.sin(2 * np.pi / 5),
                           np.cos(4 * np.pi / 5), np.sin(4 * np.pi / 5)]),
        "split": np.exp(-2j * np.pi * np.arange(n + 1) / n_fft),
    }
    for i, (r, ns) in enumerate(FFT_STAGES[1:], start=2):
        plan[f"tw{i}"] = np.exp(-2j * np.pi * np.outer(np.arange(1, r), np.arange(ns)) / (ns * r))
    return plan


def fft_index_maps(n: int = 200) -> list[tuple[np.ndarray, np.ndarray]]:
    """Per Stockham stage, the (N/R, R) indices butterfly j reads and writes:
    it reads j + r N/R, multiplies input r by the stage's twiddle of
    t = j mod Ns, takes the R-point DFT and writes output r to
    (j div Ns) Ns R + t + r Ns. The kernel computes the same indices."""
    maps = []
    for r, ns in FFT_STAGES:
        j = np.arange(n // r)[:, None]
        rr = np.arange(r)[None, :]
        maps.append((j + rr * (n // r), (j // ns) * ns * r + j % ns + rr * ns))
    return maps


@lru_cache(maxsize=4)
def fft_table(n_fft: int = 400) -> np.ndarray:
    """`fft_plan` rounded once to fp32 and packed as FFT_TABLE_LAYOUT says."""
    plan = fft_plan(n_fft)
    parts = []
    for name, size in FFT_TABLE_LAYOUT:
        a = plan[name]
        flat = np.stack([a.real, a.imag], -1).ravel() if np.iscomplexobj(a) else a
        part = np.zeros(size, np.float32)
        part[: flat.size] = flat.astype(np.float32)
        parts.append(part)
    return np.concatenate(parts)


def filter_ranges(fb: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Each mel filter's nonzero bin range [lo, hi) of an (n_bins, n_mels)
    filterbank. Slaney filters are triangles, so the range holds every
    nonzero; an all-zero filter gets an empty range."""
    nz = fb != 0
    lo = np.where(nz.any(axis=0), nz.argmax(axis=0), 0)
    hi = np.where(nz.any(axis=0), fb.shape[0] - nz[::-1].argmax(axis=0), 0)
    return lo.astype(np.int32), hi.astype(np.int32)


def filter_weights(fb: np.ndarray) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The filterbank as K3 keeps it in shared memory: each mel's weights
    over its [lo, hi) bin range, mel after mel, zero-padded to
    MAX_FILTER_WEIGHTS; each mel's first bin lo; and where each mel's run
    starts, (n_mels + 1,) with the total last."""
    lo, hi = filter_ranges(fb)
    runs = [fb[lo[m]:hi[m], m] for m in range(fb.shape[1])]
    offsets = np.concatenate([[0], np.cumsum([r.size for r in runs])]).astype(np.int32)
    if fb.shape[1] > MAX_MELS or offsets[-1] > MAX_FILTER_WEIGHTS:
        raise ValueError(f"K3 holds at most {MAX_MELS} mels and {MAX_FILTER_WEIGHTS} filter "
                         f"weights, got {fb.shape[1]} and {offsets[-1]}")
    weights = np.zeros(MAX_FILTER_WEIGHTS, np.float32)
    weights[: offsets[-1]] = np.concatenate(runs)
    return weights, lo, offsets


@lru_cache(maxsize=8)
def _device_tables(cfg: FeatureConfig, device: str):
    """K3's FFT table and compact filterbank (`filter_weights`), uploaded
    once per (config, device)."""
    n_bins = cfg.n_fft // 2 + 1
    fb = mel_filterbank(n_bins, cfg.n_mels, cfg.sampling_rate, cfg.fmin, cfg.fmax)
    return tuple(
        torch.from_numpy(a).to(device)
        for a in (fft_table(cfg.n_fft), *filter_weights(fb))
    )


def _audio_f32(audio: torch.Tensor) -> torch.Tensor:
    if audio.dtype == torch.int16:
        # int16 PCM wire: the /32768 that native/audio.cpp applies on host,
        # done on device; bit-identical for PCM-sourced audio
        return audio.to(torch.float32) * (1.0 / 32768.0)
    return audio.to(torch.float32)


def log_mel_frames_reference(audio: torch.Tensor, cfg: FeatureConfig) -> torch.Tensor:
    """Plain twin of K3: (B, n_samples) fp32/int16 -> (B, n_frames, n_mels)
    fp32 log10(max(mel, 1e-10)), before the per-utterance clamp. Runs its
    products in full fp32 (the caller keeps TF32 off on the card)."""
    n_fft, hop = cfg.n_fft, cfg.hop_length
    n_frames = audio.shape[-1] // hop  # HF drops the final centre frame
    x = _audio_f32(audio)
    x = torch.nn.functional.pad(x[:, None], (n_fft // 2, n_fft // 2), mode="reflect")[:, 0]
    frames = x.unfold(-1, n_fft, hop)[:, :n_frames]  # (B, F, n_fft)
    n_bins = n_fft // 2 + 1
    w = torch.from_numpy(_dft_window_matrix(n_fft)).to(audio.device)
    spec = frames @ w
    power = spec[..., :n_bins] ** 2 + spec[..., n_bins:] ** 2
    fb = torch.from_numpy(
        mel_filterbank(n_bins, cfg.n_mels, cfg.sampling_rate, cfg.fmin, cfg.fmax)
    ).to(audio.device)
    return torch.log10(torch.clamp(power @ fb, min=1e-10))


def log_mel_frames(audio: torch.Tensor, cfg: FeatureConfig) -> torch.Tensor:
    """K3 wrapper: the fused kernel for CUDA tensors, the plain twin for CPU
    tensors. Same contract as `log_mel_frames_reference`."""
    if audio.device.type == "cpu":
        return log_mel_frames_reference(audio, cfg)
    if audio.device.type != "cuda":
        raise ValueError(f"log_mel_frames: unsupported device {audio.device}")
    if audio.dtype not in (torch.float32, torch.int16):
        raise TypeError(f"log_mel_frames takes float32 or int16 audio, got {audio.dtype}")
    if audio.ndim != 2 or not audio.is_contiguous():
        raise ValueError("log_mel_frames takes contiguous (B, n_samples) audio")
    if (cfg.n_fft, cfg.hop_length) != (400, 160):
        raise ValueError("the K3 kernel is built for n_fft=400, hop=160")
    b, n_samples = audio.shape
    if n_samples < cfg.n_fft:
        raise ValueError(f"need at least {cfg.n_fft} samples, got {n_samples}")
    n_frames = n_samples // cfg.hop_length
    dev = audio.device
    table, fb_w, fb_lo, fb_off = _device_tables(cfg, str(dev))
    out = torch.empty((b, n_frames, cfg.n_mels), dtype=torch.float32, device=dev)
    card = audio.get_device()
    rc = _build.function("mel", "kwt_log_mel")(
        card, audio.data_ptr(), int(audio.dtype == torch.int16), table.data_ptr(),
        fb_w.data_ptr(), fb_lo.data_ptr(), fb_off.data_ptr(), out.data_ptr(), b,
        n_samples, n_frames, cfg.n_mels, _build.stream_handle(card),
    )
    if rc != 0:
        raise RuntimeError(f"K3 log-mel kernel launch failed: cudaError {rc}")
    log_mel_frames.launches += 1
    return out


log_mel_frames.launches = 0


def finish_log_mel(log_frames: torch.Tensor) -> torch.Tensor:
    """(B, F, M) raw log10 mel -> (B, M, F) features: per-utterance clamp at
    max-8, then (x+4)/4."""
    per_utt_max = torch.amax(log_frames, dim=(1, 2), keepdim=True)
    x = torch.maximum(log_frames, per_utt_max - 8.0)
    return ((x + 4.0) / 4.0).transpose(1, 2)


def pad_or_trim(audio: np.ndarray, n_samples: int) -> np.ndarray:
    """Host-side pad/trim to the 30 s window (feature_extractor.pad)."""
    t = audio.shape[-1]
    if t >= n_samples:
        return audio[..., :n_samples]
    pad = [(0, 0)] * (audio.ndim - 1) + [(0, n_samples - t)]
    return np.pad(audio, pad)


def log_mel_spectrogram(
    audio, cfg: FeatureConfig = FeatureConfig(), *, device="cuda"
) -> torch.Tensor:
    """(B, n_samples) fp32 or int16 audio -> (B, n_mels, n_frames) fp32
    log-mel, on `device` (the card unless the caller asks for the CPU).

    Expects audio already padded/trimmed to cfg.n_samples."""
    dev = resolve_device(device)
    audio = torch.as_tensor(audio).to(dev)
    if audio.ndim == 1:
        audio = audio[None]
    return finish_log_mel(log_mel_frames(audio.contiguous(), cfg))
