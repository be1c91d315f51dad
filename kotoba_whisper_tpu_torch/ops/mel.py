"""Batched log-mel frontend (WhisperFeatureExtractor numerics).

16 kHz audio, n_fft=400 periodic Hann, hop=160, center reflect padding,
power spectrum, slaney-scale/slaney-norm mel filterbank (80 or 128 bins),
log10 with a 1e-10 floor, per-utterance clamp at max-8, then (x+4)/4.

The framing, DFT, power, mel projection and log10 run in one CUDA kernel
(csrc/mel.cu, K3) for tensors on the card; `log_mel_frames_reference` is
its plain PyTorch twin, used for CPU tensors and to check the kernel.
Both take fp32 audio or the int16 PCM wire (scaled by 1/32768 on device).
All products are fp32 (no TF32): the filterbank tables are built in
float64 with numpy and cast once.
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from kotoba_whisper_tpu_torch.core.config import FeatureConfig
from kotoba_whisper_tpu_torch.core.device import resolve_device
from kotoba_whisper_tpu_torch.ops import _build

_N_BINS_PAD = 208  # csrc/mel.cu kBinsPad


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


@lru_cache(maxsize=4)
def _kernel_table(n_fft: int) -> np.ndarray:
    """The kernel's DFT table: (n_fft, 2, 208) fp32, cos | sin rows with the
    bin axis zero-padded from 201 to 208 (padded bins give power 0)."""
    n_bins = n_fft // 2 + 1
    w = _dft_window_matrix(n_fft)
    t = np.zeros((n_fft, 2, _N_BINS_PAD), np.float32)
    t[:, 0, :n_bins] = w[:, :n_bins]
    t[:, 1, :n_bins] = w[:, n_bins:]
    return t


def filter_ranges(fb: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Each mel filter's nonzero bin range [lo, hi) of an (n_bins, n_mels)
    filterbank. Slaney filters are triangles, so the range holds every
    nonzero; an all-zero filter gets an empty range."""
    nz = fb != 0
    lo = np.where(nz.any(axis=0), nz.argmax(axis=0), 0)
    hi = np.where(nz.any(axis=0), fb.shape[0] - nz[::-1].argmax(axis=0), 0)
    return lo.astype(np.int32), hi.astype(np.int32)


@lru_cache(maxsize=8)
def _device_tables(cfg: FeatureConfig, device: str):
    """K3's DFT table, filterbank and filter ranges, uploaded once per
    (config, device)."""
    n_bins = cfg.n_fft // 2 + 1
    fb = mel_filterbank(n_bins, cfg.n_mels, cfg.sampling_rate, cfg.fmin, cfg.fmax)
    lo, hi = filter_ranges(fb)
    return tuple(
        torch.from_numpy(a).to(device)
        for a in (_kernel_table(cfg.n_fft), fb, lo, hi)
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
    table, fb, fb_lo, fb_hi = _device_tables(cfg, str(dev))
    out = torch.empty((b, n_frames, cfg.n_mels), dtype=torch.float32, device=dev)
    rc = _build.library("mel").kwt_log_mel(
        audio.data_ptr(), int(audio.dtype == torch.int16), table.data_ptr(),
        fb.data_ptr(), fb_lo.data_ptr(), fb_hi.data_ptr(), out.data_ptr(), b,
        n_samples, n_frames, cfg.n_mels, _build.stream_handle(dev),
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
