"""Batch collation with static shapes (host-side numpy).

Label sequences (stored with their <|startofprev|> prompt and <|sot|>
prefix) are padded to a fixed max_target_length, shifted right into
decoder_input_ids, pads masked to -100, and any prompt tokens up to and
including <|sot|> masked to -100 (the reference collator's bos_index
logic). Inputs are precomputed (n_mels, 3000) features stacked, or raw
audio padded to 30 s for on-device log-mel.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import numpy as np


@dataclass
class CollatorConfig:
    max_target_length: int = 128
    decoder_start_token_id: int = 50258  # <|sot|>
    pad_token_id: int = 50256
    n_samples: int = 480000  # 30 s @ 16 kHz


def collate_labels(
    label_ids: Sequence[Sequence[int]], cfg: CollatorConfig
) -> dict[str, np.ndarray]:
    """-> {"labels": (B, L) int32 with -100, "decoder_input_ids": (B, L)}"""
    b = len(label_ids)
    lmax = cfg.max_target_length
    padded = np.full((b, lmax + 1), cfg.pad_token_id, np.int32)
    mask = np.zeros((b, lmax + 1), bool)
    for i, ids in enumerate(label_ids):
        ids = list(ids)[: lmax + 1]
        padded[i, : len(ids)] = ids
        mask[i, : len(ids)] = True

    decoder_input_ids = padded[:, :-1].copy()
    labels = np.where(mask[:, 1:], padded[:, 1:], -100).astype(np.int32)

    # mask the prompt (everything up to and including <|sot|>)
    is_sot = labels == cfg.decoder_start_token_id
    bos_index = np.argmax(is_sot, axis=1)
    has_prompt = is_sot.any(axis=1) & (bos_index > 0)
    cutoff = np.where(has_prompt, bos_index + 1, 0)
    prompt_mask = np.arange(labels.shape[1])[None, :] < cutoff[:, None]
    labels = np.where(prompt_mask, -100, labels)
    return {"labels": labels, "decoder_input_ids": decoder_input_ids}


def collate_features(features: Sequence[np.ndarray]) -> np.ndarray:
    """Precomputed log-mel (n_mels, 3000) -> (B, n_mels, 3000) fp32."""
    return np.stack([np.asarray(f, np.float32) for f in features])


def collate_audio(
    audios: Sequence[np.ndarray], cfg: CollatorConfig
) -> np.ndarray:
    """Raw fp32 audio -> (B, n_samples), zero-padded/trimmed to 30 s."""
    out = np.zeros((len(audios), cfg.n_samples), np.float32)
    for i, a in enumerate(audios):
        n = min(len(a), cfg.n_samples)
        out[i, :n] = a[:n]
    return out
