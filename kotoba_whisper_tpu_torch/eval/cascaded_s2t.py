"""Cascaded speech-to-text translation pipeline.

Counterpart of misc/cascaded_s2t_translation/{ja,en}_cascaded_s2t_translation.py:
ASR on the source language, then text translation in postprocess (:21-48).
The reference binds NLLB through HF; here, as in the JAX package, the
translator is a pluggable callable: the port's NLLB model
(`make_nllb_translate_fn`), or an identity passthrough for ASR-only. The
ASR half is the port's decode/pipeline.AsrPipeline.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from kotoba_whisper_tpu_torch.decode.pipeline import AsrPipeline


@dataclass
class CascadedS2TPipeline:
    """transcribe(source lang) -> translate(text) — e.g. ja audio -> en text."""

    asr: AsrPipeline
    translate_fn: Callable[[str], str]
    source_lang: str = "ja"
    target_lang: str = "en"

    def __call__(self, audio: np.ndarray) -> dict:
        asr_out = self.asr(audio)
        translation = self.translate_fn(asr_out["text"])
        return {
            "text": translation,
            "source_text": asr_out["text"],
            "chunks": asr_out["chunks"],
            "source_lang": self.source_lang,
            "target_lang": self.target_lang,
        }

    def transcribe(self, audio: np.ndarray) -> str:
        return self(audio)["text"]


def source_ids(ids: list[int], pad_id: int) -> np.ndarray:
    """One source row, bucketed as the JAX package buckets it: width
    max(16, ceil16(len)), right-padded with pad_id."""
    width = max(16, (len(ids) + 15) // 16 * 16)
    src = np.full((1, width), pad_id, np.int64)
    src[0, : len(ids)] = ids
    return src


def make_nllb_translate_fn(
    checkpoint_dir: str,
    src_lang: str = "jpn_Jpan",
    tgt_lang: str = "eng_Latn",
    *,
    max_length: int = 128,
    compute_dtype: torch.dtype | None = None,
    device="cuda",
):
    """MT translator from an NLLB/M2M100 HF checkpoint dir (config.json +
    model.safetensors or pytorch_model.bin + tokenizer.json), the model the
    reference binds through HF (ja_cascaded_s2t_translation.py:45-48): the
    port's models/text_seq2seq.py greedy decode on `device` (the card
    unless the caller asks for the CPU) and tokenizer/unigram.py."""
    from kotoba_whisper_tpu_torch.core.device import resolve_device
    from kotoba_whisper_tpu_torch.models import text_seq2seq as ts
    from kotoba_whisper_tpu_torch.tokenizer.unigram import NllbTokenizer

    dev = resolve_device(device)
    model, cfg = ts.load_hf_checkpoint(checkpoint_dir)
    model = model.to(dev)
    tok = NllbTokenizer.from_pretrained_dir(checkpoint_dir)
    dtype = compute_dtype or torch.float32
    forced_bos = tok.lang_id(tgt_lang)

    def translate(text: str) -> str:
        src = source_ids(tok.encode(text, src_lang), cfg.pad_token_id)
        out = ts.generate_greedy_text(
            model, src, forced_bos=forced_bos, max_length=max_length,
            compute_dtype=dtype, device=dev,
        )
        return tok.decode(out[0].cpu().tolist())

    return translate
