"""ASR pipeline: audio in, text (+ timestamped chunks) out.

Equivalent of HF `pipeline("automatic-speech-recognition",
chunk_length_s=15, batch_size=N)` as invoked at run_short_form_eval.py:
110-117, and of the JAX package's `AsrPipeline`: the long-form chunker
(decode/longform.py) hands every chunk of one input to `_generate` as one
batch, which collates each chunk to the model's 30 s context, computes the
log-mel (K3 on the card), and decodes greedy or beam (K1 in the encoder;
K2's prefix form at every step, its beam form with num_beams > 1).

The pipeline carries a model already on its device (`device`, the card
unless the caller asks for the CPU); on the CPU every kernel wrapper runs
its plain twin.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from kotoba_whisper_tpu_torch.core.config import FeatureConfig
from kotoba_whisper_tpu_torch.core.device import check_model_device, resolve_device
from kotoba_whisper_tpu_torch.data.collator import CollatorConfig, collate_audio
from kotoba_whisper_tpu_torch.decode.beam import generate_beam
from kotoba_whisper_tpu_torch.decode.greedy import GenerateOptions, generate_greedy
from kotoba_whisper_tpu_torch.decode.longform import ChunkingConfig, transcribe_long_form
from kotoba_whisper_tpu_torch.models.whisper import WhisperForConditionalGeneration
from kotoba_whisper_tpu_torch.ops.mel import log_mel_spectrogram
from kotoba_whisper_tpu_torch.tokenizer.whisper_tokenizer import WhisperTokenizer


@dataclass
class AsrPipeline:
    model: WhisperForConditionalGeneration
    tok: WhisperTokenizer
    language: str = "ja"
    task: str = "transcribe"
    chunk_length_s: float = 15.0
    num_beams: int = 1
    max_length: int = 128
    return_timestamps: bool = True
    suppress_tokens: tuple = ()
    begin_suppress_tokens: tuple = ()
    max_initial_timestamp_index: int = 50
    kv_dtype: str = "compute"
    # "int16": ship 16-bit PCM to the device and normalize there (K3 takes
    # either wire). Bit-identical to fp32 for PCM-sourced audio
    # (native/audio.cpp emits pcm/32768); synthetic float inputs are
    # quantized to the nearest PCM step.
    wire_dtype: str = "float32"
    device: str | torch.device = "cuda"

    def __post_init__(self):
        self.dev = resolve_device(self.device)
        check_model_device(self.model, self.dev)
        if self.wire_dtype not in ("float32", "int16"):
            raise ValueError(f"wire_dtype must be float32 or int16, got {self.wire_dtype!r}")
        self.feat = FeatureConfig(n_mels=self.model.cfg.num_mel_bins)
        self.chunking = ChunkingConfig(chunk_length_s=self.chunk_length_s)
        self.opts = GenerateOptions(
            prompt_ids=tuple(
                self.tok.sot_sequence(
                    self.language, self.task, timestamps=self.return_timestamps
                )
            ),
            max_length=self.max_length,
            return_timestamps=self.return_timestamps,
            suppress_tokens=tuple(self.suppress_tokens),
            begin_suppress_tokens=tuple(self.begin_suppress_tokens),
            max_initial_timestamp_index=self.max_initial_timestamp_index,
        )

    def _generate(self, batch_audio: np.ndarray) -> np.ndarray:
        # pad each 15 s chunk to the model's 30 s context
        audio = collate_audio(
            list(batch_audio), CollatorConfig(n_samples=self.feat.n_samples)
        )
        if self.wire_dtype == "int16":
            audio = np.clip(
                np.round(audio * 32768.0), -32768, 32767
            ).astype(np.int16)
        mel = log_mel_spectrogram(audio, self.feat, device=self.dev).to(self.model.dtype)
        if self.num_beams > 1:
            out, _ = generate_beam(
                self.model, mel, self.opts, self.tok.special, num_beams=self.num_beams,
                kv_dtype=self.kv_dtype, device=self.dev,
            )
        else:
            out = generate_greedy(
                self.model, mel, self.opts, self.tok.special, kv_dtype=self.kv_dtype,
                device=self.dev,
            )
        return out.cpu().numpy()

    def __call__(self, audio: np.ndarray) -> dict:
        return transcribe_long_form(
            audio, self.tok, self._generate, self.chunking,
            return_timestamps=self.return_timestamps,
        )

    def transcribe(self, audio: np.ndarray) -> str:
        return self(audio)["text"]
