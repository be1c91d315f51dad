"""Student-from-teacher initialisation with maximally spaced layer selection.

The student copies the teacher's non-layer weights and takes
`np.linspace(0, L-1, n)` of the teacher's layers for an n-layer stack
(decoder layers {0, 31} for 2 of 32), the create_student_model.py
semantics the JAX package reproduces.
"""
from __future__ import annotations

import re

import numpy as np
import torch

from kotoba_whisper_tpu_torch.core.config import WhisperConfig
from kotoba_whisper_tpu_torch.models.whisper import WhisperForConditionalGeneration

_LAYER = re.compile(r"^model\.(encoder|decoder)\.layers\.(\d+)\.(.+)$")


def spaced_layer_map(n_teacher: int, n_student: int) -> np.ndarray:
    """Maximally spaced teacher layer indices."""
    return np.linspace(0, n_teacher - 1, num=n_student, dtype=np.int64)


def init_student_from_teacher(
    teacher: WhisperForConditionalGeneration,
    teacher_cfg: WhisperConfig,
    *,
    encoder_layers: int | None = None,
    decoder_layers: int | None = None,
) -> tuple[WhisperForConditionalGeneration, WhisperConfig]:
    """-> (student, student_cfg) on the teacher's device and dtype. Every
    student tensor is a fresh copy, never a view of the teacher's: the
    student is trained in place while the teacher stays live."""
    enc_n = encoder_layers or teacher_cfg.encoder_layers
    dec_n = decoder_layers or teacher_cfg.decoder_layers
    student_cfg = teacher_cfg.replace(encoder_layers=enc_n, decoder_layers=dec_n)
    maps = {
        "encoder": spaced_layer_map(teacher_cfg.encoder_layers, enc_n),
        "decoder": spaced_layer_map(teacher_cfg.decoder_layers, dec_n),
    }
    teacher_sd = teacher.state_dict()
    sd = {}
    with torch.device("meta"):
        student = WhisperForConditionalGeneration(student_cfg)
    for name in student.state_dict():
        m = _LAYER.match(name)
        src = name
        if m:
            side, i, rest = m.groups()
            src = f"model.{side}.layers.{int(maps[side][int(i)])}.{rest}"
        sd[name] = teacher_sd[src].clone()
    student.load_state_dict(sd, strict=True, assign=True)
    return student.eval(), student_cfg
