"""Distillation train-step throughput on the card, the counterpart of the
JAX package's tools/train_exp.py: the step of train/distill.make_train_step
(the frozen encoder shared with the teacher, the student decoder's
forward and backward, the teacher decoder's forward, the optimizer
update) at a batch size, remat setting and microbatch count, to find the
configuration with the most training audio-s/s.

The teacher is seeded random --preset weights in bf16 and the student its
--decoder_layers-layer copy (models/student_init, bf16 as in the JAX
tool), the encoder frozen; AdamW at lr 1e-4 (optax.adamw's defaults: no
warm-up, weight decay 1e-4; the port's optimizer also clips at norm 1).
The batch is the JAX tool's: seeded features (x 0.1, bf16), labels drawn
over the vocabulary with the second half -100, decoder inputs the labels
(pad for -100) rolled right by one.

Prints one JSON line {batch, remat, microbatches, ms_step (the best of
--trials steps, host clock, each ended by a device synchronise),
audio_s_per_s (batch x 30 s over it), compile_s (the first step: kernel
builds, library plans, the allocator), device}.

Usage: python -m kotoba_whisper_tpu_torch.tools.train_exp --batch 16
       [--label_len 128] [--no_remat] [--microbatches 1] [--trials 5]
       [--preset large-v3] [--decoder_layers 2] [--device cuda]
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from kotoba_whisper_tpu_torch.core.config import PRESETS
from kotoba_whisper_tpu_torch.core.device import resolve_device
from kotoba_whisper_tpu_torch.models import whisper
from kotoba_whisper_tpu_torch.models.student_init import init_student_from_teacher
from kotoba_whisper_tpu_torch.train import distill, optim
from kotoba_whisper_tpu_torch.tools.step_time import device_name, sync

CHUNK_S = 30.0


def build_student(teacher, cfg, decoder_layers: int):
    """The teacher's student (its dtype), the encoder frozen."""
    student, _ = init_student_from_teacher(teacher, cfg, decoder_layers=decoder_layers)
    distill.freeze_encoder_(student)
    return student


def make_batch(cfg, b: int, label_len: int, dev, seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, cfg.vocab_size, (b, label_len))
    labels[:, label_len // 2:] = -100
    ids = np.roll(np.where(labels == -100, cfg.pad_token_id, labels), 1, axis=1)
    feats = rng.standard_normal((b, cfg.num_mel_bins, 2 * cfg.max_source_positions)) * 0.1
    return {"input_features": torch.from_numpy(feats.astype(np.float32)).to(dev, torch.bfloat16),
            "labels": torch.from_numpy(labels).to(dev),
            "decoder_input_ids": torch.from_numpy(ids).to(dev)}


def run(teacher, student, batch: dict, *, remat=True, microbatches=1, trials=5) -> dict:
    """One step to warm up (compile_s), then the best of `trials` steps
    of `student` against `teacher` on `batch` -> the record. Trains
    `student` in place."""
    dev = next(student.parameters()).device
    opt, sched = optim.make_optimizer(student, lr=1e-4, warmup_steps=0, weight_decay=1e-4)
    dc = distill.DistillConfig(remat=remat, num_microbatches=microbatches)
    step = distill.make_train_step(dc, sched, device=dev)
    state = distill.TrainState(student, opt)
    sync(dev)
    t0 = time.perf_counter()
    step(state, teacher, batch)
    sync(dev)
    compile_s = time.perf_counter() - t0
    times = []
    for _ in range(trials):
        t0 = time.perf_counter()
        step(state, teacher, batch)
        sync(dev)
        times.append(time.perf_counter() - t0)
    dt = float(np.min(times))
    b = batch["labels"].shape[0]
    return {"batch": b, "remat": remat, "microbatches": microbatches, "ms_step": dt * 1e3,
            "audio_s_per_s": b * CHUNK_S / dt, "compile_s": compile_s,
            "device": device_name(dev)}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--label_len", type=int, default=128)
    ap.add_argument("--no_remat", action="store_true")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--trials", type=int, default=5)
    ap.add_argument("--preset", default="large-v3")
    ap.add_argument("--decoder_layers", type=int, default=2)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = PRESETS[args.preset]
    teacher = whisper.init_params(cfg, torch.Generator(device=dev).manual_seed(0), device=dev,
                                  dtype=torch.bfloat16).requires_grad_(False)
    student = build_student(teacher, cfg, args.decoder_layers)
    rec = run(teacher, student, make_batch(cfg, args.batch, args.label_len, dev),
              remat=not args.no_remat, microbatches=args.microbatches, trials=args.trials)
    print(json.dumps(rec), flush=True)
    return rec


if __name__ == "__main__":
    main()
