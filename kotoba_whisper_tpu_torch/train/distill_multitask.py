"""Bilingual / multi-task distillation (the v3 trainer), with the JAX
package's semantics (train/distill_multitask.py):

  - N datasets zipped a step, each with its own sub-batch;
  - per dataset the student encoder runs once and its hidden states serve
    every (task, language) decode of that audio; the teacher's encoder is
    the student's output when `share_hidden_states` holds (frozen encoder,
    equal widths), else its own pass, run only for a dataset with KL;
  - CE summed over the tasks; KL only for the datasets whose `use_kl` is
    set; loss = ce_weight x sum CE + kl_weight x sum KL;
  - metrics `ce_loss.{task}.{lang}` and `kl_loss.{task}.{lang}`, their
    totals `ce_loss` and `kl_loss`, then `loss`, `grad_norm` and
    `learning_rate`.

Batches: a sequence, one per dataset, of
  {"input_features": (B_i, mels, 3000),
   "tasks": {"transcribe.ja": {"labels", "decoder_input_ids"}, ...}}.

The step runs on train/distill.py's pieces: its `kl_divergence`, its
`TrainState` updated in place and its clipped AdamW. On the card the
attentions run through K1 and K4, their backward through K5.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import torch

from kotoba_whisper_tpu_torch.core.device import check_model_device, resolve_device
from kotoba_whisper_tpu_torch.models import whisper
from kotoba_whisper_tpu_torch.models.whisper import WhisperForConditionalGeneration
from kotoba_whisper_tpu_torch.train.distill import DistillConfig, TrainState, kl_divergence
from kotoba_whisper_tpu_torch.train.optim import Schedule


@dataclass(frozen=True)
class DatasetSpec:
    """One zipped dataset: its task keys ("{task}.{lang}") and KL flag."""

    name: str
    task_keys: tuple[str, ...]
    use_kl: bool = True


def multitask_loss(
    student: WhisperForConditionalGeneration,
    teacher: WhisperForConditionalGeneration,
    dc: DistillConfig,
    specs: Sequence[DatasetSpec],
    batches: Sequence[dict],
):
    """-> (loss, metrics), loss differentiable in the student; the metrics
    are detached 0-dim tensors."""
    total_ce = total_kl = torch.zeros((), device=next(student.parameters()).device)
    metrics: dict[str, torch.Tensor] = {}
    for spec, batch in zip(specs, batches):
        feats = batch["input_features"]
        with torch.set_grad_enabled(torch.is_grad_enabled() and not dc.freeze_encoder):
            enc_out = whisper.encoder_forward(
                student, feats, compute_dtype=dc.compute_dtype, remat=dc.remat
            )
        teacher_enc = None
        if dc.share_hidden_states and dc.freeze_encoder:
            teacher_enc = enc_out
        elif spec.use_kl:
            with torch.no_grad():
                teacher_enc = whisper.encoder_forward(teacher, feats,
                                                      compute_dtype=dc.compute_dtype)
        for key in spec.task_keys:
            tb = batch["tasks"][key]
            logits = whisper.decoder_forward(
                student, tb["decoder_input_ids"], enc_out,
                compute_dtype=dc.compute_dtype, remat=dc.remat,
            )
            ce = whisper.ce_loss(logits, tb["labels"])
            total_ce = total_ce + ce
            metrics[f"ce_loss.{key}"] = ce.detach()
            if spec.use_kl:
                with torch.no_grad():
                    t_logits = whisper.decoder_forward(
                        teacher, tb["decoder_input_ids"], teacher_enc,
                        compute_dtype=dc.compute_dtype,
                    )
                kl = kl_divergence(logits, t_logits, tb["labels"], dc.temperature)
                total_kl = total_kl + kl
                metrics[f"kl_loss.{key}"] = kl.detach()
    loss = dc.ce_weight * total_ce + dc.kl_weight * total_kl
    metrics["ce_loss"] = total_ce.detach()
    metrics["kl_loss"] = total_kl.detach()
    return loss, metrics


def make_multitask_train_step(dc: DistillConfig, specs: Sequence[DatasetSpec],
                              sched: Schedule | None = None, *, device="cuda"):
    """-> step(state, teacher, batches) -> metrics: the gradients of
    multitask_loss, one clipped AdamW update and state.step += 1, in place.
    Metrics are 0-dim tensors on the device (learning_rate a float)."""
    dev = resolve_device(device)

    def step(state: TrainState, teacher: WhisperForConditionalGeneration,
             batches: Sequence[dict]) -> dict:
        check_model_device(state.model, dev)
        check_model_device(teacher, dev)
        loss, metrics = multitask_loss(state.model, teacher, dc, specs, batches)
        loss.backward()
        metrics["loss"] = loss.detach()
        metrics["grad_norm"] = state.optimizer.step(state.step)
        if sched is not None:
            metrics["learning_rate"] = sched(state.step)
        state.step += 1
        return metrics

    return step
