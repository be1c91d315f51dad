"""Distillation training step: CE + temperature-scaled KL against the
teacher's logits, with the JAX package's semantics (train/distill.py):

  - loss = ce_weight * CE + kl_weight * KL(T) * T^2, the KL elementwise
    softmax(teacher/T) * (log softmax(teacher/T) - log softmax(student/T)),
    -100-masked, summed and divided by the number of valid positions;
  - a frozen encoder runs forward only, under torch.no_grad(); its
    parameters get requires_grad=False and the optimizer never sees them;
  - share_hidden_states: with a frozen encoder and equal d_model the
    teacher decoder reads the student's encoder output and the teacher's
    encoder never runs;
  - the teacher decoder runs without grad in the compute dtype;
  - microbatch accumulation takes the mean of the microbatches' gradients
    and metrics before one optimizer update;
  - the student decoder's layers are recomputed in the backward pass
    (remat, torch.utils.checkpoint).

Data parallel (make_train_step(data_group=)): each rank holds its rows of
every microbatch. The CE and KL token means run over the valid tokens of
the whole global microbatch, as the JAX step's loss over its global array
does: the ranks sum each microbatch's counts once before the step, each
rank's loss is its share of the global mean, and the gradients and
metrics are summed over the data group after the microbatches, before the
clip. Every rank then holds the global gradient, applies the same update
and reports the global loss. A tensor-parallel teacher (its shards over
the model group) runs inside distill_loss unchanged.

On the card every attention of the step runs through the hand kernels
(K1, K4 forward; K5 backward); on the CPU through their plain twins.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.distributed as dist

from kotoba_whisper_tpu_torch.core.device import check_model_device, resolve_device
from kotoba_whisper_tpu_torch.models import whisper
from kotoba_whisper_tpu_torch.models.whisper import WhisperForConditionalGeneration
from kotoba_whisper_tpu_torch.train.optim import ClippedAdamW, Schedule, all_reduce_grads_


@dataclass(frozen=True)
class DistillConfig:
    ce_weight: float = 0.8
    kl_weight: float = 1.0
    temperature: float = 2.0
    freeze_encoder: bool = True
    share_hidden_states: bool = True  # requires a frozen encoder + equal d_model
    num_microbatches: int = 1
    compute_dtype: torch.dtype = torch.bfloat16
    remat: bool = True


@dataclass
class TrainState:
    """The student (fp32 master weights), its optimizer and the number of
    updates applied. `make_train_step`'s step updates all three in place."""

    model: WhisperForConditionalGeneration
    optimizer: ClippedAdamW
    step: int = 0


def kl_divergence(student_logits, teacher_logits, labels, temperature: float,
                  count: torch.Tensor | None = None):
    """Masked token-mean KL(teacher || student) x T^2; `count` as in
    whisper.ce_loss."""
    t = temperature
    s = torch.log_softmax(student_logits.float() / t, dim=-1)
    tp = torch.log_softmax(teacher_logits.float() / t, dim=-1)
    per_elem = torch.exp(tp) * (tp - s)
    mask = (labels >= 0).float()
    per_tok = per_elem.sum(-1) * mask
    n = mask.sum() if count is None else count.float()
    return per_tok.sum() / n.clamp(min=1.0) * (t * t)


def sum_over_ranks(metrics: dict[str, torch.Tensor], group) -> dict[str, torch.Tensor]:
    """Each metric summed over the data group, in one collective (the
    ranks' shares of global means add up to the global values)."""
    keys = list(metrics)
    vals = torch.stack([torch.as_tensor(metrics[k], dtype=torch.float32) for k in keys])
    dist.all_reduce(vals, group=group)
    return dict(zip(keys, vals.unbind()))


def freeze_encoder_(model: WhisperForConditionalGeneration) -> None:
    for p in model.model.encoder.parameters():
        p.requires_grad_(False)


def distill_loss(
    student: WhisperForConditionalGeneration,
    teacher: WhisperForConditionalGeneration,
    dc: DistillConfig,
    batch: dict[str, torch.Tensor],
    counts: torch.Tensor | None = None,
):
    """-> (loss, {"ce_loss", "kl_loss"}), loss differentiable in the
    student. batch: input_features (B, mels, 3000), labels (B, T) with -100
    padding, decoder_input_ids (B, T), on the models' device. `counts`
    (2,): the global batch's CE and KL token counts (global_counts), for a
    rank's share of the global means."""
    feats, ids, labels = batch["input_features"], batch["decoder_input_ids"], batch["labels"]
    with torch.set_grad_enabled(torch.is_grad_enabled() and not dc.freeze_encoder):
        enc_out = whisper.encoder_forward(
            student, feats, compute_dtype=dc.compute_dtype, remat=dc.remat
        )
    student_logits = whisper.decoder_forward(
        student, ids, enc_out, compute_dtype=dc.compute_dtype, remat=dc.remat
    )
    ce_n, kl_n = (None, None) if counts is None else counts
    ce = whisper.ce_loss(student_logits, labels, ce_n)
    with torch.no_grad():
        if dc.share_hidden_states and dc.freeze_encoder:
            teacher_enc = enc_out
        else:
            teacher_enc = whisper.encoder_forward(teacher, feats, compute_dtype=dc.compute_dtype)
        teacher_logits = whisper.decoder_forward(
            teacher, ids, teacher_enc, compute_dtype=dc.compute_dtype
        )
    kl = kl_divergence(student_logits, teacher_logits, labels, dc.temperature, kl_n)
    loss = dc.ce_weight * ce + dc.kl_weight * kl
    return loss, {"ce_loss": ce.detach(), "kl_loss": kl.detach()}


def global_counts(parts: list[torch.Tensor], group) -> torch.Tensor:
    """(len(parts), 2) int64: each microbatch's CE (labels != -100) and KL
    (labels >= 0) token counts, summed over the data group in one
    collective."""
    counts = torch.stack([torch.stack([(p != -100).sum(), (p >= 0).sum()]) for p in parts])
    dist.all_reduce(counts, group=group)
    return counts


def make_train_step(dc: DistillConfig, sched: Schedule | None = None, *, device="cuda",
                    data_group=None):
    """-> step(state, teacher, batch) -> metrics.

    The step updates `state` in place (the JAX step donates its state):
    gradients of distill_loss (mean over `dc.num_microbatches` equal splits
    of the batch's leading dim), then one optimizer update, then
    state.step += 1. Metrics (0-dim tensors, on the device, not synced):
    loss, ce_loss, kl_loss, grad_norm (before clipping) and learning_rate
    (at the pre-increment step, a float). With `data_group` the batch is
    this rank's rows and the step is the global batch's (module doc)."""
    dev = resolve_device(device)

    def step(state: TrainState, teacher: WhisperForConditionalGeneration,
             batch: dict[str, torch.Tensor]) -> dict:
        check_model_device(state.model, dev)
        check_model_device(teacher, dev)
        mb = dc.num_microbatches
        n = next(iter(batch.values())).shape[0]
        if n % mb:
            raise ValueError(f"batch {n} does not split into {mb} microbatches")
        parts = [{k: v[i * n // mb:(i + 1) * n // mb].to(dev) for k, v in batch.items()}
                 for i in range(mb)]
        counts = ([None] * mb if data_group is None
                  else global_counts([p["labels"] for p in parts], data_group))
        totals = {"loss": 0.0, "ce_loss": 0.0, "kl_loss": 0.0}
        for part, cnt in zip(parts, counts):
            loss, metrics = distill_loss(state.model, teacher, dc, part, cnt)
            (loss / mb).backward()
            totals["loss"] = totals["loss"] + loss.detach()
            totals["ce_loss"] = totals["ce_loss"] + metrics["ce_loss"]
            totals["kl_loss"] = totals["kl_loss"] + metrics["kl_loss"]
        out = {k: v / mb for k, v in totals.items()}
        if data_group is not None:
            out = sum_over_ranks(out, data_group)
            all_reduce_grads_(state.optimizer.params, data_group)
        out["grad_norm"] = state.optimizer.step(state.step)
        if sched is not None:
            out["learning_rate"] = sched(state.step)
        state.step += 1
        return out

    return step
