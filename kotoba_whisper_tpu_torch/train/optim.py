"""Optimizer and LR schedule with the JAX package's optax semantics.

`make_optimizer` is optax.chain(clip_by_global_norm(max_grad_norm),
adamw(schedule, ...)) on torch.optim.AdamW:

  - weight decay only where `decay_mask` says (2-D+ weights and
    embeddings; not biases, LayerNorm or positional tables), as param
    groups;
  - the global-norm clip as optax writes it: g * max_norm / norm only when
    norm >= max_norm, with no epsilon (torch's clip_grad_norm_ adds 1e-6);
  - the schedule read at the pre-increment step count, so the first warmup
    step runs at lr 0, as optax does; Adam's bias correction counts the
    step itself.

Only parameters with requires_grad take part: a frozen encoder is never
seen by the optimizer and stays bit-identical. (optax would decay a frozen
encoder's weights when weight_decay > 0; the port does not.)
"""
from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist

Schedule = Callable[[int], float]


def decay_mask(model: torch.nn.Module) -> dict[str, bool]:
    """name -> True where weight decay applies (trainable parameters)."""
    return {
        name: p.ndim > 1 and "layer_norm" not in name and "embed_positions" not in name
        for name, p in model.named_parameters() if p.requires_grad
    }


def _linear(init: float, end: float, steps: int, count: int) -> float:
    """optax.linear_schedule: init -> end over `steps`, then held."""
    frac = 1.0 - min(max(count, 0), steps) / steps
    return (init - end) * frac + end


def lr_schedule(
    kind: str, lr: float, warmup_steps: int, total_steps: int | None = None
) -> Schedule:
    """optax.join_schedules of a linear warmup and a constant
    ("constant_with_warmup") or linear decay to 0 ("linear")."""
    warm = max(warmup_steps, 1)
    if kind == "constant_with_warmup":
        after = lambda c: lr
    elif kind == "linear":
        if total_steps is None:
            raise ValueError("the linear schedule needs total_steps")
        decay = max(total_steps - warmup_steps, 1)
        after = lambda c: _linear(lr, 0.0, decay, c)
    else:
        raise ValueError(kind)

    def sched(count: int) -> float:
        if count < warmup_steps:
            return _linear(0.0, lr, warm, count)
        return after(count - warmup_steps)

    return sched


@torch.no_grad()
def clip_by_global_norm_(params: list[torch.Tensor], max_norm: float) -> torch.Tensor:
    """Scale the gradients in place as optax.clip_by_global_norm does;
    returns the norm before clipping (fp32, 0-dim)."""
    grads = [p.grad for p in params if p.grad is not None]
    norm = torch.stack([g.float().square().sum() for g in grads]).sum().sqrt()
    # (g / norm) * max_norm where norm >= max_norm, else g (/ 1 * 1); no host sync
    keep = norm < max_norm
    div = torch.where(keep, torch.ones_like(norm), norm)
    mul = torch.where(keep, torch.ones_like(norm), torch.full_like(norm, max_norm))
    for g in grads:
        g.div_(div.to(g.dtype)).mul_(mul.to(g.dtype))
    return norm


@torch.no_grad()
def all_reduce_grads_(params: list[torch.Tensor], group) -> None:
    """Sum the gradients over a data group in place, in one flat collective
    (a parameter without a gradient counts as zeros)."""
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    flat = torch.cat([p.grad.reshape(-1) for p in params])
    dist.all_reduce(flat, group=group)
    offset = 0
    for p in params:
        n = p.grad.numel()
        p.grad.copy_(flat[offset:offset + n].view_as(p.grad))
        offset += n


class ClippedAdamW:
    """Global-norm clip, then AdamW at sched(count). `step` applies one
    update from the accumulated .grad of every trainable parameter and
    clears them."""

    def __init__(self, model: torch.nn.Module, sched: Schedule, *, max_grad_norm: float,
                 b1: float, b2: float, eps: float, weight_decay: float):
        mask = decay_mask(model)
        named = dict(model.named_parameters())
        groups = [
            {"params": [named[n] for n, d in mask.items() if d], "weight_decay": weight_decay},
            {"params": [named[n] for n, d in mask.items() if not d], "weight_decay": 0.0},
        ]
        self.params = [named[n] for n in mask]
        self.sched = sched
        self.max_grad_norm = max_grad_norm
        self.adamw = torch.optim.AdamW(
            [g for g in groups if g["params"]], lr=0.0, betas=(b1, b2), eps=eps,
        )

    def step(self, count: int) -> torch.Tensor:
        """One update at schedule step `count` (pre-increment); returns the
        gradient norm before clipping."""
        norm = clip_by_global_norm_(self.params, self.max_grad_norm)
        lr = self.sched(count)
        for group in self.adamw.param_groups:
            group["lr"] = lr
        self.adamw.step()
        self.adamw.zero_grad(set_to_none=True)
        return norm

    def state_dict(self) -> dict:
        return self.adamw.state_dict()

    def load_state_dict(self, sd: dict) -> None:
        self.adamw.load_state_dict(sd)


def make_optimizer(
    model: torch.nn.Module,
    lr: float = 1e-4,
    warmup_steps: int = 500,
    schedule: str = "constant_with_warmup",
    total_steps: int | None = None,
    weight_decay: float = 0.0,
    max_grad_norm: float = 1.0,
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-8,
) -> tuple[ClippedAdamW, Schedule]:
    sched = lr_schedule(schedule, lr, warmup_steps, total_steps)
    opt = ClippedAdamW(model, sched, max_grad_norm=max_grad_norm, b1=b1, b2=b2,
                       eps=eps, weight_decay=weight_decay)
    return opt, sched
