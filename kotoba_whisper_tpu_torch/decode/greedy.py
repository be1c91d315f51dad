"""Lockstep greedy generation with a fixed-capacity KV cache.

Static shapes throughout: a (B, max_length) token buffer and KV cache,
the whole batch stepping together with a finished mask, and an early exit
once every row has emitted <|endoftext|>. The exit test reads one bool
back to the host per step. Timestamp/suppress rules come from
decode/logits_rules.py.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from kotoba_whisper_tpu_torch.core.config import SpecialTokens
from kotoba_whisper_tpu_torch.core.device import check_model_device, resolve_device
from kotoba_whisper_tpu_torch.decode.logits_rules import RuleConfig, apply_rules
from kotoba_whisper_tpu_torch.models import whisper


@dataclass(frozen=True)
class GenerateOptions:
    prompt_ids: tuple[int, ...]          # [sot, <|lang|>, <|task|>, (<|notimestamps|>)]
    max_length: int = 448
    return_timestamps: bool = True
    suppress_tokens: tuple[int, ...] = ()
    begin_suppress_tokens: tuple[int, ...] = ()
    max_initial_timestamp_index: int | None = 50
    detect_timestamp_from_logprob: bool = True

    def rule_config(self, st: SpecialTokens) -> RuleConfig:
        return RuleConfig(
            special=st,
            begin_index=len(self.prompt_ids),
            return_timestamps=self.return_timestamps,
            suppress_tokens=self.suppress_tokens,
            begin_suppress_tokens=self.begin_suppress_tokens,
            max_initial_timestamp_index=self.max_initial_timestamp_index,
            detect_timestamp_from_logprob=self.detect_timestamp_from_logprob,
        )


def transcribe_prompt(
    st: SpecialTokens, lang_id: int, task: str = "transcribe",
    timestamps: bool = True,
) -> tuple[int, ...]:
    """<|sot|><|lang|><|task|>[<|notimestamps|>]."""
    task_id = st.transcribe if task == "transcribe" else st.translate
    ids = [st.sot, lang_id, task_id]
    if not timestamps:
        ids.append(st.no_timestamps)
    return tuple(ids)


@torch.inference_mode()
def generate_greedy(
    model: whisper.WhisperForConditionalGeneration,
    input_features,
    opts: GenerateOptions,
    special: SpecialTokens,
    *,
    kv_dtype: str = "compute",
    stop_at: torch.Tensor | None = None,
    device="cuda",
) -> torch.Tensor:
    """(B, n_mels, 3000) -> (B, max_length) int32 token ids on `device`.

    Rows are [prompt..., generated..., eot, pad, pad, ...] with pad =
    cfg.pad_token_id. Every row decodes until all rows have finished or
    max_length is hit. `stop_at` (B,) optionally caps each row's total
    token count (the row is finished once it holds stop_at[i] tokens).
    """
    dev = resolve_device(device)
    check_model_device(model, dev)
    cfg = model.cfg
    feats = torch.as_tensor(input_features).to(dev)
    b = feats.shape[0]
    p = len(opts.prompt_ids)
    max_len = opts.max_length
    if not 1 <= p < max_len:
        raise ValueError(f"prompt length {p} must be in [1, max_length={max_len})")
    rc = opts.rule_config(special)
    pad, eot = cfg.pad_token_id, special.eot

    encoder_out = whisper.encoder_forward(model, feats)
    cache = whisper._init_cache(model, encoder_out, max_len, kv_dtype)

    tokens = torch.full((b, max_len), pad, dtype=torch.long, device=dev)
    tokens[:, :p] = torch.tensor(opts.prompt_ids, dtype=torch.long, device=dev)
    # Prefill all but the last prompt token; each step feeds
    # tokens[:, cur-1], so the logits at position cur-1 predict cur.
    if p > 1:
        _, cache = whisper._decode_step(model, tokens[:, : p - 1], cache)
    if stop_at is not None:
        stop_at = torch.as_tensor(stop_at).to(dev)

    finished = torch.zeros(b, dtype=torch.bool, device=dev)
    cur = p
    while cur < max_len and not bool(finished.all()):
        logits, cache = whisper._decode_step(model, tokens[:, cur - 1 : cur], cache)
        masked = apply_rules(logits[:, 0].float(), tokens, cur, rc)
        nxt = torch.argmax(masked, dim=-1)
        nxt = torch.where(finished, pad, nxt)
        tokens[:, cur] = nxt
        finished = finished | (nxt == eot)
        if stop_at is not None:
            finished = finished | (cur + 1 >= stop_at)
        cur += 1
    return tokens.to(torch.int32)
