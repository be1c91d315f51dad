"""Whisper generation logits rules as batch-vectorized tensor functions.

The behaviour of the HF logits processors behind
`generate(..., return_timestamps=True)`:

  - suppress-token masks (global and at-begin),
  - timestamp rules: <|notimestamps|> suppressed; timestamps appear in
    pairs except directly before eot; timestamps monotonically
    non-decreasing; the first sampled token is a timestamp capped at
    max_initial_timestamp_index; if the total timestamp probability beats
    the best text token, a timestamp is forced.

No data-dependent Python control flow: every rule is a mask over (B, V),
so the function runs unchanged on the card and the CPU.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from kotoba_whisper_tpu_torch.core.config import SpecialTokens

NEG_INF = float("-inf")


@dataclass(frozen=True)
class RuleConfig:
    special: SpecialTokens
    begin_index: int                      # prompt/prefill length
    return_timestamps: bool = True
    suppress_tokens: tuple[int, ...] = ()
    begin_suppress_tokens: tuple[int, ...] = ()
    max_initial_timestamp_index: int | None = 50
    detect_timestamp_from_logprob: bool = True


def apply_rules(
    logits: torch.Tensor,   # (B, V) fp32
    tokens: torch.Tensor,   # (B, L) token buffer (prefill + generated so far)
    cur_len,                # int: valid tokens in buffer (lockstep), or (B,)
    rc: RuleConfig,
) -> torch.Tensor:
    """Masked logits for sampling position `cur_len` (0-based)."""
    b, v = logits.shape
    dev = logits.device
    st = rc.special
    vocab_ids = torch.arange(v, device=dev)
    cur = torch.as_tensor(cur_len, dtype=torch.long, device=dev)
    if cur.ndim == 0:
        cur = cur[None]
    cur_col = cur[:, None]  # (B, 1) or (1, 1): broadcasts over rows

    if rc.suppress_tokens:
        sup = torch.zeros(v, dtype=torch.bool, device=dev)
        sup[list(rc.suppress_tokens)] = True
        logits = logits.masked_fill(sup[None], NEG_INF)

    if rc.begin_suppress_tokens:
        bsup = torch.zeros(v, dtype=torch.bool, device=dev)
        bsup[list(rc.begin_suppress_tokens)] = True
        logits = logits.masked_fill((cur_col == rc.begin_index) & bsup[None], NEG_INF)

    if not rc.return_timestamps:
        return logits

    ts_begin = st.timestamp_begin
    logits = logits.clone()
    logits[:, st.no_timestamps] = NEG_INF

    n_sampled = cur - rc.begin_index  # tokens generated after the prompt
    last_tok = tokens.gather(1, torch.clamp(cur_col - 1, min=0).expand(b, 1))[:, 0]
    penult_tok = tokens.gather(1, torch.clamp(cur_col - 2, min=0).expand(b, 1))[:, 0]
    last_was_ts = (n_sampled >= 1) & (last_tok >= ts_begin)
    penult_was_ts = (n_sampled < 2) | (penult_tok >= ts_begin)

    is_ts_col = (vocab_ids >= ts_begin)[None]        # (1, V)
    is_text_lt_eot = (vocab_ids < st.eot)[None]

    # pairs rule
    logits = logits.masked_fill((last_was_ts & penult_was_ts)[:, None] & is_ts_col, NEG_INF)
    logits = logits.masked_fill(
        (last_was_ts & ~penult_was_ts)[:, None] & is_text_lt_eot, NEG_INF
    )

    # monotonicity: mask timestamps below the last one
    pos = torch.arange(tokens.shape[1], device=dev)[None]
    sampled_mask = (pos >= rc.begin_index) & (pos < cur_col)
    ts_mask = sampled_mask & (tokens >= ts_begin)
    any_ts = ts_mask.any(dim=1)
    last_ts_val = torch.where(ts_mask, tokens, torch.full_like(tokens, -1)).amax(dim=1)
    ts_last = torch.where(last_was_ts & ~penult_was_ts, last_ts_val, last_ts_val + 1)
    below_last = (vocab_ids[None] >= ts_begin) & (vocab_ids[None] < ts_last[:, None])
    logits = logits.masked_fill(any_ts[:, None] & below_last, NEG_INF)

    # first sampled token must be a timestamp, capped at the initial index
    at_begin = cur_col == rc.begin_index
    logits = logits.masked_fill(at_begin & (vocab_ids < ts_begin)[None], NEG_INF)
    if rc.max_initial_timestamp_index is not None:
        last_allowed = ts_begin + rc.max_initial_timestamp_index
        logits = logits.masked_fill(at_begin & (vocab_ids > last_allowed)[None], NEG_INF)

    # probability rule: logsumexp(timestamps) > max(text) => force timestamp
    if rc.detect_timestamp_from_logprob:
        logprobs = torch.log_softmax(logits, dim=-1)
        ts_lse = torch.logsumexp(logprobs.masked_fill(~is_ts_col, NEG_INF), dim=-1)
        max_text = logprobs.masked_fill(is_ts_col, NEG_INF).amax(dim=-1)
        force_ts = ts_lse > max_text
        logits = logits.masked_fill(force_ts[:, None] & ~is_ts_col, NEG_INF)

    return logits
