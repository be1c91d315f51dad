"""Beam-search generation with a KV cache, lockstep over the batch.

The equivalent of HF `generate(num_beams=N)` as the JAX package's
decode/beam.py implements it, token for token. The contract:

- per-step scores are log_softmax of the RAW logits, with the logits rules
  applied to the log-probs afterwards (no renormalization over the
  unmasked set: HF applies its processors after log_softmax);
- top 2K candidates over the flattened (K*V) space; a candidate "hits
  stopping" when it emits <|endoftext|> or the sequence reaches max_length
  (HF's MaxLengthCriteria finalizes every candidate at the last step);
- only candidates ranked < K may enter the finished set, scored
  sum_logprobs / (generated_len ** length_penalty); the finished set keeps
  the best K by that score;
- stopping-hit candidates get -1e9 ADDED for the alive top K (HF's exact
  arithmetic, kept for tie parity);
- the early_stopping=False heuristic: once a row's best running score /
  ((cur_len - prompt_len) ** penalty) can no longer beat its worst
  finished score, the row stops accepting finished hypotheses, and the
  loop ends when every row is in that state.

Top-k selections run as `torch.sort(descending=True, stable=True)`: among
equal values the lower index comes first, as `jax.lax.top_k` orders them
(`torch.topk` promises no order among ties, and the finished set starts
as ties at -1e9).

Beams live in the batch axis, (B, K, ...) flattened to (B*K, ...) for the
model step. The cross K/V is built once per group and shared by its beams
(init_cache(beam_size=)); the beam reorder gathers the self-K/V rows only
(`index_select`). The loop reads one bool back to the host a step.
"""
from __future__ import annotations

import dataclasses

import torch

from kotoba_whisper_tpu_torch.core.config import SpecialTokens
from kotoba_whisper_tpu_torch.core.device import check_model_device, resolve_device
from kotoba_whisper_tpu_torch.decode.greedy import GenerateOptions
from kotoba_whisper_tpu_torch.decode.logits_rules import apply_rules
from kotoba_whisper_tpu_torch.models import whisper

NEG_INF = -1.0e9  # HF's exact sentinel (matters for tie and score parity)


def _top(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The k largest along the last axis, ties to the lower index."""
    values, index = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], index[..., :k]


def _gather_beams(x: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """x (B, K_old, L), index (B, K_new) -> (B, K_new, L)."""
    return torch.gather(x, 1, index[..., None].expand(-1, -1, x.shape[-1]))


@torch.inference_mode()
def generate_beam(
    model: whisper.WhisperForConditionalGeneration,
    input_features,
    opts: GenerateOptions,
    special: SpecialTokens,
    num_beams: int = 5,
    length_penalty: float = 1.0,
    *,
    kv_dtype: str = "compute",
    device="cuda",
) -> tuple[torch.Tensor, torch.Tensor]:
    """(B, n_mels, 3000) -> (tokens (B, max_length) int32, scores (B,) fp32).

    The best hypothesis per row (finished if any finished, else the best
    alive beam) with its length-penalized log-prob score."""
    dev = resolve_device(device)
    check_model_device(model, dev)
    feats = torch.as_tensor(input_features).to(dev)
    b, k = feats.shape[0], num_beams
    p, max_len = len(opts.prompt_ids), opts.max_length
    if not 1 <= p < max_len:
        raise ValueError(f"prompt length {p} must be in [1, max_length={max_len})")
    rc = opts.rule_config(special)
    eot = special.eot

    encoder_out = whisper.encoder_forward(model, feats)
    cache = whisper._init_cache(model, encoder_out, max_len, kv_dtype, beam_size=k)

    tokens = torch.full((b, k, max_len), model.cfg.pad_token_id, dtype=torch.long, device=dev)
    tokens[:, :, :p] = torch.tensor(opts.prompt_ids, dtype=torch.long, device=dev)
    if p > 1:
        _, cache = whisper._decode_step(model, tokens.reshape(b * k, max_len)[:, : p - 1], cache,
                                        beam_size=k)

    # only beam 0 is live at first (all beams are one hypothesis)
    alive_logp = torch.tensor([0.0] + [NEG_INF] * (k - 1), device=dev).repeat(b, 1)
    fin_tokens = torch.full_like(tokens, model.cfg.pad_token_id)
    fin_scores = torch.full((b, k), NEG_INF, device=dev)
    fin_exists = torch.zeros((b, k), dtype=torch.bool, device=dev)
    unsat = torch.ones(b, dtype=torch.bool, device=dev)  # early-stop heuristic unmet
    rank_ok = torch.arange(2 * k, device=dev)[None] < k   # candidates that may finish
    group_base = (torch.arange(b, device=dev) * k)[:, None]

    def length_pen(cur: int) -> torch.Tensor:
        # HF: generated length counts the tokens after the prompt, the
        # final one included
        return torch.tensor(float(max(cur + 1 - p, 1)), device=dev) ** length_penalty

    cur = p
    while cur < max_len and bool(unsat.any()):
        flat_tokens = tokens.reshape(b * k, max_len)
        logits, cache = whisper._decode_step(model, flat_tokens[:, cur - 1 : cur], cache,
                                             beam_size=k)
        logp_step = apply_rules(torch.log_softmax(logits[:, 0].float(), dim=-1),
                                flat_tokens, cur, rc)
        v = logp_step.shape[-1]
        logp = logp_step.reshape(b, k, v) + alive_logp[..., None]
        top_logp, top_idx = _top(logp.reshape(b, k * v), 2 * k)
        top_beam, top_tok = top_idx // v, top_idx % v

        cand_tokens = _gather_beams(tokens, top_beam)
        cand_tokens[:, :, cur] = top_tok
        hits = (top_tok == eot) | (cur + 1 >= max_len)

        # the finished set (HF _update_finished_beams)
        eligible = hits & rank_ok & unsat[:, None]
        cand_fin = torch.where(eligible, top_logp / length_pen(cur), NEG_INF)
        fin_scores, fin_idx = _top(torch.cat([fin_scores, cand_fin], dim=1), k)
        fin_tokens = _gather_beams(torch.cat([fin_tokens, cand_tokens], dim=1), fin_idx)
        fin_exists = torch.gather(torch.cat([fin_exists, eligible], dim=1), 1, fin_idx)

        # the alive set: HF adds -1e9 to stopping-hit candidates
        alive_logp, alive_idx = _top(top_logp + hits.float() * NEG_INF, k)
        tokens = _gather_beams(cand_tokens, alive_idx)
        beam_index = (torch.gather(top_beam, 1, alive_idx) + group_base).reshape(-1)
        cache = dataclasses.replace(cache, **{
            name: getattr(cache, name).index_select(1, beam_index)
            for name in ("self_k", "self_v", "self_k_scale", "self_v_scale")
            if getattr(cache, name) is not None})

        # early-stop heuristic (HF, early_stopping=False): the best running
        # score at the new length against the row's worst finished slot;
        # once met it stays met
        best_possible = alive_logp[:, 0] / length_pen(cur)
        worst = torch.where(fin_exists, fin_scores.amin(dim=1, keepdim=True), NEG_INF)
        unsat = unsat & (best_possible[:, None] > worst).any(dim=1)
        cur += 1

    # fin_scores is sorted: slot 0 is the best finished hypothesis; the alive
    # fallback covers a heuristic stop before anything finished
    any_fin = fin_exists.any(dim=1)
    best_alive = alive_logp.argmax(dim=1)
    rows = torch.arange(b, device=dev)
    out_tokens = torch.where(any_fin[:, None], fin_tokens[:, 0], tokens[rows, best_alive])
    out_scores = torch.where(any_fin, fin_scores[:, 0],
                             (alive_logp / length_pen(cur - 1))[rows, best_alive])
    return out_tokens.to(torch.int32), out_scores
