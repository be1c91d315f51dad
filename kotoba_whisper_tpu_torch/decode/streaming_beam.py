"""Continuous-batching beam search (beam groups refilled across utterances).

Lockstep beam search (decode/beam.py) runs every batch until its slowest
row's search ends. This module lays each utterance's K beams on K
consecutive rows of a shared decode window of G groups (W = G * K rows)
and refills the groups that finish with freshly encoded utterances while
the others keep stepping, as the JAX package's decode/streaming_beam.py
does.

- The cross K/V is held once a group (init_cache(beam_size=)): a step's
  cross-attention is K2's beam form, each group's K queries over its one
  row. The self K/V has W rows. In the "ring" layout every row writes the
  shared ring slot each step and reads its `count` most recent slots (K2's
  ring form, as in decode/streaming.py); in the "scatter" layout each row
  writes at its own count and reads slots 0..count (K2's prefix form with
  per-row lengths), the lockstep slot order.
- A refill encodes E windows (K1), builds a pool cache of their cross K/V
  (quantized in int8 or int4 mode) and prefills the prompt's first p - 1 tokens
  over it for all K beams (plain attention, as decode/beam.py's prefill),
  then writes the cross rows into the first E free groups and the self
  prefix into their rows: at slots 0..p-2 ("scatter") or at the p - 1
  slots trailing the current ring slot ("ring").
- Each step is the lockstep beam body vectorized over groups at each
  group's own length: log_softmax before the rules, top 2K over K * V,
  the finished set of K with length-penalized scores, HF's -1e9 stopping
  arithmetic and the early_stopping=False heuristic. Groups that replay
  their prompt (a one-token prompt) or are done keep their bookkeeping; a
  done group's count is frozen, while its rows still write the ring slot,
  which the age mask hides once the group is refilled. After each step the
  self K/V rows (and their scales) are reordered by the block-diagonal
  beam permutation.
- `_steps` tests its round-end condition on the host before each step
  (one read-back a step, as decode/streaming.py does); the JAX package
  tests it on the device inside its while loop.
- `BeamStreamConfig.prefetch` queues the next pool slice's encode behind
  a round that ended on its refill test and the copies of its state to
  the host, as decode/streaming.py's does; KWT_STREAM_TRACE prints the
  same trace line.

Every group's step sequence is the lockstep algorithm's, so each
utterance's tokens and score are generate_beam's at its stop length.
"""
from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass

import numpy as np
import torch

from kotoba_whisper_tpu_torch.core.config import SpecialTokens
from kotoba_whisper_tpu_torch.core.device import check_model_device, resolve_device
from kotoba_whisper_tpu_torch.decode.beam import NEG_INF, _gather_beams, _top
from kotoba_whisper_tpu_torch.decode.greedy import GenerateOptions
from kotoba_whisper_tpu_torch.decode.logits_rules import apply_rules
from kotoba_whisper_tpu_torch.decode.streaming import (
    _empty_cache,
    _Feed,
    _first_free,
    _MelSource,
    _prompt_tokens,
    _read_back,
    _stop_lengths,
    _Trace,
)
from kotoba_whisper_tpu_torch.models import whisper

LAYOUTS = ("ring", "scatter")
_SELF = ("self_k", "self_v", "self_k_scale", "self_v_scale")
_CROSS = ("cross_k", "cross_v", "cross_k_scale", "cross_v_scale")


@dataclass(frozen=True)
class BeamStreamConfig:
    groups: int = 8            # utterance groups resident in the window (G)
    num_beams: int = 5         # K: the window has groups * num_beams rows
    encode_batch: int = 4      # utterances encoded per refill (E <= groups)
    steps_per_round: int = 64  # most decode steps between two host harvests
    length_penalty: float = 1.0
    prefetch: bool = False     # queue the next pool slice's encode behind
    # a round that ended on its refill test, as StreamConfig.prefetch (the
    # same tokens and scores)
    source_windows: int = 256  # mel windows on the card at once for a host
    # (numpy) source, as StreamConfig.source_windows
    layout: str = "ring"       # self K/V layout: "ring" (one shared slot a
    # step, K2's ring form) or "scatter" (each row at its own count, the
    # lockstep slot order)


@dataclass
class BeamStreamState:
    # per row (W = G * K)
    tokens: torch.Tensor      # (W, max_len) int64
    cache: whisper.KVCache    # length is the (W,) int32 per-row token count
    ring: torch.Tensor        # () int32: the next shared self-K/V write slot
    # per group (G,)
    alive_logp: torch.Tensor  # (G, K) running sum log-prob of each alive beam
    fin_tokens: torch.Tensor  # (G, K, max_len) int64
    fin_scores: torch.Tensor  # (G, K) fp32
    fin_exists: torch.Tensor  # (G, K) bool
    unsat: torch.Tensor       # (G,) bool: early-stop heuristic still unmet
    done: torch.Tensor        # (G,) bool: search ended (or never filled)
    active: torch.Tensor      # (G,) bool: holds an unharvested utterance
    stop: torch.Tensor        # (G,) int64: most total tokens of the group
    utt_id: torch.Tensor      # (G,) int64: stream index occupying the group


def _empty_state(model, opts: GenerateOptions, g: int, k: int, kv_dtype: str,
                 dev) -> BeamStreamState:
    """All-free window: every group done and inactive, counts 0, caches
    zeroed (int8 scales 1), the cross K/V one row a group."""
    pad = model.cfg.pad_token_id

    def fill(shape, value, dtype):
        return torch.full(shape, value, dtype=dtype, device=dev)

    return BeamStreamState(
        tokens=_prompt_tokens(opts, pad, g * k, dev),
        cache=_empty_cache(model, opts, g * k, g, kv_dtype, dev),
        ring=torch.zeros((), dtype=torch.int32, device=dev),
        alive_logp=fill((g, k), NEG_INF, torch.float32),
        fin_tokens=fill((g, k, opts.max_length), pad, torch.long),
        fin_scores=fill((g, k), NEG_INF, torch.float32),
        fin_exists=fill((g, k), False, torch.bool),
        unsat=fill((g,), False, torch.bool),
        done=fill((g,), True, torch.bool),
        active=fill((g,), False, torch.bool),
        stop=fill((g,), opts.max_length, torch.long),
        utt_id=fill((g,), -1, torch.long),
    )


def _refill_from_enc(model, state: BeamStreamState, enc, pool_tokens, pool_stop, pool_utt,
                     pool_valid, opts: GenerateOptions, k: int, use_ring: bool) -> None:
    """Move E encoded windows (decode/streaming._encode_only's output)
    into the first E free groups, in place: their cross K/V (one row a
    group), the self K/V of the prompt's first p - 1 tokens prefilled over
    a pool cache for all K beams, and fresh beam bookkeeping (beam 0
    alive, the others at NEG_INF)."""
    p = len(opts.prompt_ids)
    e = pool_stop.shape[0]
    cache = state.cache
    kv_dtype = cache.kv_dtype
    dev = state.tokens.device
    pool = whisper._init_cache(model, enc, max(p - 1, 1), kv_dtype, beam_size=k)
    if p > 1:
        _, pool = whisper._decode_step(model, pool_tokens[:, : p - 1], pool, beam_size=k)

    gidx = _first_free(state.done | ~state.active, e)
    ridx = (gidx[:, None] * k + torch.arange(k, device=dev)).reshape(-1)
    for name in _CROSS:
        dst = getattr(cache, name)
        if dst is not None:
            dst.index_copy_(1, gidx, getattr(pool, name))
    if p > 1:
        cap = state.tokens.shape[1]
        slots = torch.arange(p - 1, device=dev)
        if use_ring:  # the age mask reads (ring - slot) mod cap < count
            slots = torch.remainder(state.ring - (p - 1) + slots, cap)
        for name in _SELF:
            dst = getattr(cache, name)
            if dst is not None:
                dst[:, ridx[:, None], slots[None, :]] = getattr(pool, name).to(dst.dtype)
    cache.length.index_fill_(0, ridx, p - 1)  # no sync, as decode/streaming.py's
    state.tokens[ridx] = pool_tokens
    # beam 0 alive, built on the card (a list uploaded from the host would
    # synchronise the stream, waiting for a prefetched encode)
    state.alive_logp[gidx] = torch.where(torch.arange(k, device=dev) == 0, 0.0, NEG_INF)
    state.fin_tokens.index_fill_(0, gidx, model.cfg.pad_token_id)
    state.fin_scores.index_fill_(0, gidx, NEG_INF)
    state.fin_exists.index_fill_(0, gidx, False)
    state.unsat[gidx] = pool_valid
    state.done[gidx] = ~pool_valid
    state.active[gidx] = pool_valid
    state.stop[gidx] = pool_stop
    state.utt_id[gidx] = pool_utt


def _steps(model, state: BeamStreamState, opts: GenerateOptions, special: SpecialTokens,
           free_for: int, n_steps: int, k: int, length_penalty: float, use_ring: bool) -> bool:
    """Up to n_steps beam steps over the window, in place. The round ends
    once at least `free_for` groups are free (done or inactive) or every
    group is done: the test before each step is the step's one read-back
    to the host. -> whether the round ended on that test."""
    rc = opts.rule_config(special)
    eot, p, cap = special.eot, len(opts.prompt_ids), opts.max_length
    w = state.tokens.shape[0]
    g = w // k
    dev = state.tokens.device
    rows = torch.arange(w, device=dev)
    rank_ok = torch.arange(2 * k, device=dev)[None] < k  # candidates that may finish
    own_beams = torch.arange(k, device=dev)[None]
    group_base = (torch.arange(g, device=dev) * k)[:, None]
    for _ in range(n_steps):
        if bool(state.done.all() | ((state.done | ~state.active).sum() >= free_for)):
            return True
        was_done, count = state.done, state.cache.length
        last = state.tokens[rows, count.clamp(max=cap - 1)][:, None]
        logits, cache = whisper._decode_step(model, last, state.cache,
                                             ring_pos=state.ring if use_ring else None,
                                             beam_size=k)
        new_count = cache.length
        # the index the new token is written at, the same on a group's rows
        cur_len = new_count.reshape(g, k)[:, 0].long()
        in_replay = cur_len < p

        logp_step = apply_rules(torch.log_softmax(logits[:, 0].float(), dim=-1), state.tokens,
                                new_count, rc)
        v = logp_step.shape[-1]
        logp = logp_step.reshape(g, k, v) + state.alive_logp[..., None]
        top_logp, top_idx = _top(logp.reshape(g, k * v), 2 * k)
        top_beam, top_tok = top_idx // v, top_idx % v

        tok3 = state.tokens.reshape(g, k, cap)
        cand_tokens = _gather_beams(tok3, top_beam)
        at = cur_len.clamp(max=cap - 1)[:, None, None].expand(g, 2 * k, 1)
        cand_tokens.scatter_(2, at, top_tok[..., None])
        hits = (top_tok == eot) | (cur_len[:, None] + 1 >= state.stop[:, None])
        # HF: the generated length counts the tokens after the prompt
        pen = torch.clamp((cur_len + 1 - p).float(), min=1.0) ** length_penalty

        # the finished set (only ranks < K, only while the heuristic is unmet)
        eligible = hits & rank_ok & state.unsat[:, None]
        cand_fin = torch.where(eligible, top_logp / pen[:, None], NEG_INF)
        fin_scores, fin_idx = _top(torch.cat([state.fin_scores, cand_fin], dim=1), k)
        fin_tokens = _gather_beams(torch.cat([state.fin_tokens, cand_tokens], dim=1), fin_idx)
        fin_exists = torch.gather(torch.cat([state.fin_exists, eligible], dim=1), 1, fin_idx)

        # the alive set: HF adds -1e9 to stopping-hit candidates
        alive_top, alive_idx = _top(top_logp + hits.float() * NEG_INF, k)
        new_tok3 = _gather_beams(cand_tokens, alive_idx)
        alive_beam = torch.gather(top_beam, 1, alive_idx)

        # the early-stop heuristic at the new length
        best_possible = alive_top[:, 0] / pen
        worst = torch.where(fin_exists, fin_scores.amin(dim=1, keepdim=True), NEG_INF)
        unsat_new = state.unsat & (best_possible[:, None] > worst).any(dim=1)

        # groups replaying their prompt or done keep their bookkeeping (a
        # replaying row's "prediction" is its stored prompt token)
        stepping = ~was_done & ~in_replay
        s2, s3 = stepping[:, None], stepping[:, None, None]
        state.tokens = torch.where(s3, new_tok3, tok3).reshape(w, cap)
        state.alive_logp = torch.where(s2, alive_top, state.alive_logp)
        state.fin_tokens = torch.where(s3, fin_tokens, state.fin_tokens)
        state.fin_scores = torch.where(s2, fin_scores, state.fin_scores)
        state.fin_exists = torch.where(s2, fin_exists, state.fin_exists)
        state.unsat = torch.where(stepping, unsat_new, state.unsat)
        state.done = was_done | (stepping & (~state.unsat | (cur_len + 1 >= state.stop)))

        # the self K/V rows follow their beams: a block-diagonal permutation
        perm = (torch.where(s2, alive_beam, own_beams) + group_base).reshape(-1)
        state.cache = dataclasses.replace(cache, **{
            name: getattr(cache, name).index_select(1, perm)
            for name in _SELF if getattr(cache, name) is not None},
            # a done group's count is frozen (its ring writes are hidden by
            # the age mask once it is refilled)
            length=torch.where(was_done.repeat_interleave(k), count, new_count))
        if use_ring:
            state.ring = torch.remainder(state.ring + 1, cap)
    return False


@torch.inference_mode()
def generate_beam_streaming(
    model: whisper.WhisperForConditionalGeneration,
    mels,
    opts: GenerateOptions,
    special: SpecialTokens,
    *,
    kv_dtype: str = "compute",
    stream: BeamStreamConfig = BeamStreamConfig(),
    stop_at: np.ndarray | None = None,
    device="cuda",
) -> tuple[np.ndarray, np.ndarray]:
    """(N, n_mels, 3000) -> (tokens (N, max_length) int32, scores (N,) fp32).

    Each utterance's tokens and length-penalized score are generate_beam's
    with num_beams=stream.num_beams and the same length_penalty, at its own
    stop length: `stop_at` (N,) optionally caps each utterance's total
    token count. Groups are refilled as their searches end. A numpy `mels`
    is uploaded in slabs of `stream.source_windows`; a tensor `mels` is
    moved to the device whole. With `stream.prefetch` the next slice's
    encode is queued behind each round that ended on its refill test; the
    tokens and scores are the same. KWT_STREAM_TRACE as in
    generate_greedy_streaming."""
    if stream.layout not in LAYOUTS:
        raise ValueError(f"layout is one of {LAYOUTS}, got {stream.layout!r}")
    dev = resolve_device(device)
    check_model_device(model, dev)
    n = mels.shape[0]
    g, k, e = stream.groups, stream.num_beams, stream.encode_batch
    if not 1 <= e <= g or k < 1:
        raise ValueError(f"encode_batch {e} must be in [1, groups {g}], num_beams {k} >= 1")
    p = len(opts.prompt_ids)
    stop_at = _stop_lengths(stop_at, n, opts)
    use_ring = stream.layout == "ring"

    state = _empty_state(model, opts, g, k, kv_dtype, dev)
    out_tokens: dict[int, np.ndarray] = {}
    out_scores: dict[int, float] = {}
    pool_tokens = _prompt_tokens(opts, model.cfg.pad_token_id, e * k, dev)
    trace = _Trace()
    feed = _Feed(model, _MelSource(mels, e, stream.source_windows, dev), n, e, stop_at,
                 opts.max_length, dev,
                 lambda enc, pool: _refill_from_enc(model, state, enc, pool_tokens, *pool, opts,
                                                    k, use_ring),
                 trace)

    filled = 0
    while feed.next_utt < n and filled + e <= g:
        feed.refill()
        filled += e

    while len(out_tokens) < n:
        trace.acc["rounds"] += 1
        # end the round when a refill becomes possible; once the stream is
        # drained, run to completion (g + 1 free groups never come)
        want = e if feed.next_utt < n else g + 1
        due = trace.timed("steps", _steps, model, state, opts, special, want,
                          stream.steps_per_round, k, stream.length_penalty, use_ring)
        host, read = trace.timed("sync", _read_back, [
            state.done, state.active, state.utt_id, state.fin_tokens, state.fin_scores,
            state.fin_exists, state.alive_logp, state.tokens, state.cache.length])
        if stream.prefetch and due:  # a refill follows: its encode behind the read-back
            feed.prefetch()
        t0 = time.perf_counter()
        if read is not None:
            read.synchronize()
        (done, active, utt_id, fin_tokens, fin_scores, fin_exists, alive_logp, tokens,
         length) = (x.numpy() for x in host)
        trace.acc["sync"] += time.perf_counter() - t0
        t0 = time.perf_counter()
        for gi in np.nonzero(done & active)[0]:
            uid = int(utt_id[gi])
            if uid < 0 or uid in out_tokens:
                continue
            # generate_beam's choice: the best finished hypothesis, else the
            # best alive one divided by the length penalty at its last
            # cur_len (the group's frozen count)
            if fin_exists[gi].any():
                out_tokens[uid] = fin_tokens[gi, 0].copy()
                out_scores[uid] = float(fin_scores[gi, 0])
            else:
                bi = int(np.argmax(alive_logp[gi]))
                pen = max(int(length[gi * k]) + 1 - p, 1) ** stream.length_penalty
                out_tokens[uid] = tokens[gi * k + bi].copy()
                out_scores[uid] = float(alive_logp[gi, bi] / pen)
        n_free = int(np.sum(done | ~active))
        trace.acc["harvest"] += time.perf_counter() - t0
        while feed.next_utt < n and n_free >= e:
            feed.refill()
            n_free -= e

    trace.emit()
    if not n:
        return np.zeros((0, opts.max_length), np.int32), np.zeros((0,), np.float32)
    return (np.stack([out_tokens[i] for i in range(n)]).astype(np.int32),
            np.asarray([out_scores[i] for i in range(n)], np.float32))
