"""Continuous-batching greedy decode (batch refill across utterances).

Lockstep decode (decode/greedy.py) runs every batch until its longest row
is done, so with real label lengths (a ~25-token mean and a long tail) a
batch spends most of its rows in the tail. This module keeps a decode
window of W rows full instead: every row holds its own utterance at its
own position, and when rows finish they are refilled with freshly encoded
utterances while the rest keep stepping.

- The self-K/V cache is a shared-slot ring: every step all rows write their
  new K/V at one ring slot (one `index_copy_`, like lockstep decode's
  write), and each row's self-attention takes its own `count` most recent
  slots (K2's ring form: (ring - slot) mod capacity < count). Whisper
  carries position only in the learned embedding and attention does not
  depend on key order, so the scrambled slot order is exact.
- A refill encodes E windows (K1) and then, one decoder layer at a time,
  projects and quantizes that layer's cross K/V into the free rows and
  runs the prompt prefix through the layer (plain attention), writing its
  self K/V at the p - 1 ring slots that trail the current slot: only one
  layer's full-precision cross K/V is ever live. The step loop replays the
  prompt only when it is one token long.
- `_steps` runs steps until enough rows are free for a refill, every row is
  finished, or `steps_per_round` steps ran, with one host read-back a step.
- The host loop harvests finished rows, feeds the next E mel windows to a
  refill, and returns the rows in input order.
- With `StreamConfig.prefetch` the encode of the next pool slice is queued
  after a round that ended on its refill test, behind the copies of the
  round's state to the host: the host waits for those copies alone
  (`_read_back`), so the card runs the encode while the host harvests; the
  refill that follows takes the encoder output that is already there
  (`_refill_from_enc`). A round that ran out of steps queues nothing: its
  encode would stand in front of the next round's steps with no refill to
  follow. The refill's own uploads are non-blocking (`_to_card`), so that
  they do not wait for the queued encode either.

Greedy rows are independent (nothing in the model, the rules or the argmax
mixes rows), so the output is token-identical to generate_greedy row for
row, up to each row's stop. The window's state is updated in place.
"""
from __future__ import annotations

import dataclasses
import json
import os
import sys
import time
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from kotoba_whisper_tpu_torch.core.config import SpecialTokens
from kotoba_whisper_tpu_torch.core.device import check_model_device, resolve_device
from kotoba_whisper_tpu_torch.decode.greedy import GenerateOptions
from kotoba_whisper_tpu_torch.decode.logits_rules import apply_rules
from kotoba_whisper_tpu_torch.models import whisper
from kotoba_whisper_tpu_torch.ops.attention import attention


@dataclass(frozen=True)
class StreamConfig:
    batch: int = 48            # decode window rows (W)
    encode_batch: int = 16     # utterances encoded per refill (E)
    prefetch: bool = False     # queue the next pool slice's encode after
    # a round that ended on its refill test, so the card encodes while the
    # host reads the round back and harvests; the tokens are the same
    source_windows: int = 256  # mel windows on the card at once when the
    # caller passes a host (numpy) source: it is uploaded in slabs of this
    # many windows. A tensor source is used whole (its caller placed it).
    steps_per_round: int = 64  # most decode steps between two host
    # harvests; a round ends early once enough rows are free to refill


@dataclass
class StreamState:
    tokens: torch.Tensor    # (W, max_len) int64
    finished: torch.Tensor  # (W,) bool
    active: torch.Tensor    # (W,) bool: holds an unharvested utterance
    stop: torch.Tensor      # (W,) int64: most total tokens for the row
    utt_id: torch.Tensor    # (W,) int64: stream index occupying the row
    ring: torch.Tensor      # () int32: the next shared self-K/V write slot
    cache: whisper.KVCache  # length is the (W,) int32 per-row token count


def _prompt_tokens(opts: GenerateOptions, pad: int, rows: int, dev) -> torch.Tensor:
    t = torch.full((rows, opts.max_length), pad, dtype=torch.long, device=dev)
    t[:, : len(opts.prompt_ids)] = torch.tensor(opts.prompt_ids, dtype=torch.long, device=dev)
    return t


def _empty_cache(model, opts: GenerateOptions, rows: int, cross_rows: int, kv_dtype: str,
                 dev) -> whisper.KVCache:
    """A window's cache: `rows` self rows of capacity max_length and
    `cross_rows` cross rows (one a beam group in a beam stream), zeroed
    (scales 1), every row's count 0; the layout of whisper.init_cache's
    `kv_dtype` ("compute", "int8" or "int4")."""
    cfg = model.cfg
    if kv_dtype not in ("compute", "int8", "int4"):
        raise ValueError(f"kv_dtype is 'compute', 'int8' or 'int4', got {kv_dtype!r}")
    store = model.dtype if kv_dtype == "compute" else torch.int8
    n = cfg.decoder_layers
    d = whisper.rank_width(model)
    self_k = torch.zeros((n, rows, opts.max_length, d), dtype=store, device=dev)
    cross_store, cross_d = (torch.uint8, d // 2) if kv_dtype == "int4" else (store, d)
    cross_k = torch.zeros((n, cross_rows, cfg.max_source_positions, cross_d),
                          dtype=cross_store, device=dev)
    scales = {}
    if kv_dtype != "compute":
        s_w, s_dt = ((whisper.rank_heads(model, cfg.decoder_attention_heads), torch.bfloat16)
                     if kv_dtype == "int4" else (1, torch.float32))

        def ones(r, t):
            return torch.ones((n, r, t, s_w), dtype=s_dt, device=dev)

        scales = dict(self_k_scale=ones(rows, opts.max_length),
                      self_v_scale=ones(rows, opts.max_length),
                      cross_k_scale=ones(cross_rows, cfg.max_source_positions),
                      cross_v_scale=ones(cross_rows, cfg.max_source_positions))
    return whisper.KVCache(self_k, torch.zeros_like(self_k), cross_k, torch.zeros_like(cross_k),
                           torch.zeros(rows, dtype=torch.int32, device=dev), **scales)


def _first_free(free: torch.Tensor, e: int) -> torch.Tensor:
    """The indices of the first e free slots (rows, or beam groups)."""
    return torch.argsort((~free).to(torch.uint8), stable=True)[:e]


def _stop_lengths(stop_at, n: int, opts: GenerateOptions) -> np.ndarray:
    """Each utterance's most total tokens: stop_at capped at max_length."""
    stop_at = np.minimum(np.full((n,), opts.max_length) if stop_at is None
                         else np.asarray(stop_at), opts.max_length)
    if n and stop_at.min() <= len(opts.prompt_ids):
        raise ValueError("stop_at must allow at least one sampled token")
    return stop_at


def _pool(lo: int, n: int, e: int, stop_at: np.ndarray, max_length: int, dev):
    """The refill batch of utterances lo .. lo + e, fewer at the stream's
    end -> (hi, stops, utterance ids, valid), each an (E,) tensor on dev
    (id -1 and not valid past the end)."""
    hi = min(lo + e, n)
    valid = np.zeros((e,), bool)
    valid[: hi - lo] = True
    stops = np.full((e,), max_length, np.int64)
    stops[: hi - lo] = stop_at[lo:hi]
    utts = np.full((e,), -1, np.int64)
    utts[: hi - lo] = np.arange(lo, hi)
    return hi, *(_to_card(a, dev) for a in (stops, utts, valid))


def _to_card(a: np.ndarray, dev) -> torch.Tensor:
    """A host array on dev. On the card the copy goes from pinned memory
    without blocking: a pageable copy synchronises the stream, so it would
    make the host wait for all the work queued before it (a prefetched
    encode among it)."""
    t = torch.from_numpy(a)
    if torch.device(dev).type != "cuda":
        return t.to(dev)
    return t.pin_memory().to(dev, non_blocking=True)


class _MelSource:
    """A stream's (N, n_mels, 3000) mel windows, padded to a multiple of
    the refill batch e, served e at a time on the card. A tensor source is
    moved there whole (its caller placed it); a host (numpy) source is
    uploaded in slabs of `source_windows` windows (rounded down to a
    multiple of e)."""

    def __init__(self, mels, e: int, source_windows: int, dev):
        n = mels.shape[0]
        n_pad = -(-n // e) * e
        self.e, self.dev, self.lo = e, dev, 0
        if isinstance(mels, torch.Tensor):
            slab = mels.to(dev)
            if n_pad > n:
                slab = torch.cat([slab, slab.new_zeros((n_pad - n, *slab.shape[1:]))])
            self.host, self.size, self.slab = None, n_pad, slab
        else:
            host = np.asarray(mels)
            if n_pad > n:
                host = np.pad(host, ((0, n_pad - n), (0, 0), (0, 0)))
            self.host, self.size = host, max(source_windows - source_windows % e, e)
            self.slab = torch.from_numpy(host[: self.size]).to(dev)

    def windows(self, lo: int) -> torch.Tensor:
        """Windows lo .. lo + e, uploading the next slab of a host source."""
        if lo - self.lo >= self.size:
            self.lo = lo - lo % self.size
            self.slab = torch.from_numpy(self.host[self.lo : self.lo + self.size]).to(self.dev)
        return self.slab[lo - self.lo : lo - self.lo + self.e]


def _empty_state(model, opts: GenerateOptions, rows: int, kv_dtype: str, dev) -> StreamState:
    """All-free window: every row finished and inactive, count 0, caches
    zeroed (int8 scales 1)."""
    cfg = model.cfg
    cache = _empty_cache(model, opts, rows, rows, kv_dtype, dev)
    return StreamState(
        tokens=_prompt_tokens(opts, cfg.pad_token_id, rows, dev),
        finished=torch.ones(rows, dtype=torch.bool, device=dev),
        active=torch.zeros(rows, dtype=torch.bool, device=dev),
        stop=torch.full((rows,), opts.max_length, dtype=torch.long, device=dev),
        utt_id=torch.full((rows,), -1, dtype=torch.long, device=dev),
        ring=torch.zeros((), dtype=torch.int32, device=dev),
        cache=cache,
    )


def _encode_only(model, mel) -> torch.Tensor:
    """The encoder pass of one pool slice: (E, n_mels, 3000) -> (E, 1500,
    d). Apart from the refill so that a stream can queue it early
    (StreamConfig.prefetch)."""
    return whisper.encoder_forward(model, mel)


def _refill(model, state: StreamState, mel, pool_tokens, pool_stop, pool_utt, pool_valid,
            opts: GenerateOptions) -> None:
    """Encode E mel windows and refill the window from them, in place."""
    _refill_from_enc(model, state, _encode_only(model, mel), pool_tokens, pool_stop, pool_utt,
                     pool_valid, opts)


def _refill_from_enc(model, state: StreamState, enc, pool_tokens, pool_stop, pool_utt,
                     pool_valid, opts: GenerateOptions) -> None:
    """Move E encoded windows (`_encode_only`'s output) into the first E
    free rows of the window, in place: one decoder layer at a time, that
    layer's cross K/V (quantized in int8 and int4 mode) and, where the
    prompt is longer than one token, its prefix's self K/V at the p - 1
    ring slots trailing the current slot (plain causal self- and
    cross-attention over the prefix, as the JAX package's refill runs them
    outside its kernels)."""
    cfg, dec = model.cfg, model.model.decoder
    n_heads = whisper.rank_heads(model, cfg.decoder_attention_heads)
    group = whisper.tp_group(model)
    p = len(opts.prompt_ids)
    e = pool_stop.shape[0]
    cap = state.tokens.shape[1]
    cache = state.cache
    int8_kv, int4_kv = cache.is_quantized, cache.per_head_scales

    idx = _first_free(state.finished | ~state.active, e)
    slots = torch.remainder(state.ring - (p - 1) + torch.arange(max(p - 1, 1), device=idx.device),
                            cap)
    if p > 1:
        ids = pool_tokens[:, : p - 1]
        x = dec.embed_tokens.weight[ids] + dec.embed_positions.weight[: p - 1][None]

    def store(vals, scale_buf, buf, rows, cols=None):
        """vals (E, T, D) into buf's rows (and slots), quantized in int8
        mode; in int4 mode per head, the cross rows (cols None) to packed
        int4 and the self rows to int8."""
        if int4_kv:
            vals, s = whisper.quantize_kv_heads(vals, n_heads, 8 if cols is not None else 4)
            if cols is None:
                vals = whisper.pack_int4(vals)
        elif int8_kv:
            vals, s = whisper.quantize_kv_rows(vals, group)
        if int8_kv:  # either mode's scales
            if cols is None:
                scale_buf.index_copy_(0, rows, s)
            else:
                scale_buf[rows[:, None], cols[None, :]] = s
        if cols is None:
            buf.index_copy_(0, rows, vals.to(buf.dtype))
        else:
            buf[rows[:, None], cols[None, :]] = vals.to(buf.dtype)

    for i, layer in enumerate(dec.layers):
        if p > 1:
            h = whisper.layer_norm(layer.self_attn_layer_norm, x)
            sa = layer.self_attn
            q, k_new, v_new = whisper.qkv_projections(sa, h, h, n_heads)
            x = x + whisper.dense(sa.out_proj, whisper.merge_heads(
                attention(q, k_new, v_new, causal=True)))
        ea = layer.encoder_attn
        if hasattr(ea, "kv_proj"):
            ck, cv = whisper.dense(ea.kv_proj, enc).chunk(2, dim=-1)
        else:
            ck, cv = whisper.dense(ea.k_proj, enc), whisper.dense(ea.v_proj, enc)
        if p > 1:
            h = whisper.layer_norm(layer.encoder_attn_layer_norm, x)
            q2 = whisper.dense(ea.q_proj, h)
            o2 = attention(*(whisper.split_heads(y, n_heads) for y in (q2, ck, cv)))
            x = x + whisper.dense(ea.out_proj, whisper.merge_heads(o2))
            h = whisper.layer_norm(layer.final_layer_norm, x)
            x = x + whisper.dense(layer.fc2, F.gelu(whisper.dense(layer.fc1, h)))
        store(ck, cache.cross_k_scale[i] if int8_kv else None, cache.cross_k[i], idx)
        store(cv, cache.cross_v_scale[i] if int8_kv else None, cache.cross_v[i], idx)
        if p > 1:
            store(whisper.merge_heads(k_new), cache.self_k_scale[i] if int8_kv else None,
                  cache.self_k[i], idx, slots)
            store(whisper.merge_heads(v_new), cache.self_v_scale[i] if int8_kv else None,
                  cache.self_v[i], idx, slots)
    # index_fill_ takes its value as a scalar; an index assignment of a
    # Python number copies it to the card and synchronises the stream, so
    # the host would wait here for the encode and the layers above
    cache.length.index_fill_(0, idx, p - 1)
    state.tokens[idx] = pool_tokens
    state.finished[idx] = ~pool_valid
    state.active[idx] = pool_valid
    state.stop[idx] = pool_stop
    state.utt_id[idx] = pool_utt


def _steps(model, state: StreamState, opts: GenerateOptions, special: SpecialTokens,
           free_for: int, n_steps: int) -> bool:
    """Up to n_steps shared-ring decode steps, in place. The round ends
    once at least `free_for` rows are free (finished or inactive), that is
    when the host has a refill to make, or when every row is finished: the
    test before each step is the step's one read-back to the host. ->
    whether the round ended on that test (False: it ran out of steps).

    Each step feeds every row its token at index `count` (a prompt token
    while it replays the prompt, else the last sampled), writes K/V at the
    shared ring slot, and takes the rule-masked argmax, keeping the stored
    token instead where the row still replays its prompt or is finished.
    A finished row's count is frozen: its step rewrote only the shared
    slot, which the age mask hides once the row is refilled."""
    rc = opts.rule_config(special)
    eot, p, cap = special.eot, len(opts.prompt_ids), opts.max_length
    rows = torch.arange(state.tokens.shape[0], device=state.tokens.device)
    for _ in range(n_steps):
        if bool(state.finished.all() | ((state.finished | ~state.active).sum() >= free_for)):
            return True
        was_finished, length = state.finished, state.cache.length
        last = state.tokens[rows, length.clamp(max=cap - 1)][:, None]
        logits, cache = whisper._decode_step(model, last, state.cache, ring_pos=state.ring)
        count = cache.length
        masked = apply_rules(logits[:, 0].float(), state.tokens, count, rc)
        nxt = torch.argmax(masked, dim=-1)
        in_replay = count < p
        at = count.clamp(max=cap - 1)
        eff = torch.where(was_finished | in_replay, state.tokens[rows, at], nxt)
        state.tokens[rows, at] = eff
        state.finished = was_finished | (
            ~in_replay & ((eff == eot) | (count + 1 >= state.stop)))
        state.cache = dataclasses.replace(cache, length=torch.where(was_finished, length, count))
        state.ring = torch.remainder(state.ring + 1, cap)
    return False


def _read_back(tensors):
    """Start copying `tensors` to the host -> (host tensors, event). On the
    card the copies go into pinned buffers without blocking, and the event,
    recorded after them on the stream of the tensors' card (the one the
    copies are queued on, which need not be the current card's), is the
    one to wait on: work queued after this call (a prefetched encode) does
    not hold up the read. On the CPU the copies are done on return and the
    event is None."""
    dev = tensors[0].device
    if dev.type != "cuda":
        return [x.cpu() for x in tensors], None
    host = [torch.empty(x.shape, dtype=x.dtype, pin_memory=True) for x in tensors]
    for h, x in zip(host, tensors):
        h.copy_(x, non_blocking=True)
    done = torch.cuda.Event()
    done.record(torch.cuda.current_stream(dev))
    return host, done


class _Trace:
    """A stream's host clock: the seconds of each phase (steps, sync,
    harvest, refill; a prefetched encode's issue counts as refill) and the
    counts of rounds, refills and prefetched refills (those that took an
    encode queued behind the round before), printed to stderr as one
    KWT_STREAM_TRACE line when that variable is set (not "0")."""

    def __init__(self):
        self.acc = {"steps": 0.0, "sync": 0.0, "harvest": 0.0, "refill": 0.0, "rounds": 0,
                    "refills": 0, "prefetched": 0}

    def timed(self, key, fn, *a):
        t0 = time.perf_counter()
        out = fn(*a)
        self.acc[key] += time.perf_counter() - t0
        return out

    def emit(self):
        if os.environ.get("KWT_STREAM_TRACE", "0") != "0":
            print("KWT_STREAM_TRACE " + json.dumps(
                {k: round(v, 3) if isinstance(v, float) else v for k, v in self.acc.items()}
            ), file=sys.stderr)


class _Feed:
    """A stream's pool slices, taken in order. `refill()` moves the next
    slice into the window through `fill(encoder output, pool)`, from its
    prefetched encode where one is pending, else encoding it there;
    `prefetch()` queues the next slice's encode (`_encode_only`)."""

    def __init__(self, model, source: _MelSource, n: int, e: int, stop_at: np.ndarray,
                 max_length: int, dev, fill, trace: _Trace):
        self.model, self.source, self.n, self.e = model, source, n, e
        self.stop_at, self.max_length, self.dev = stop_at, max_length, dev
        self.fill, self.trace = fill, trace
        self.next_utt = 0
        self.pending = None  # the encoder output of slice next_utt, prefetched

    def refill(self):
        t0 = time.perf_counter()
        lo = self.next_utt
        self.next_utt, *pool = _pool(lo, self.n, self.e, self.stop_at, self.max_length,
                                     self.dev)
        enc, self.pending = self.pending, None
        if enc is None:
            enc = _encode_only(self.model, self.source.windows(lo))
        else:
            self.trace.acc["prefetched"] += 1
        self.fill(enc, pool)
        self.trace.acc["refills"] += 1
        self.trace.acc["refill"] += time.perf_counter() - t0

    def prefetch(self):
        if self.next_utt < self.n and self.pending is None:
            self.pending = self.trace.timed("refill", _encode_only, self.model,
                                            self.source.windows(self.next_utt))


@torch.inference_mode()
def generate_greedy_streaming(
    model: whisper.WhisperForConditionalGeneration,
    mels,
    opts: GenerateOptions,
    special: SpecialTokens,
    *,
    kv_dtype: str = "compute",
    stream: StreamConfig = StreamConfig(),
    stop_at: np.ndarray | None = None,
    device="cuda",
) -> np.ndarray:
    """(N, n_mels, 3000) -> (N, max_length) int32 token ids, N arbitrary.

    Token-identical to generate_greedy row for row; rows are refilled as
    they finish, so the cost follows the mean sequence length instead of
    each batch's longest. `stop_at` (N,) optionally caps each utterance's
    total token count. A numpy `mels` is uploaded in slabs of
    `stream.source_windows`; a tensor `mels` is moved to the device whole.
    With `stream.prefetch` the next slice's encode is queued behind each
    round that ended on its refill test (module doc); the tokens are the
    same. With KWT_STREAM_TRACE set (not "0"), the host time of each phase
    and the round, refill and prefetched-refill counts go to stderr as one
    KWT_STREAM_TRACE line (`_Trace`)."""
    dev = resolve_device(device)
    check_model_device(model, dev)
    n = mels.shape[0]
    w, e = stream.batch, stream.encode_batch
    if not 1 <= e <= w:
        raise ValueError(f"encode_batch {e} must be in [1, batch {w}]")
    stop_at = _stop_lengths(stop_at, n, opts)

    state = _empty_state(model, opts, w, kv_dtype, dev)
    results: dict[int, np.ndarray] = {}
    pool_tokens = _prompt_tokens(opts, model.cfg.pad_token_id, e, dev)
    trace = _Trace()
    feed = _Feed(model, _MelSource(mels, e, stream.source_windows, dev), n, e, stop_at,
                 opts.max_length, dev,
                 lambda enc, pool: _refill_from_enc(model, state, enc, pool_tokens, *pool, opts),
                 trace)

    # initial fill: as many pool batches as fit in the window
    filled = 0
    while feed.next_utt < n and filled + e <= w:
        feed.refill()
        filled += e

    while len(results) < n:
        trace.acc["rounds"] += 1
        # end the round exactly when a refill becomes possible; once the
        # stream is drained, run to completion (w + 1 free rows never come)
        want = e if feed.next_utt < n else w + 1
        due = trace.timed("steps", _steps, model, state, opts, special, want,
                          stream.steps_per_round)
        host, done = trace.timed("sync", _read_back,
                                 [state.tokens, state.finished, state.active, state.utt_id])
        if stream.prefetch and due:  # a refill follows: its encode behind the read-back
            feed.prefetch()
        t0 = time.perf_counter()
        if done is not None:
            done.synchronize()
        tokens, finished, active, utt_id = (x.numpy() for x in host)
        trace.acc["sync"] += time.perf_counter() - t0
        t0 = time.perf_counter()
        for r in np.nonzero(finished & active)[0]:
            uid = int(utt_id[r])
            if uid >= 0 and uid not in results:
                results[uid] = tokens[r].copy()
        n_free = int(np.sum(finished | ~active))
        trace.acc["harvest"] += time.perf_counter() - t0
        while feed.next_utt < n and n_free >= e:
            feed.refill()
            n_free -= e

    trace.emit()
    if not n:
        return np.zeros((0, opts.max_length), np.int32)
    return np.stack([results[i] for i in range(n)]).astype(np.int32)
