"""Decode-step attention over flat KV caches: kernel K2 in three forms
(csrc/decode_attention.cu, decode_attention_ring.cu,
decode_attention_beam.cu) and their plain twins.

One query per batch row against a flat (B, T, H*64) K/V block: the cache
layout of models/whisper.py. K and V come in five modes (`_kv_args`):
bfloat16 without scales; int8 with fp32 per-row scales (B, T, 1); int8
with bf16 per-head scales (B, T, H); int4 codes packed two a byte
(models/whisper.pack_int4: (B, T, H*32) uint8) with bf16 per-head scales
(B, T, H); fp32 without scales. q and the output are bfloat16 with the
first four, or fp32 (an fp32 model's step: each form's fp32 kernel) with
the last four; a call that mixes bfloat16 and fp32 raises. The scales
fold into the scores (k_scale) and into the softmax weights before the V
reduction (v_scale): exact algebra, since a head's score and weight touch
only that head's 64 columns, so the only loss is the quantization itself. `valid_len` is a lockstep scalar or per-row (B,)
counts. Without `ring_pos` a row's keys are its slots [0, valid); with it
(decode/streaming.py's shared-slot ring) they are its `valid` most recent
slots, ending at slot ring_pos: slot s is a key when
(ring_pos - s) mod T < valid.

`decode_attention_beam` is the beam form: K beam queries of a group
against the group's one shared (cross-attention) K/V row, every slot a
key; the rows are read once for all K queries.

Each form is one launch a call:
- prefix (the cross-attention call: T=1500): `split_plan` cuts the rows a
  call reads into at most MAX_CLUSTER slices, one CTA each, and the CTAs
  of a batch row form a thread-block cluster that combines its slices on
  chip;
- self (a call without ring_pos on a cache of at most SELF_MAX_SLOTS
  slots, `self_form`: every single-query self-attention call of the
  decoder, whose caches hold at most 448 positions): the ring kernel with
  key j at slot j, on `ring_plan`'s grid. The prefix kernel gave such a
  cache one CTA per batch row over all its heads (16 CTAs at B=16), 2.5x
  the device time of PyTorch's fused attention call (chip_smoke.py's
  library yardstick);
- ring: `ring_plan` gives each CTA one row and a group of heads, all of
  whose valid slots it holds in shared memory at once (no cluster); the
  fp32 form one row and one head, walking its slots in boxes of
  `RingPlan.chunk` with an online softmax;
- beam: `beam_plan` gives each CTA one (group, head, 16-beam tile) and,
  where that leaves the card idle, a share of the keys, the shares of a
  tile combining over a cluster (the fp32 form on FFMAs, the same grid).
  `beam_walk` and `ring_walk` repeat the kernels' arithmetic in their order
  on the CPU, each form's (`q_dtype`).
"""
from __future__ import annotations

from functools import lru_cache
from typing import NamedTuple

import torch

from kotoba_whisper_tpu_torch.ops import _build

NEG_INF = -1.0e30
MAX_CLUSTER = 8     # CTAs a cluster may hold: the portable cluster size
MIN_CTA_ROWS = 64   # the fewest rows a prefix CTA streams where T allows
# the most slots a cache may have for the self form (`self_form`): where
# `split_plan` would give each CTA at most MIN_CTA_ROWS rows
SELF_MAX_SLOTS = MAX_CLUSTER * MIN_CTA_ROWS
SMEM_LIMIT = 232448  # bytes of shared memory a CTA may take on the card
SM_SMEM = 233472     # bytes of shared memory of one SM (1 KB of it reserved a CTA)
N_SMS = 132          # SMs of the card the plans are made for, where none is named
LOG2E = 1.4426950408889634
BEAM_KEY_TILE = 64   # keys a tile of the beam kernel
BEAM_ROWS = 16       # beams a tile: mma.sync's M
BEAM_WARPS = 4       # consumer warps a CTA, taking the key tiles in turn
# bytes of one head's 64 columns of a K/V row, by the K/V dtypes K2 takes
# (uint8: packed int4)
KV_HEAD_BYTES = {torch.float32: 256, torch.bfloat16: 128, torch.int8: 64, torch.uint8: 32}
BEAM_STAGES = {torch.int8: 8, torch.bfloat16: 4, torch.uint8: 16}  # its copy ring
# the fp32 form's copy ring by K/V dtype (csrc/decode_attention_beam.cu F32Mode)
BEAM_F32_STAGES = {torch.float32: 3, torch.int8: 6, torch.uint8: 8}
PREFIX_STAGE_BYTES = 20480  # a stage of the prefix kernel's copy ring
# K/V modes of the C entries: bfloat16; int8 with fp32 per-row scales; int8
# with bf16 per-head scales; packed int4 with bf16 per-head scales; fp32
KV_BF16, KV_INT8, KV_INT8_HEADS, KV_INT4, KV_F32 = 0, 1, 2, 3, 4
Q_DTYPES = (torch.bfloat16, torch.float32)  # q's and the output's
RING_HEADS = (4, 2, 1)  # heads a ring CTA may take (each divides the kernel's passes)
RING_BOX = 32        # slots a TMA box of the ring kernel
RING_WARPS = 8       # warps a ring CTA
# the fp32 ring form's budget a CTA: two an SM
RING_F32_BUDGET = SM_SMEM // 2 - 1024


def split_plan(span: int) -> tuple[int, int]:
    """(CTAs per batch row, rows per CTA) of the prefix form over cache rows
    [0, span): CTA r reads rows [r * rows, min((r + 1) * rows, valid)).
    The CTAs of a row are one cluster, so their count is the grid's x."""
    if span < 1:
        raise ValueError(f"K2 needs at least one cache row, got {span}")
    n_ctas = min(MAX_CLUSTER, -(-span // MIN_CTA_ROWS))
    return n_ctas, -(-span // n_ctas)


def self_form(t: int, kv_dtype) -> bool:
    """Whether a call without ring_pos over a cache of T slots takes the
    self form (the ring kernel with key j at slot j, on `ring_plan`'s
    grid) rather than `split_plan`'s clusters: caches of at most
    SELF_MAX_SLOTS slots, where the cluster plan's CTAs would each stream
    at most MIN_CTA_ROWS rows, in every K/V mode the ring kernel takes (all
    but packed int4, which only the cross cache holds). The decoder's self
    caches (at most 448 slots) take it; its cross caches (1500) do not."""
    return t <= SELF_MAX_SLOTS and kv_dtype != torch.uint8


def ring_slot(ring_pos: int | None, valid: int, t: int, j: int) -> int:
    """Physical slot of logical key j in [0, valid) of a ring row whose
    `valid` most recent keys end at slot ring_pos: the ring kernel's map;
    without ring_pos (the self form) slot j."""
    return j if ring_pos is None else (ring_pos + 1 - valid + j) % t


def unpack_int4(packed: torch.Tensor) -> torch.Tensor:
    """The int4 cache's (..., D / 2) uint8 storage (models/whisper.pack_int4)
    -> int8 codes (..., D)."""
    p = packed.to(torch.int16)
    nib = torch.stack([p & 0xF, p >> 4], dim=-1)
    return ((nib ^ 8) - 8).to(torch.int8).reshape(*packed.shape[:-1], -1)


def _head_bytes(kv_dtype) -> int:
    """Bytes of one head's 64 columns of a K/V row (uint8: packed int4)."""
    if kv_dtype not in KV_HEAD_BYTES:
        raise ValueError(f"K2 takes fp32, bfloat16, int8 or packed int4 (uint8) K and V, "
                         f"got {kv_dtype}")
    return KV_HEAD_BYTES[kv_dtype]


def _fp32_form(kv_dtype, q_dtype) -> bool:
    """Whether K2's fp32 forms run: fp32 q, or fp32 K/V (which only they take)."""
    return q_dtype == torch.float32 or kv_dtype == torch.float32


def prefix_smem_bytes(rows: int, n_heads: int, kv_dtype, per_head: bool = False) -> int:
    """Dynamic shared memory of a prefix CTA over `rows` cache rows (the
    kernel's `Layout.total`): the copy ring (3 stages with per-head scales,
    4 without), the scores a (row, head), the two scales a row (fp32, or a
    bf16 a head), the per-head max and sum, what the cluster's CTAs send
    (their V sums of a slice of the columns, their maxima and sums), the
    barriers."""
    _head_bytes(kv_dtype)
    stages = 3 if per_head else 4
    d = n_heads * 64
    scale = 2 * rows * (2 * n_heads if per_head else 4)
    recv = (-(-(stages * PREFIX_STAGE_BYTES + 4 * rows * n_heads + scale) // 4) * 4
            + 8 * n_heads + 4 * (d + MAX_CLUSTER) + 8 * MAX_CLUSTER * n_heads)
    return ((recv + 7) & ~7) + 16 * stages


def ring_smem_bytes(t: int, hpc: int, kv_dtype, per_head: bool = False) -> int:
    """Dynamic shared memory of a ring CTA over `hpc` heads of T slots (the
    kernel's `Layout.total`): K and V by slot with a TMA box's overhang (K's
    space at least the warps' P V sums), the two scales a slot (one fp32, or
    one a head), the scores a (head, key), the warps' maxima and sums of p a
    head, two mbarriers."""
    kv = (t + RING_BOX) * hpc * _head_bytes(kv_dtype)
    sw = hpc if per_head else 1
    end = (-(-max(kv, RING_WARPS * hpc * 64 * 4) // 128) * 128 + kv + 8 * sw * t
           + 4 * hpc * t + 4 * RING_WARPS * 4)
    return ((end + 4 * RING_WARPS * 4 + 7) & ~7) + 16


def ring_f32_smem_bytes(chunk: int, kv_dtype) -> int:
    """Dynamic shared memory of an fp32-form ring CTA over boxes of `chunk`
    slots of one head (the kernel's `F32Layout.total`): K (at least the
    warps' P V sums) and V of a box, its two scales and scores a key, the
    warps' maxima and sums."""
    row = _head_bytes(kv_dtype)
    kv = -(-chunk * row // 16) * 16
    return max(kv, -(-RING_WARPS * 64 * 4 // 16) * 16) + kv + 12 * chunk + 8 * RING_WARPS


class RingPlan(NamedTuple):
    heads: int        # heads a CTA (CTA (x, y): row y, heads [x * heads, (x + 1) * heads))
    grid: tuple       # (H / heads, B)
    smem: int         # dynamic shared memory a CTA
    chunk: int        # slots a box: the fp32 form walks a row's keys in boxes; T otherwise


@lru_cache(maxsize=256)
def ring_plan(b: int, t: int, n_heads: int, kv_dtype, n_sms: int = N_SMS, *,
              per_head: bool = False, q_dtype=torch.bfloat16) -> RingPlan:
    """The ring kernel's grid: one CTA per (row, group of heads) holding all
    the group's K and V slots at once. Of the head counts that divide H and
    fit, prefer those whose CTAs fit two an SM, and among them the most
    heads whose grid still makes two CTAs per SM; else the fewest heads
    (the most CTAs). Raises where even one head's T slots do not fit.

    The fp32 form (fp32 q or K/V): one CTA per (row, head), its keys in
    boxes of all T slots where they fit two CTAs an SM, else of the most
    whole 32-slot boxes that do (192 fp32 slots)."""
    if t < 1 or b < 1:
        raise ValueError(f"K2's ring form needs rows and slots, got B={b}, T={t}")
    if _fp32_form(kv_dtype, q_dtype):
        chunk = t
        if ring_f32_smem_bytes(t, kv_dtype) > RING_F32_BUDGET:
            chunk = RING_BOX
            while ring_f32_smem_bytes(chunk + RING_BOX, kv_dtype) <= RING_F32_BUDGET:
                chunk += RING_BOX
        return RingPlan(1, (n_heads, b), ring_f32_smem_bytes(chunk, kv_dtype), chunk)

    def smem(h):
        return ring_smem_bytes(t, h, kv_dtype, per_head)

    fits = [h for h in RING_HEADS if n_heads % h == 0 and smem(h) <= SMEM_LIMIT]
    if not fits:
        raise ValueError(
            f"K2's ring form holds a head's K and V of every slot in shared memory: T={t} in "
            f"{kv_dtype} needs {smem(1)} of {SMEM_LIMIT} bytes")
    two = [h for h in fits if 2 * (smem(h) + 1024) <= SM_SMEM]
    pool = two or fits
    heads = next((h for h in pool if b * (n_heads // h) >= 2 * n_sms), pool[-1])
    return RingPlan(heads, (n_heads // heads, b), smem(heads), t)


def beam_smem_bytes(kv_dtype, q_dtype=torch.bfloat16) -> int:
    """Dynamic shared memory of a beam CTA (the kernel's `sizeof(Smem)`,
    rounded to its 1024-byte alignment, plus 1024 of alignment slack): the
    K and V ring, the scales a stage, each consumer warp's O, max and sum,
    the CTA's merged ones, the barriers. The fp32 form's (`sizeof(F32Smem)`):
    its ring of K rows padded by 16 bytes (the warps' O and the merged state
    in their place once drained), V and the scales, q, the warps' P, maxima
    and sums."""
    keys, rows, hd = BEAM_KEY_TILE, BEAM_ROWS, 64
    row = _head_bytes(kv_dtype)
    if _fp32_form(kv_dtype, q_dtype):
        stages = BEAM_F32_STAGES[kv_dtype]
        fin = BEAM_WARPS * rows * hd * 4 + rows * hd * 4 + 2 * rows * 4
        return (max(stages * keys * (row + 16), fin) + stages * keys * row
                + 2 * stages * keys * 4 + rows * hd * 4 + BEAM_WARPS * rows * 16 * 4
                + 2 * BEAM_WARPS * rows * 4)
    stages = BEAM_STAGES[kv_dtype]
    size = (2 * stages * keys * row + 2 * stages * keys * 4
            + BEAM_WARPS * rows * hd * 4 + 2 * BEAM_WARPS * rows * 4
            + rows * hd * 4 + 2 * rows * 4 + 2 * stages * 8)
    return -(-size // 1024) * 1024 + 1024


class BeamPlan(NamedTuple):
    m_tiles: int         # 16-beam tiles
    splits: int          # key shares of a (group, head, tile): the cluster's x
    keys_per_split: int  # a multiple of BEAM_KEY_TILE
    grid: tuple          # (splits, H * m_tiles, G): CTA (x, y, z) is share x of head
    #                      y % H, tile y // H, group z
    smem: int


@lru_cache(maxsize=256)
def beam_plan(g: int, t: int, n_heads: int, beams: int, kv_dtype,
              n_sms: int = N_SMS, *, q_dtype=torch.bfloat16) -> BeamPlan:
    """The beam kernel's grid: one CTA per (group, head, 16-beam tile),
    split over key shares of whole tiles, up to a cluster of MAX_CLUSTER,
    while the CTAs would not fill two an SM; no share is empty. The fp32
    form (fp32 q or K/V) takes the same grid and its own shared memory."""
    if min(g, t, n_heads, beams) < 1:
        raise ValueError(f"K2's beam form needs groups, keys, heads and beams, got G={g}, "
                         f"T={t}, H={n_heads}, K={beams}")
    m_tiles = -(-beams // BEAM_ROWS)
    n_tiles = -(-t // BEAM_KEY_TILE)
    items = g * n_heads * m_tiles
    splits = max(1, min(MAX_CLUSTER, n_tiles, (2 * n_sms) // items))
    per = -(-n_tiles // splits)
    splits = -(-n_tiles // per)
    return BeamPlan(m_tiles, splits, per * BEAM_KEY_TILE, (splits, n_heads * m_tiles, g),
                    beam_smem_bytes(kv_dtype, q_dtype))


@lru_cache(maxsize=16)
def _n_sms(card: int) -> int:
    return torch.cuda.get_device_properties(card).multi_processor_count


@lru_cache(maxsize=256)
def _ring_arg(b, t, n_heads, kv_dtype, card, per_head, q_dtype) -> int:
    """What the ring kernel's C entries take of `ring_plan` on `card`: the
    heads a CTA, or the fp32 form's box of slots; one positional cache
    lookup a call (the self and ring calls run 32 times a decode step)."""
    plan = ring_plan(b, t, n_heads, kv_dtype, _n_sms(card), per_head=per_head, q_dtype=q_dtype)
    return plan.chunk if q_dtype == torch.float32 else plan.heads


def _codes(x):
    """K or V as numbers: packed int4 unpacked, other dtypes as they are."""
    return unpack_int4(x) if x.dtype == torch.uint8 else x


def decode_attention_reference(
    q, k_flat, v_flat, valid_len, *, n_heads, k_scale=None, v_scale=None, ring_pos=None,
):
    """(B, H, hd) x (B, T, H*hd) -> (B, H, hd) in q.dtype; fp32 inside.
    Scales (B, T, 1) per row or (B, T, H) per head."""
    k_flat, v_flat = _codes(k_flat), _codes(v_flat)
    b, t, dh = k_flat.shape
    hd = dh // n_heads
    qf = q.float().reshape(b, n_heads, hd) * (1.0 / hd**0.5)
    kf = k_flat.float().reshape(b, t, n_heads, hd)
    scores = torch.einsum("bthd,bhd->bth", kf, qf)
    if k_scale is not None:
        scores = scores * k_scale.float()
    valid = torch.as_tensor(valid_len, device=q.device)
    if valid.ndim == 1:
        valid = valid[:, None, None]
    pos = torch.arange(t, device=q.device)[None, :, None]
    if ring_pos is not None:
        pos = torch.remainder(torch.as_tensor(ring_pos, device=q.device) - pos, t)  # age
    scores = torch.where(pos < valid, scores, NEG_INF)
    w = torch.softmax(scores, dim=1)
    if v_scale is not None:
        w = w * v_scale.float()
    out = torch.einsum("bth,bthd->bhd", w, v_flat.float().reshape(b, t, n_heads, hd))
    return out.to(q.dtype)


def decode_attention_reference_beam(q, k_flat, v_flat, *, n_heads, k_scale=None, v_scale=None):
    """(G, K, H, hd) x (G, T, H*hd) -> (G, K, H, hd) in q.dtype: each
    group's K queries against its one K/V row, every slot a key; fp32
    inside. Scales (G, T, 1) per row or (G, T, H) per head, broadcast over
    the beams."""
    k_flat, v_flat = _codes(k_flat), _codes(v_flat)
    g, _, _, hd = q.shape
    t = k_flat.shape[1]
    qf = q.float() * (1.0 / hd**0.5)
    scores = torch.einsum("gthd,gkhd->gtkh", k_flat.float().reshape(g, t, n_heads, hd), qf)
    if k_scale is not None:
        scores = scores * k_scale.float()[:, :, None, :]
    w = torch.softmax(scores, dim=1)
    if v_scale is not None:
        w = w * v_scale.float()[:, :, None, :]
    out = torch.einsum("gtkh,gthd->gkhd", w, v_flat.float().reshape(g, t, n_heads, hd))
    return out.to(q.dtype)


def _merge(states):
    """Combine (max, sum, O) states of one output row set, in log2 units:
    each is scaled by 2^(m - M) (0 where it saw no key)."""
    m = torch.stack([s[0] for s in states]).amax(0)
    l = torch.zeros_like(states[0][1])
    o = torch.zeros_like(states[0][2])
    for m_i, l_i, o_i in states:
        f = torch.where(torch.isinf(m_i), torch.zeros_like(m_i), torch.exp2(m_i - m))
        l = l + f * l_i
        o = o + f[..., None] * o_i
    return m, l, o


def beam_walk(q, k_flat, v_flat, *, n_heads, k_scale=None, v_scale=None, p_dtype=torch.bfloat16,
              out_dtype=torch.bfloat16, n_sms=N_SMS, q_dtype=torch.bfloat16):
    """The beam kernel's arithmetic in its order (fp32, on any device):
    `beam_plan`'s 16-beam tiles and key shares, each share's 64-key tiles
    taken by BEAM_WARPS warps in turn; a tile's scores (q as bf16 times K)
    times k_scale times log2(e)/8, the running max, 2^(s - m), the running
    sum and O rescaled by 2^(m_old - m_new), P * v_scale rounded to
    `p_dtype` (the kernel's bf16; None keeps fp32) before P V; then the
    warps' and the shares' (max, sum, O) merged and O / l in `out_dtype`.
    A per-row scale multiplies every head's column of its key, a per-head
    one its own head's. -> (G, K, H, 64).

    q_dtype float32: the fp32 form's order instead (p_dtype and out_dtype
    are then fp32): q kept in fp32 and scaled by log2(e)/8 before the
    product, each share's tiles taken by all BEAM_WARPS warps, warp w its
    keys [16w, 16w + 16) of every tile with a running state of its own
    (the scores times k_scale, max, 2^(s - m), sum, O rescaled, P * v_scale
    in fp32 before P V), then the warps' and shares' states merged."""
    if q_dtype == torch.float32:
        return _beam_walk_f32(q, k_flat, v_flat, n_heads, k_scale, v_scale, n_sms)
    g, beams, _, hd = q.shape
    t = k_flat.shape[1]
    kv_dtype = k_flat.dtype if k_flat.dtype in KV_HEAD_BYTES else torch.bfloat16
    plan = beam_plan(g, t, n_heads, beams, kv_dtype, n_sms)
    qf = q.to(torch.bfloat16).float()
    kf = _codes(k_flat).float().reshape(g, t, n_heads, hd)
    vf = _codes(v_flat).float().reshape(g, t, n_heads, hd)
    ones = torch.ones(g, 1, t, device=q.device)
    # (G, H or 1, T): broadcast over the beams
    ks = k_scale.float().permute(0, 2, 1) if k_scale is not None else ones
    vs = v_scale.float().permute(0, 2, 1) if v_scale is not None else ones
    qscale = torch.tensor(0.125 * LOG2E, dtype=torch.float32)
    out = torch.empty(g, beams, n_heads, hd, dtype=out_dtype, device=q.device)
    for mt in range(plan.m_tiles):
        qt = qf[:, mt * BEAM_ROWS:(mt + 1) * BEAM_ROWS]  # (G, R, H, 64)
        shares = []
        for x in range(plan.splits):
            k0 = x * plan.keys_per_split
            k1 = min(t, k0 + plan.keys_per_split)
            n_tiles = -(-(k1 - k0) // BEAM_KEY_TILE)
            warps = []
            for w in range(BEAM_WARPS):
                m = torch.full(qt.shape[:3], float("-inf"), device=q.device)
                l = torch.zeros(qt.shape[:3], device=q.device)
                o = torch.zeros(qt.shape, device=q.device)
                for i in range(w, n_tiles, BEAM_WARPS):
                    a = k0 + i * BEAM_KEY_TILE
                    e = min(k1, a + BEAM_KEY_TILE)
                    s = torch.einsum("grhd,gnhd->grhn", qt, kf[:, a:e])
                    s = s * ks[:, None, :, a:e] * qscale
                    m_new = torch.maximum(m, s.amax(-1))
                    corr = torch.exp2(m - m_new)
                    p = torch.exp2(s - m_new[..., None])
                    l = l * corr + p.sum(-1)
                    pv = p * vs[:, None, :, a:e]
                    if p_dtype is not None:
                        pv = pv.to(p_dtype).float()
                    o = o * corr[..., None] + torch.einsum("grhn,gnhd->grhd", pv, vf[:, a:e])
                    m = m_new
                warps.append((m, l, o))
            shares.append(_merge(warps))
        _, l, o = _merge(shares)
        out[:, mt * BEAM_ROWS:(mt + 1) * BEAM_ROWS] = (o / l[..., None]).to(out_dtype)
    return out


def _beam_walk_f32(q, k_flat, v_flat, n_heads, k_scale, v_scale, n_sms):
    """`beam_walk` in the fp32 form's order (csrc/decode_attention_beam.cu
    `beam_f32_kernel`). -> (G, K, H, 64) fp32."""
    g, beams, _, hd = q.shape
    t = k_flat.shape[1]
    plan = beam_plan(g, t, n_heads, beams, k_flat.dtype, n_sms, q_dtype=torch.float32)
    qf = q.float() * torch.tensor(0.125 * LOG2E, dtype=torch.float32)
    kf = _codes(k_flat).float().reshape(g, t, n_heads, hd)
    vf = _codes(v_flat).float().reshape(g, t, n_heads, hd)
    ones = torch.ones(g, 1, t, device=q.device)
    ks = k_scale.float().permute(0, 2, 1) if k_scale is not None else ones
    vs = v_scale.float().permute(0, 2, 1) if v_scale is not None else ones
    per_warp = BEAM_KEY_TILE // BEAM_WARPS
    out = torch.empty(g, beams, n_heads, hd, dtype=torch.float32, device=q.device)
    for mt in range(plan.m_tiles):
        qt = qf[:, mt * BEAM_ROWS:(mt + 1) * BEAM_ROWS]  # (G, R, H, 64)
        shares = []
        for x in range(plan.splits):
            k0 = x * plan.keys_per_split
            k1 = min(t, k0 + plan.keys_per_split)
            warps = []
            for w in range(BEAM_WARPS):
                m = torch.full(qt.shape[:3], float("-inf"), device=q.device)
                l = torch.zeros(qt.shape[:3], device=q.device)
                o = torch.zeros(qt.shape, device=q.device)
                for a0 in range(k0, k1, BEAM_KEY_TILE):
                    a, e = a0 + w * per_warp, min(k1, a0 + (w + 1) * per_warp)
                    if a >= e:
                        continue
                    s = torch.einsum("grhd,gnhd->grhn", qt, kf[:, a:e]) * ks[:, None, :, a:e]
                    m_new = torch.maximum(m, s.amax(-1))
                    corr = torch.exp2(m - m_new)
                    p = torch.exp2(s - m_new[..., None])
                    l = l * corr + p.sum(-1)
                    o = o * corr[..., None] + torch.einsum(
                        "grhn,gnhd->grhd", p * vs[:, None, :, a:e], vf[:, a:e])
                    m = m_new
                warps.append((m, l, o))
            shares.append(_merge(warps))
        _, l, o = _merge(shares)
        out[:, mt * BEAM_ROWS:(mt + 1) * BEAM_ROWS] = o / l[..., None]
    return out


def ring_walk(q, k_flat, v_flat, valid_len, ring_pos, *, n_heads, k_scale=None, v_scale=None,
              out_dtype=torch.bfloat16, n_sms=N_SMS, q_dtype=torch.bfloat16):
    """The ring kernel's arithmetic in its order (fp32, on any device): per
    `ring_plan` CTA (a row and its group of heads) the keys j of [0, valid)
    at slots `ring_slot` (slot j where ring_pos is None: the self form),
    the scores q / 8 times K times k_scale, the exact
    max, p = exp(s - m), their sum, the weights p * v_scale, P V and O / l
    in `out_dtype`; scales per row or per head. q is read as `q_dtype`:
    bfloat16 for the bf16 forms; float32 for the fp32 form, whose CTA (a row
    and one head) takes the keys in boxes of `ring_plan`'s chunk: each box's
    max raises the running max m, the running sum and P V are rescaled by
    exp(m_old - m_new) and the box's p = exp(s - m) added (out_dtype fp32).
    -> (B, H, 64)."""
    b, t, _ = k_flat.shape
    kv_dtype = k_flat.dtype if k_flat.dtype in KV_HEAD_BYTES else torch.bfloat16
    per_head = k_scale is not None and k_scale.dtype == torch.bfloat16
    plan = ring_plan(b, t, n_heads, kv_dtype, n_sms, per_head=per_head, q_dtype=q_dtype)
    kf = _codes(k_flat).float().reshape(b, t, n_heads, 64)
    vf = _codes(v_flat).float().reshape(b, t, n_heads, 64)
    # (B, T, H): a per-row scale repeated over the heads
    ks = None if k_scale is None else k_scale.float().expand(b, t, n_heads)
    vs = None if v_scale is None else v_scale.float().expand(b, t, n_heads)
    qf = q.to(q_dtype).float().reshape(b, n_heads, 64) * 0.125
    valid = torch.as_tensor(valid_len).reshape(-1).expand(b)
    out = torch.empty(b, n_heads, 64, dtype=out_dtype, device=q.device)
    ring = None if ring_pos is None else int(ring_pos)
    for y in range(plan.grid[1]):
        n = min(int(valid[y]), t)
        slots = torch.tensor([ring_slot(ring, n, t, j) for j in range(n)],
                             dtype=torch.long, device=q.device)
        for x in range(plan.grid[0]):
            heads = slice(x * plan.heads, (x + 1) * plan.heads)
            m = torch.full((plan.heads, 1), float("-inf"), device=q.device)
            l = torch.zeros((plan.heads, 1), device=q.device)
            o = torch.zeros((plan.heads, 64), device=q.device)
            for j0 in range(0, n, plan.chunk):  # one box a pass: all n keys but in the fp32 form
                box = slots[j0:j0 + plan.chunk]
                s = torch.einsum("jhd,hd->hj", kf[y, box, heads], qf[y, heads])
                if ks is not None:
                    s = s * ks[y, box, heads].T
                m_new = torch.maximum(m, s.amax(-1, keepdim=True))
                corr = torch.exp(m - m_new)
                p = torch.exp(s - m_new)
                l = l * corr + p.sum(-1, keepdim=True)
                if vs is not None:
                    p = p * vs[y, box, heads].T
                o = o * corr + torch.einsum("hj,jhd->hd", p, vf[y, box, heads])
                m = m_new
            out[y, heads] = (o / l).to(out_dtype)
    return out


def _kv_args(card, k_flat, v_flat, k_scale, v_scale, n_heads, q_dtype=torch.bfloat16):
    """K2's checks of the K/V cache and its scales (kept to few tensor
    calls: the self and cross calls run 64 times a decode step, and the
    step is host-bound) -> (K/V mode, K, V, k_scale, v_scale pointers). The
    modes: bfloat16 K/V and no scales (KV_BF16); int8 K/V with fp32
    (B, T, 1) scales (KV_INT8) or bf16 (B, T, H) scales (KV_INT8_HEADS);
    packed int4 K/V (uint8, H*32 columns) with bf16 (B, T, H) scales
    (KV_INT4); fp32 K/V and no scales (KV_F32). Any other combination, or
    a mix of bfloat16 and fp32 between q and K/V, raises ValueError."""
    b, t, dh = k_flat.shape
    kv_dtype = k_flat.dtype
    if kv_dtype not in KV_HEAD_BYTES:
        raise ValueError(f"K2 takes fp32, bfloat16, int8 or packed int4 (uint8) K and V, got "
                         f"{kv_dtype}")
    if q_dtype not in Q_DTYPES:
        raise ValueError(f"K2 takes bfloat16 or fp32 q, got {q_dtype}")
    if kv_dtype in (torch.bfloat16, torch.float32) and kv_dtype != q_dtype:
        raise ValueError(f"K2 does not mix {q_dtype} q with {kv_dtype} K/V: an fp32 model's "
                         "cache is fp32 (or int8 / int4), a bfloat16 model's bfloat16")
    row = n_heads * _head_bytes(kv_dtype)
    if dh * k_flat.element_size() != row or row > 5120:
        raise ValueError(f"K2 takes rows of H heads of 64 columns in at most 5120 bytes, got "
                         f"{dh} {kv_dtype} columns for {n_heads} heads")
    if v_flat.shape != k_flat.shape or v_flat.dtype != kv_dtype:
        raise ValueError(f"K2 takes K and V of one dtype and shape, got {kv_dtype} "
                         f"{tuple(k_flat.shape)}, {v_flat.dtype} {tuple(v_flat.shape)}")
    k_ptr, v_ptr = k_flat.data_ptr(), v_flat.data_ptr()
    if (not (k_flat.is_contiguous() and v_flat.is_contiguous()) or (k_ptr | v_ptr) % 16
            or k_flat.get_device() != card or v_flat.get_device() != card):
        raise ValueError("K2 takes contiguous, 16-byte aligned K/V on q's card")
    if kv_dtype in (torch.bfloat16, torch.float32):
        if k_scale is not None or v_scale is not None:
            raise ValueError(f"K2's {kv_dtype} K/V take no scales")
        return KV_BF16 if kv_dtype == torch.bfloat16 else KV_F32, k_ptr, v_ptr, None, None
    if k_scale is None or v_scale is None:
        raise ValueError("K2's int8 and int4 K/V take k_scale and v_scale")
    if kv_dtype == torch.uint8:
        mode, s_dtype, want = KV_INT4, torch.bfloat16, (b, t, n_heads)
    elif k_scale.dtype == torch.bfloat16:
        mode, s_dtype, want = KV_INT8_HEADS, torch.bfloat16, (b, t, n_heads)
    else:
        mode, s_dtype, want = KV_INT8, torch.float32, (b, t, 1)
    if any(s.dtype != s_dtype or s.shape != want or not s.is_contiguous()
           or s.get_device() != card for s in (k_scale, v_scale)):
        what = "bfloat16 (B, T, H)" if s_dtype == torch.bfloat16 else "fp32 (B, T, 1)"
        raise ValueError(f"K2's {kv_dtype} K/V take contiguous {what} k_scale and v_scale "
                         f"on q's card, got {k_scale.dtype} {tuple(k_scale.shape)}, "
                         f"{v_scale.dtype} {tuple(v_scale.shape)}")
    return mode, k_ptr, v_ptr, k_scale.data_ptr(), v_scale.data_ptr()


def _valid_arg(valid_len, b, t, card):
    """(valid_rows pointer or None, valid_all) of a scalar or (B,) valid_len."""
    if isinstance(valid_len, torch.Tensor):
        if (valid_len.shape != (b,) or valid_len.dtype != torch.int32
                or valid_len.get_device() != card):
            raise ValueError("K2's per-row valid_len is a (B,) int32 tensor on q's card")
        return valid_len.data_ptr(), 0
    valid_all = int(valid_len)
    if not 1 <= valid_all <= t:
        raise ValueError(f"K2 valid_len {valid_all} outside [1, {t}]")
    return None, valid_all


def _check(rc, form):
    if rc != 0:
        raise RuntimeError(f"K2 decode attention ({form} form) launch failed: cudaError {rc}")


def decode_attention(
    q, k_flat, v_flat, valid_len, *, n_heads, k_scale=None, v_scale=None, ring_pos=None,
):
    """K2 wrapper: the kernel for CUDA tensors, the plain twin for CPU
    tensors. q bfloat16 or fp32 (each form's fp32 kernel; the output in q's
    dtype). valid_len: int (every row) or a (B,) int32 tensor; ring_pos:
    None (keys [0, valid): the self form where `self_form` says so, else
    the prefix form, csrc/decode_attention.cu) or, on the card, a 0-d int32
    tensor on q's card, read by the ring kernel
    (csrc/decode_attention_ring.cu) from device memory. The self form is
    the ring kernel without ring_pos. Allocates only the output; safe to
    capture in a CUDA graph."""
    if q.is_cpu:
        return decode_attention_reference(
            q, k_flat, v_flat, valid_len, n_heads=n_heads,
            k_scale=k_scale, v_scale=v_scale, ring_pos=ring_pos,
        )
    b, t, _ = k_flat.shape
    card, q_stride, q_ptr = q.get_device(), q.stride(), q.data_ptr()
    if (not q.is_cuda or q.dtype not in Q_DTYPES or q.shape != (b, n_heads, 64)
            or q_stride[1:] != (64, 1) or q_stride[0] * q.element_size() % 16 or q_ptr % 16):
        raise ValueError(f"K2 takes bfloat16 or fp32 q (B, H, 64), each row's heads contiguous "
                         f"and 16-byte aligned, got {q.dtype} {tuple(q.shape)} {q_stride}")
    q_f32 = q.dtype == torch.float32
    mode, k_ptr, v_ptr, ks_ptr, vs_ptr = _kv_args(card, k_flat, v_flat, k_scale, v_scale,
                                                  n_heads, q.dtype)
    valid_rows, valid_all = _valid_arg(valid_len, b, t, card)
    if ring_pos is not None and mode == KV_INT4:
        raise ValueError("K2's ring form takes fp32, bfloat16 or int8 K/V (the self cache), "
                         "not int4")
    out = torch.empty((b, n_heads, 64), dtype=q.dtype, device=q.device)
    if ring_pos is None and not self_form(t, k_flat.dtype):
        n_ctas, rows = split_plan(t if valid_rows is not None else valid_all)
        _check(_build.function("decode_attention", "kwt_decode_attention")(
            card, q_ptr, q_stride[0], k_ptr, v_ptr, ks_ptr, vs_ptr, valid_rows, valid_all,
            out.data_ptr(), b, t, n_heads, n_ctas, rows, mode, int(q_f32),
            _build.stream_handle(card)), "prefix")
        decode_attention.launches += 1
        return out
    if ring_pos is not None and (
            not isinstance(ring_pos, torch.Tensor) or ring_pos.shape != ()
            or ring_pos.dtype != torch.int32 or ring_pos.get_device() != card):
        raise ValueError("K2's ring_pos is a 0-d int32 tensor on q's card")
    arg = _ring_arg(b, t, n_heads, k_flat.dtype, card, mode == KV_INT8_HEADS, q.dtype)
    entry = "kwt_decode_attention_ring_f32" if q_f32 else "kwt_decode_attention_ring"
    _check(_build.function("decode_attention_ring", entry)(
        card, q_ptr, q_stride[0], k_ptr, v_ptr, ks_ptr, vs_ptr, valid_rows, valid_all,
        None if ring_pos is None else ring_pos.data_ptr(), out.data_ptr(), b, t, n_heads, arg,
        mode, _build.stream_handle(card)), "ring" if ring_pos is not None else "self")
    if ring_pos is None:
        decode_attention.self_launches += 1
    else:
        decode_attention.ring_launches += 1
    return out


decode_attention.launches = 0       # K2, prefix form (the cluster kernel)
decode_attention.self_launches = 0  # K2, self form (the ring kernel without ring_pos)
decode_attention.ring_launches = 0  # K2, ring form


def decode_attention_beam(q, k_flat, v_flat, *, n_heads, k_scale=None, v_scale=None):
    """K2's beam form: q (G, K, H, 64) against one flat K/V row per group
    (G, T, H*64; packed int4 (G, T, H*32)), every slot a key -> (G, K, H,
    64) in q's dtype. The kernel (csrc/decode_attention_beam.cu, any beam
    count; fp32 q its fp32 form) for CUDA tensors, the plain twin for CPU
    tensors. Allocates only the output; safe to capture in a CUDA graph."""
    if q.is_cpu:
        return decode_attention_reference_beam(
            q, k_flat, v_flat, n_heads=n_heads, k_scale=k_scale, v_scale=v_scale)
    g, t, _ = k_flat.shape
    beams = q.shape[1] if q.ndim == 4 else 0
    card, q_stride, q_ptr = q.get_device(), q.stride(), q.data_ptr()
    if (not q.is_cuda or q.dtype not in Q_DTYPES or beams < 1
            or q.shape != (g, beams, n_heads, 64)
            or q_stride[1:] != (q_stride[1], 64, 1) or q_stride[0] != beams * q_stride[1]
            or q_stride[1] * q.element_size() % 16 or q_ptr % 16):
        raise ValueError(f"K2's beam form takes bfloat16 or fp32 q (G, K, H, 64) with head dim "
                         f"64 (the kernel's tile), its G*K rows evenly strided, each row's heads "
                         f"contiguous and 16-byte aligned, got {q.dtype} {tuple(q.shape)} "
                         f"{q_stride}")
    q_f32 = q.dtype == torch.float32
    mode, k_ptr, v_ptr, ks_ptr, vs_ptr = _kv_args(card, k_flat, v_flat, k_scale, v_scale,
                                                  n_heads, q.dtype)
    if mode == KV_INT8_HEADS:
        raise ValueError("K2's beam form takes fp32, bfloat16, int8 with fp32 (G, T, 1) scales "
                         "or int4 K/V (the cross cache), not int8 with per-head scales")
    if mode == KV_INT4 and (ks_ptr | vs_ptr) % 4:
        raise ValueError("K2's beam form copies int4 K/V's bf16 scales by 4-byte words: "
                         "they start 4-byte aligned")
    plan = beam_plan(g, t, n_heads, beams, k_flat.dtype, _n_sms(card), q_dtype=q.dtype)
    out = torch.empty((g, beams, n_heads, 64), dtype=q.dtype, device=q.device)
    entry = "kwt_decode_attention_beam_f32" if q_f32 else "kwt_decode_attention_beam"
    _check(_build.function("decode_attention_beam", entry)(
        card, q_ptr, q_stride[1], k_ptr, v_ptr, ks_ptr, vs_ptr, out.data_ptr(), g, t, n_heads, beams,
        plan.splits, plan.keys_per_split, mode, _build.stream_handle(card)), "beam")
    decode_attention_beam.launches += 1
    return out


decode_attention_beam.launches = 0  # K2, beam form
