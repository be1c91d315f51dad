"""Flash attention: the forward kernels K1 (non-causal) and K4 (causal),
two instantiations of one TMA and wgmma kernel in
csrc/flash_attention_sm90.cu (bf16) and two of one CUDA-core kernel in
csrc/flash_attention_f32.cu (fp32), the int8 attention core K8 in
csrc/flash_attention_int8.cu, the backward K5 in
csrc/flash_attention_bwd.cu (a D pre-pass, one TMA and wgmma kernel over
128-key work items, and a dQ conversion) and its fp32 form in
csrc/flash_attention_bwd_f32.cu (causal calls: one launch of a cluster of
key tiles a (batch, head) on 3xTF32 mma.sync; the cross call: a pre-pass,
then a dQ kernel and a dK/dV kernel on the CUDA cores), their plain twins,
and the `FlashAttention` autograd function that ties them together.

softmax(q k^T / sqrt(D)) v with O in the input dtype and the fp32
natural-log logsumexp of each query row (the residual the backward pass
needs). Causal attention is end-aligned: query row i sees keys
j <= i + (Tk - Tq); the public `flash_attention` takes it only with
Tq == Tk, as the JAX package does. Layout is the model's: q (B, Tq, H, D),
k/v (B, Tk, H, D), O (B, Tq, H, D), LSE (B, H, Tq). The forward kernels
read q, k and v with strides of their own, so the column blocks of a fused
qkv (or kv) projection go in without copies, through TMA tensor maps whose
byte strides `_fwd_plan` plans (multiples of 16). `causal_tile_plan`
mirrors the key tiles each 128-row work item of K4 visits and masks;
`bwd_tile_plan` the 64-row query tiles each 128-key work item of K5
visits and masks, and `_bwd_plan` K5's strides (q, k, v and dO through
tensor maps as K1's, O read by the pre-pass) and scratch.

The int8 core (the JAX package's `KWT_FA_INT8` experiment): "qk" runs QK^T
as s8 x s8 -> s32 with q quantized per query row and K per key row; "qkpv"
also quantizes P (against the row's final max) and V per column for an
int8 P V. On the card K and V are quantized by K8's own pre-pass
(`int8_prepass_reference` is its twin; `V8T_KEY_ORDER` the key order of
its transposed V) and `_int8_plan` caches each set of layouts; on the CPU
by `quantize_k_rows` and `quantize_v_cols`. `flash_attention_fwd` takes it
where the JAX package does:
non-causal attention over at most SINGLE_STEP_MAX_K keys, with the mode
given as `int8_mode` or, when that is None, read from KWT_FA_INT8 at each
non-causal call. The backward pass stays K5, on the int8 forward's O and
LSE.

The JAX package's other experiment switches of this kernel, read at every
call by `read_switches` (on when set to anything but "0", as the JAX
package reads them; `flash_attention_fwd` and `flash_attention_int8` also
take them as arguments): both act only where the JAX package's one-shot
kernel runs, non-causal attention over at most SINGLE_STEP_MAX_K keys;
causal calls (K4), longer calls and the backward (K5) run unchanged.
KWT_FA_NOMAX shifts each row's softmax by a Cauchy-Schwarz bound in place
of its max: m_i = ||q_i|| * max_j ||k_j|| * scale for K1 (the norms in
fp32, q's after the exact scale fold), and m_i = (qs_i ||q8_i||) * (scale
* max_j ks_j ||k8_j||) over the int8 codes for K8, whose qkpv then rounds
p8 against that bound in one pass. Shift-exact while the bound exceeds the
row max by less than ~69 (-ln 1e-30); past it every p underflows, l is
clamped to 1e-30 and the row's O reads 0, a fault of the JAX package that
the port copies. On the card a pre-pass writes max_j ||k_j|| (K1) or max_j
ks_j ||k8_j|| (K8) per (batch, head), and the kernels' no-max forms (their
own C entries, counted also on `nomax_launches`) take each row's norm from
its Q tile. KWT_FA_EXP2 computes K1's exponentials as exp2(s * scale *
log2e - m) and its LSE as m ln2 + log l; it does not apply under an int8
mode (the JAX package's int8 kernel takes no exp2). The card's K1 kernels
compute exp2 in that form already (ex2 after one FFMA), so on the card it
runs K1 as it is; the twin computes the JAX package's exp2 branch. K5
runs on the forward's LSE, whichever form made it. KWT_FA_BQ only sets
the TPU kernel's query block; the port's fixed 128-row tiles give the same
result whatever it says, so it is not read.

Each wrapper launches its kernel for CUDA tensors (D = 64; bf16, or fp32
through the fp32 forms: csrc/flash_attention_f32.cu for K1 and K4,
csrc/flash_attention_bwd_f32.cu for K5, and the fp32-q kernel of
csrc/flash_attention_int8.cu for K8) and takes its plain twin only for CPU
tensors.
"""
from __future__ import annotations

import ctypes
import math
import os
from functools import lru_cache

import torch
import torch.nn.functional as F

from kotoba_whisper_tpu_torch.ops import _build

# non-causal attention over at most this many keys is the JAX package's
# one-shot kernel, the only place it applies KWT_FA_INT8
SINGLE_STEP_MAX_K = 4096
INT8_MODES = ("", "qk", "qkpv")
LOG2E, LN2 = 1.4426950408889634, 0.6931471805599453
L_MIN = 1e-30  # the floor of a row's sum, as the TPU kernels clamp it


def read_switches():
    """(no_max, exp2): KWT_FA_NOMAX and KWT_FA_EXP2 as the JAX package reads
    them, each on when set to anything but "0"."""
    return (os.environ.get("KWT_FA_NOMAX", "0") != "0",
            os.environ.get("KWT_FA_EXP2", "0") != "0")


def _scale_exact(c, dtype):
    """True when c is exact in dtype (the JAX package's `_scale_exact`):
    then it folds into q in q's dtype without rounding."""
    return float(torch.tensor(c, dtype=dtype)) == c


def _scores(q, k, causal):
    """fp32 scores of q pre-scaled by 1/sqrt(D) in its own dtype (the JAX
    package's `_scale_exact` fold: 1/8 is exact in bf16 and fp32), with
    the end-aligned causal mask applied as -inf."""
    d = q.shape[-1]
    qs = q * torch.tensor(1.0 / d**0.5, dtype=q.dtype)
    s = torch.einsum("bqhd,bkhd->bhqk", qs.float(), k.float())
    if causal:
        tq, tk = q.shape[1], k.shape[1]
        above = (torch.arange(tk, device=q.device)[None, :]
                 > torch.arange(tq, device=q.device)[:, None] + (tk - tq))
        s = s.masked_fill(above, float("-inf"))
    return qs, s


def flash_attention_reference(q, k, v, causal=False, *, no_max=False, exp2=False):
    """Plain twin of K1/K4: fp32 scores and softmax, LSE from
    torch.logsumexp. Under no_max or exp2 (non-causal only), the JAX
    package's one-shot kernel step by step: c = scale (times log2e for
    exp2) folded into q in q's dtype where exact, else applied to the fp32
    scores; m the norm bound (no_max) or the row max; p = exp(s - m) or
    exp2; P in q's dtype for P V; O = o / max(l, 1e-30); LSE = m (times ln2
    for exp2) + log max(l, 1e-30). -> (O in q.dtype, LSE (B, H, Tq) fp32)."""
    if no_max or exp2:
        if causal:
            raise ValueError("KWT_FA_NOMAX and KWT_FA_EXP2 apply to non-causal attention only")
        return _one_shot_reference(q, k, v, no_max, exp2)
    _, s = _scores(q, k, causal)
    lse = torch.logsumexp(s, dim=-1)
    p = torch.exp(s - lse[..., None])
    o = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    return o.to(q.dtype), lse


def _one_shot_reference(q, k, v, no_max, exp2):
    """`flash_attention_reference` under its switches, in the order of the
    JAX package's `_fwd_kernel_single`."""
    in_dtype = q.dtype
    c = 1.0 / q.shape[-1] ** 0.5 * (LOG2E if exp2 else 1.0)
    exact = _scale_exact(c, in_dtype)
    qc = q * torch.tensor(c, dtype=in_dtype) if exact else q
    s = torch.einsum("bqhd,bkhd->bhqk", qc.float(), k.float())
    if not exact:
        s = s * c
    if no_max:
        qn = qc.float().square().sum(-1).sqrt().transpose(1, 2)[..., None]  # (B, H, Tq, 1)
        kn = k.float().square().sum(-1).amax(1).clamp(min=0.0).sqrt()       # (B, H)
        m = qn * (kn * (1.0 if exact else c))[..., None, None]
    else:
        m = s.amax(-1, keepdim=True)
    p = torch.exp2(s - m) if exp2 else torch.exp(s - m)
    l_safe = p.sum(-1, keepdim=True).clamp(min=L_MIN)
    o = torch.einsum("bhqk,bkhd->bqhd", p.to(in_dtype).float(), v.float())
    lse = (m * LN2 if exp2 else m) + torch.log(l_safe)
    return (o / l_safe.transpose(1, 2)).to(in_dtype), lse[..., 0]


def no_max_witness(b, t, h, *, seed=0, big=480.0, q_norm=2.5):
    """fp32 CPU (q, k, v), each (B, T, H, 64), on which the no-max forms
    part from the max-based ones: in each (batch, head) key 17 has norm
    `big` (~60x the others) along a unit u; even query rows lie along u
    (the bound is tight) and odd rows orthogonal to it with norm q_norm,
    where the bound 0.125 * q_norm * big = 150 exceeds every score by more
    than 110, so every p underflows in fp32 and such rows read O = 0 (the
    JAX package's fault); V = 1 + N(0, 1/4), so a row that sees any key
    has |O| near 8. `no_max_slack` reads each row's margin."""
    g = torch.Generator().manual_seed(seed)
    q, k = (torch.randn(b, t, h, 64, generator=g, dtype=torch.float64) for _ in range(2))
    v = 1.0 + 0.5 * torch.randn(b, t, h, 64, generator=g, dtype=torch.float64)
    u = torch.randn(b, 1, h, 64, generator=g, dtype=torch.float64)
    u = u / u.norm(dim=-1, keepdim=True)
    k[:, 17:18] = big * u
    q = q - (q * u).sum(-1, keepdim=True) * u
    q = q * (q_norm / q.norm(dim=-1, keepdim=True))
    q[:, 0::2] = q_norm * u
    return tuple(x.float() for x in (q, k, v))


def no_max_slack(q, k):
    """The no-max bound less the row max of the scores, (B, H, Tq) fp32,
    as K1's twin computes both: rows past ~69 lose their sum to the 1e-30
    floor, and past ~103 (fp32's least subnormal) or ~87 (the card's
    flush-to-zero exp2) every p is 0."""
    qc, s = _scores(q, k, False)
    bound = (qc.float().square().sum(-1).sqrt().transpose(1, 2)
             * k.float().square().sum(-1).amax(1).sqrt()[..., None])
    return bound - s.amax(-1)


def _shapes(q_shape, k_shape, v_shape):
    """(B, Tq, Tk, H) of (B, Tq, H, 64) q and (B, Tk, H, 64) k and v."""
    if not len(q_shape) == len(k_shape) == len(v_shape) == 4:
        raise ValueError(f"flash attention takes (B, T, H, D) tensors, got q {q_shape}, "
                         f"k {k_shape}, v {v_shape}")
    b, tq, h, d = q_shape
    kb, tk, kh, kd = k_shape
    if d != 64:
        raise ValueError(f"the flash attention kernels are built for head dim 64, got {d}")
    if k_shape != v_shape or (kb, kh, kd) != (b, h, d):
        raise ValueError(f"flash_attention shapes differ: q {q_shape}, k {k_shape}, "
                         f"v {v_shape}")
    if tq == 0 or tk == 0:
        raise ValueError("flash_attention needs at least one query and one key")
    return b, tq, tk, h


# K1/K4's TMA box: (head dim, heads, tokens, batch) elements, 128 bytes
# wide (the 128-byte swizzle), 128 tokens tall (csrc/flash_attention_sm90.cu);
# a work item is one 128-row query tile and its key tiles are 128 keys
TMA_BOX = (64, 1, 128, 1)
TILE = TMA_BOX[2]


@lru_cache(maxsize=256)
def _map_strides(shape, stride, size):
    """Byte strides (head, token, batch) of a (B, T, H, 64) layout for
    K1/K4's 4-D tensor map. The head dim must be contiguous and every
    stride a multiple of 16 bytes, as TMA requires (the address too, which
    the wrapper checks per call); a dimension of size 1 takes the stride of
    a contiguous layout (it never moves the address). Raises ValueError
    otherwise."""
    b, tt, h, d = shape
    sb, st, sh, sd = stride
    if d != TMA_BOX[0] or sd != 1:
        raise ValueError(f"K1/K4 take a contiguous head dim of {TMA_BOX[0]}, got shape "
                         f"{tuple(shape)} strides {stride}")
    head = size * (sh if h > 1 else d)
    token = size * (st if tt > 1 else h * d)
    batch = size * sb if b > 1 else tt * token
    if head % 16 or token % 16 or batch % 16:
        raise ValueError(f"K1/K4's tensor maps need 16-byte strides; strides {stride} of "
                         f"{size}-byte elements give head {head}, token {token}, batch "
                         f"{batch} bytes")
    if not (head * h <= token and token * tt <= batch) or batch * b >= 1 << 40:
        raise ValueError(f"K1/K4 cannot map overlapping strides {stride}")
    return head, token, batch


def causal_tile_plan(tq, tk, q0):
    """K4's plan for the work item of query rows [q0, q0 + TILE) under the
    end-aligned mask (row i sees keys j <= i + tk - tq): the number of
    TILE-key tiles it visits, in ascending order from key 0, and how many
    leading ones lie wholly below its first row's bound and so need no
    mask (csrc/flash_attention_sm90.cu `plan_item`). -> (n_tiles, n_free)."""
    offset, last_row = tk - tq, min(q0 + TILE - 1, tq - 1)
    n_tiles = min(-(-tk // TILE), (last_row + offset) // TILE + 1)
    return n_tiles, min(n_tiles, (q0 + offset + 1) // TILE)


# K5's tiles: a work item is one 128-key tile of one (batch, head); it
# walks 64-row query tiles (csrc/flash_attention_bwd.cu)
BWD_KTILE, BWD_QTILE = 128, 64


def bwd_tile_plan(tq, tk, k0, causal=True):
    """K5's plan for the work item of keys [k0, k0 + BWD_KTILE): the first
    BWD_QTILE-row query tile it visits, how many it visits (every tile from
    there to the last), and the first of them that needs no mask (every
    row of it sees every key of the item; the earlier visited tiles are
    masked). Causal (end-aligned: row i sees keys j <= i + tk - tq): from
    the first row that sees key k0. Non-causal: every tile, none masked
    here (the kernel masks keys past tk in a ragged last key tile).
    (csrc/flash_attention_bwd.cu `plan_item`.) -> (qt0, n_tiles, free_from)."""
    n_qt = -(-tq // BWD_QTILE)
    if not causal:
        return 0, n_qt, 0
    offset = tk - tq
    qt0 = max(k0 - offset, 0) // BWD_QTILE
    free_from = max(qt0, min(n_qt, max(0, k0 + BWD_KTILE - 1 - offset + BWD_QTILE - 1)
                             // BWD_QTILE))
    return qt0, n_qt - qt0, free_from


@lru_cache(maxsize=256)
def _bwd_plan(q_layout, k_layout, v_layout, o_layout, do_layout, lse_layout, causal):
    """What K5's C entry reads of one call, from each tensor's (shape,
    strides): (B, Tq, Tk, H, the fp32 scratch length) and the int64 array
    (B, Tq, Tk, H, causal, direct, then the head, token and batch byte
    strides of q, k, v, dO and O). direct: one key tile per (batch, head),
    so dQ is written in bf16 by the main kernel with no fp32 accumulator.
    Scratch: the pre-pass's LSE2 and D rows (B*H, Tq padded to BWD_QTILE
    each), then the accumulator (B*H*n_qtiles*BWD_QTILE*64) unless direct.
    Checked once per set of layouts (the addresses are checked per call)."""
    b, tq, tk, h = _shapes(q_layout[0], k_layout[0], v_layout[0])
    if o_layout[0] != q_layout[0] or do_layout[0] != q_layout[0]:
        raise ValueError(f"K5: o {tuple(o_layout[0])} and do {tuple(do_layout[0])} must "
                         f"match q {tuple(q_layout[0])}")
    if tuple(lse_layout[0]) != (b, h, tq) or tuple(lse_layout[1]) != (h * tq, tq, 1):
        raise ValueError(f"K5 takes a contiguous (B, H, Tq) = {(b, h, tq)} lse, got shape "
                         f"{tuple(lse_layout[0])} strides {lse_layout[1]}")
    if causal and tq > tk:
        raise ValueError(f"causal flash attention needs Tq <= Tk, got {tq} > {tk}")
    strides = [s for shape, stride in (q_layout, k_layout, v_layout, do_layout, o_layout)
               for s in _map_strides(shape, stride, 2)]
    n_qt = -(-tq // BWD_QTILE)
    direct = tk <= BWD_KTILE
    scratch = 2 * b * h * n_qt * BWD_QTILE + (0 if direct else b * h * n_qt * BWD_QTILE * 64)
    return (b, tq, tk, h, scratch), (ctypes.c_longlong * 21)(b, tq, tk, h, int(causal),
                                                             int(direct), *strides)


def _check_form(tq, tk, causal, no_max):
    if causal and tq > tk:
        raise ValueError(f"causal flash attention needs Tq <= Tk, got {tq} > {tk}")
    if no_max and (causal or tk > SINGLE_STEP_MAX_K):
        raise ValueError("the no-max forms take non-causal attention over at most "
                         f"{SINGLE_STEP_MAX_K} keys (the JAX package's one-shot kernel)")


@lru_cache(maxsize=256)
def _fwd_plan(q_layout, k_layout, v_layout, causal, no_max=False):
    """What K1/K4's C entry reads of one call, from each tensor's (shape,
    strides): (B, Tq, H) and the int64 array (B, Tq, Tk, H, causal, then
    each of q, k, v's head, token and batch byte strides, then no_max: K1's
    no-max form). Checked once per set of layouts (the address is checked
    per call)."""
    b, tq, tk, h = _shapes(q_layout[0], k_layout[0], v_layout[0])
    _check_form(tq, tk, causal, no_max)
    strides = [s for shape, stride in (q_layout, k_layout, v_layout)
               for s in _map_strides(shape, stride, 2)]
    return (b, tq, h), (ctypes.c_longlong * 15)(b, tq, tk, h, int(causal), *strides,
                                                int(no_max))


def _f32_strides(shape, stride, what):
    """Element strides (batch, token, head) of a (B, T, H, 64) fp32 layout
    for the fp32 CUDA-core kernels: the head dim contiguous and every
    stride a multiple of 4 elements (their float4 loads; the addresses are
    checked per call). A dimension of size 1 never moves the address, so
    any stride there will do."""
    sb, st, sh, _ = (s if n > 1 else 0 for n, s in zip(shape, stride))
    if stride[3] != 1 or sb % 4 or st % 4 or sh % 4:
        raise ValueError(f"{what} take a contiguous head dim and strides of 4-element "
                         f"multiples, got shape {tuple(shape)} strides {stride}")
    return [sb, st, sh]


@lru_cache(maxsize=256)
def _f32_plan(q_layout, k_layout, v_layout, causal, no_max=False):
    """What the fp32 K1/K4's C entry reads of one call, from each tensor's
    (shape, strides): (B, Tq, H) and the int64 array (B, Tq, Tk, H, causal,
    then each of q, k, v's batch, token and head element strides,
    `_f32_strides`, then no_max)."""
    b, tq, tk, h = _shapes(q_layout[0], k_layout[0], v_layout[0])
    _check_form(tq, tk, causal, no_max)
    strides = [s for shape, stride in (q_layout, k_layout, v_layout)
               for s in _f32_strides(shape, stride, "the fp32 K1/K4")]
    return (b, tq, h), (ctypes.c_longlong * 15)(b, tq, tk, h, int(causal), *strides,
                                                int(no_max))


# K5's fp32 form (csrc/flash_attention_bwd_f32.cu): 64-row query tiles and
# 64-key tiles, a 256-thread CTA each, and the shared memory its kernels
# take (each within the 227 KB a block may use): the split form's dQ and
# dKV kernels; the causal form's CTA (six swizzled 64 x 64 tiles, the
# round's LSE and D), two an SM
BWD_F32_TILE = 64
BWD_F32_DQ_SMEM = 4 * (5 * 64 * 68 + 64 * 64)
BWD_F32_DKV_SMEM = 4 * (6 * 64 * 68 + 2 * 64 * 64 + 2 * 64)
BWD_F32_CAUSAL_SMEM = 4 * (6 * 64 * 64 + 2 * 64)
BWD_F32_MAX_CLUSTER = 8  # key tiles of a causal call on the cluster form (Tk <= 512)


def bwd_f32_cluster(tq, tk, causal):
    """CTAs of K5's fp32 causal form a (batch, head): one a 64-key tile,
    the cluster of one launch, for causal calls of at most
    BWD_F32_MAX_CLUSTER key tiles (the decoder's self-attention: at most
    448 positions); 0 where the call takes the split form's three launches
    (the cross-attention call, a causal call past 512 keys). CTA c takes
    the query tiles from `bwd_f32_first_qtile` (keys [64c, 64c + 64)) to
    the last, one a round; tile r's dQ is the sum of the shares of the CTAs
    that took round r, in rank order, made by CTA r."""
    n = -(-tk // BWD_F32_TILE)
    return n if causal and n <= BWD_F32_MAX_CLUSTER else 0


def bwd_f32_grids(b, tq, tk, h):
    """The grids of K5's fp32 dQ and dKV kernels: (query tiles, heads,
    batch) and (key tiles, heads, batch)."""
    return ((-(-tq // BWD_F32_TILE), h, b), (-(-tk // BWD_F32_TILE), h, b))


def bwd_f32_key_tiles(tq, tk, q0, causal):
    """The 64-key tiles K5's fp32 dQ kernel walks, from key 0, for query
    rows [q0, q0 + 64): all of them, or (causal, end-aligned) those at or
    below its last row's bound (csrc/flash_attention_bwd_f32.cu)."""
    n = -(-tk // BWD_F32_TILE)
    if causal:
        n = min(n, (min(q0 + BWD_F32_TILE, tq) - 1 + tk - tq) // BWD_F32_TILE + 1)
    return n


def bwd_f32_first_qtile(tq, tk, k0, causal):
    """The first 64-row query tile K5's fp32 dK/dV kernel walks (to the last)
    for keys [k0, k0 + 64): 0, or (causal) the tile of the first row that
    sees key k0."""
    return max(k0 - (tk - tq), 0) // BWD_F32_TILE if causal else 0


@lru_cache(maxsize=256)
def _bwd_f32_plan(q_layout, k_layout, v_layout, o_layout, do_layout, lse_layout, causal):
    """What K5's fp32 C entry reads of one call, from each tensor's (shape,
    strides): (B, Tq, Tk, H, the fp32 scratch length) and the int64 array
    (B, Tq, Tk, H, causal, then the batch, token and head element strides
    of q, k, v, dO and O, `_f32_strides`, then 1 for the causal cluster
    form, `bwd_f32_cluster`). Scratch, the split form's only: the
    pre-pass's padded LSE and D rows (B*H, Tq padded to BWD_F32_TILE
    each). Checked once per set of layouts (the addresses are checked per
    call)."""
    b, tq, tk, h = _shapes(q_layout[0], k_layout[0], v_layout[0])
    if o_layout[0] != q_layout[0] or do_layout[0] != q_layout[0]:
        raise ValueError(f"K5: o {tuple(o_layout[0])} and do {tuple(do_layout[0])} must "
                         f"match q {tuple(q_layout[0])}")
    if tuple(lse_layout[0]) != (b, h, tq) or tuple(lse_layout[1]) != (h * tq, tq, 1):
        raise ValueError(f"K5 takes a contiguous (B, H, Tq) = {(b, h, tq)} lse, got shape "
                         f"{tuple(lse_layout[0])} strides {lse_layout[1]}")
    if causal and tq > tk:
        raise ValueError(f"causal flash attention needs Tq <= Tk, got {tq} > {tk}")
    strides = [s for shape, stride in (q_layout, k_layout, v_layout, do_layout, o_layout)
               for s in _f32_strides(shape, stride, "K5's fp32 form")]
    cluster = bwd_f32_cluster(tq, tk, causal) > 0
    scratch = 0 if cluster else 2 * b * h * -(-tq // BWD_F32_TILE) * BWD_F32_TILE
    return (b, tq, tk, h, scratch), (ctypes.c_longlong * 21)(b, tq, tk, h, int(causal), *strides,
                                                             int(cluster))


def _flash_fwd_sm90(q, k, v, causal, no_max=False):
    """K1 (non-causal) or K4 (causal) on the card: dtype, shapes, strides,
    addresses and device checked, the two outputs allocated, one launch of
    the bf16 kernel, or of the fp32 one for fp32 q, k and v; no_max: K1's
    no-max form (a pre-pass for the key bound, then the kernel)."""
    f32 = q.dtype == k.dtype == v.dtype == torch.float32
    if not (f32 or q.dtype == k.dtype == v.dtype == torch.bfloat16):
        raise TypeError(f"flash attention kernels take bfloat16 or fp32 q, k and v of one dtype, "
                        f"got {q.dtype}, {k.dtype}, {v.dtype}")
    layouts = ((q.shape, q.stride()), (k.shape, k.stride()), (v.shape, v.stride()), causal,
               no_max)
    (b, tq, h), plan = _f32_plan(*layouts) if f32 else _fwd_plan(*layouts)
    qp, kp, vp = q.data_ptr(), k.data_ptr(), v.data_ptr()
    if (qp | kp | vp) % 16:
        raise ValueError("K1/K4 need 16-byte aligned q, k and v")
    if not (q.is_cuda and q.device == k.device == v.device):
        raise ValueError(f"flash attention kernels take tensors on the card, all on one, got "
                         f"q on {q.device}, k on {k.device}, v on {v.device}")
    o = q.new_empty((b, tq, h, 64))
    lse = q.new_empty((b, h, tq), dtype=torch.float32)
    card = q.get_device()
    lib, fn = (("flash_attention_f32", "kwt_flash_attention_f32") if f32
               else ("flash_attention_sm90", "kwt_flash_attention_sm90_fwd"))
    if no_max:  # the pre-pass's max_j ||k_j|| of each (batch, head)
        kmax = q.new_empty((b, h), dtype=torch.float32)
        rc = _build.function(lib, fn + "_nomax")(
            card, qp, kp, vp, o.data_ptr(), lse.data_ptr(), kmax.data_ptr(), plan,
            _build.stream_handle(card))
    else:
        rc = _build.function(lib, fn)(
            card, qp, kp, vp, o.data_ptr(), lse.data_ptr(), plan, _build.stream_handle(card))
    if rc != 0:
        raise RuntimeError(f"{'K4' if causal else 'K1'} flash attention"
                           f"{' (no-max)' if no_max else ''} launch failed: cudaError {rc}")
    if causal:
        flash_attention_fwd.causal_launches += 1
    else:
        flash_attention_fwd.launches += 1
        flash_attention_fwd.nomax_launches += int(no_max)
    return o, lse


def _resolve(k, causal, int8_mode, no_max, exp2):
    """The form a forward call takes, as the JAX package picks it: the int8
    mode (None reads KWT_FA_INT8 on non-causal calls), no_max and exp2 (None
    reads `read_switches`), all three only for non-causal calls over at most
    SINGLE_STEP_MAX_K keys, and exp2 only without an int8 mode.
    -> (int8_mode, no_max, exp2)."""
    single = not causal and k.shape[1] <= SINGLE_STEP_MAX_K
    env_no_max, env_exp2 = read_switches()
    if int8_mode is None and not causal:
        int8_mode = os.environ.get("KWT_FA_INT8", "")
    if int8_mode and int8_mode not in INT8_MODES:
        raise ValueError(f"int8 attention mode {int8_mode!r} is not one of {INT8_MODES}")
    int8_mode = int8_mode if single else ""
    no_max = single and (env_no_max if no_max is None else no_max)
    exp2 = single and not int8_mode and (env_exp2 if exp2 is None else exp2)
    return int8_mode, no_max, exp2


def flash_attention_fwd(q, k, v, *, causal=False, int8_mode=None, no_max=None, exp2=None):
    """K1 (causal=False) / K4 (causal=True) wrapper, or K8 where an int8
    mode applies: the kernel for CUDA tensors, the plain twin for CPU
    tensors. int8_mode, no_max and exp2 as `_resolve` takes them. ->
    (O (B, Tq, H, D) in q.dtype, LSE (B, H, Tq) fp32)."""
    int8_mode, no_max, exp2 = _resolve(k, causal, int8_mode, no_max, exp2)
    if int8_mode:
        return flash_attention_int8(q, k, v, mode=int8_mode, no_max=no_max)
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, causal, no_max=no_max, exp2=exp2)
    return _flash_fwd_sm90(q, k, v, causal, no_max)


def flash_attention_fwd_reference(q, k, v, *, causal=False, int8_mode=None, no_max=None,
                                  exp2=None):
    """The plain twin of what `flash_attention_fwd` runs for these
    arguments and switches, on any device (the plain path on the card)."""
    int8_mode, no_max, exp2 = _resolve(k, causal, int8_mode, no_max, exp2)
    if int8_mode:
        return _int8_twin(q, k, v, int8_mode == "qkpv", no_max)
    return flash_attention_reference(q, k, v, causal, no_max=no_max, exp2=exp2)


flash_attention_fwd.launches = 0          # K1
flash_attention_fwd.causal_launches = 0   # K4
flash_attention_fwd.nomax_launches = 0    # K1's no-max form (also counted in launches)


# ---------------------------------------------------------------------------
# K8: int8 attention core
# ---------------------------------------------------------------------------

def quantize_k_rows(k):
    """(B, Tk, H, D) -> int8 (B, Tk, H, D) and fp32 per-key-row scales
    (B, H, Tk), as the JAX wrapper quantizes K once per (b, h)."""
    kf = k.float()
    ka = torch.clamp(kf.abs().amax(dim=-1, keepdim=True), min=1e-8)
    ks = ka * (1.0 / 127.0)
    return torch.round(kf / ks).to(torch.int8), ks[..., 0].transpose(1, 2)


def quantize_v_cols(v):
    """(B, Tk, H, D) -> int8 (B, Tk, H, D) and fp32 per-column scales over
    T (B, H, D) (qkpv mode)."""
    vf = v.float()
    va = torch.clamp(vf.abs().amax(dim=1, keepdim=True), min=1e-8)
    vs = va * (1.0 / 127.0)
    return torch.round(vf / vs).to(torch.int8), vs[:, 0]


def flash_attention_int8_reference(q, k8, ks, v, vs, pv8, no_max=False):
    """Plain twin of K8, step by step as the TPU kernel in one pass:
    q quantized per row (round half to even), s32 scores (exact in fp32),
    s = s32 * ((qs / 8) * ks), softmax against the row max or, no_max, the
    bound m = (qs * ||q8||) * (1/8 * max_j ks_j ||k8_j||) (integer codes
    squared in fp32); qkpv: p8 = round(p * 127), exact integer P V, times
    (1/127) * vs; qk: P in q's dtype times V. v is int8 (qkpv) or in q's
    dtype (qk). -> (O (B, Tq, H, D) in q.dtype, LSE (B, H, Tq) fp32)."""
    in_dtype = q.dtype
    scale = 1.0 / q.shape[-1] ** 0.5
    qf = q.float()
    qs = torch.clamp(qf.abs().amax(dim=-1, keepdim=True), min=1e-8) * (1.0 / 127.0)
    q8 = torch.round(qf / qs)
    s32 = torch.einsum("bqhd,bkhd->bhqk", q8, k8.float())
    qsc = qs[..., 0].transpose(1, 2)[..., None] * scale
    s = s32 * (qsc * ks[:, :, None, :])
    if no_max:
        qn = q8.square().sum(-1).sqrt()                                   # (B, Tq, H)
        kmax = (ks * k8.float().square().sum(-1).sqrt().transpose(1, 2)).amax(-1)  # (B, H)
        m = (qs[..., 0] * qn).transpose(1, 2)[..., None] * (scale * kmax)[..., None, None]
    else:
        m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l_safe = torch.clamp(p.sum(dim=-1, keepdim=True), min=L_MIN)
    if pv8:
        p8 = torch.round(p * 127.0)
        o32 = torch.einsum("bhqk,bkhd->bhqd", p8.double(), v.double()).float()
        o = o32 * ((1.0 / 127.0) * vs[:, :, None, :])
    else:
        o = torch.einsum("bhqk,bkhd->bhqd", p.to(in_dtype).float(), v.float())
    o = (o / l_safe).to(in_dtype).transpose(1, 2)
    return o, (m + torch.log(l_safe))[..., 0]


# K8's key tiles (csrc/flash_attention_int8.cu): the pre-pass pads ks and
# V8^T to whole tiles
INT8_KTILE = 128
# Position k of each 32-key group of V8^T holds key V8T_KEY_ORDER[k]:
# k = 16hi + 4t + i holds key 16hi + 8(i >> 1) + 2t + (i & 1), the keys a
# thread's s32 score accumulators hold where the s8 A fragment of the
# P V product takes logical k (so P8 leaves the accumulators unshuffled).
V8T_KEY_ORDER = tuple(16 * (k >> 4) + 8 * ((k & 3) >> 1) + 2 * ((k >> 2) & 3) + (k & 1)
                      for k in range(32))


def int8_prepass_reference(k, v, pv8, no_max=False):
    """Plain twin of K8's pre-pass: `quantize_k_rows` and, for qkpv,
    `quantize_v_cols`, laid out as the kernel writes them: k8 (B, Tk, H,
    64), ks (B, H, tk_pad) with zero scales past Tk, V8^T (B, H, 64,
    tk_pad) with zero keys past Tk and each 32-key group in V8T_KEY_ORDER,
    and vs (B, H, 64); no_max: also kn (B, H, tk_pad), each key's ks
    ||k8|| (zero past Tk), and kmax (B, H), their max. -> (k8, ks, V8^T,
    vs), the last two None for qk, then (kn, kmax) for no_max."""
    b, tk, h, d = k.shape
    tk_pad = -(-tk // INT8_KTILE) * INT8_KTILE
    k8, ks = quantize_k_rows(k)
    bound = ()
    if no_max:
        kn = ks * k8.float().square().sum(-1).sqrt().transpose(1, 2)
        bound = (F.pad(kn, (0, tk_pad - tk)), kn.amax(-1))
    ks = F.pad(ks, (0, tk_pad - tk))
    if not pv8:
        return (k8, ks, None, None, *bound)
    v8, vs = quantize_v_cols(v)
    v8t = F.pad(v8.permute(0, 2, 3, 1), (0, tk_pad - tk))
    order = torch.tensor(V8T_KEY_ORDER, device=k.device)
    v8t = v8t.reshape(b, h, d, tk_pad // 32, 32)[..., order].reshape(b, h, d, tk_pad)
    return (k8, ks, v8t, vs, *bound)


@lru_cache(maxsize=256)
def _int8_plan(q_layout, k_layout, v_layout, pv8, f32=False, no_max=False):
    """What K8's C entry reads of one call, from each tensor's (shape,
    strides): (B, Tq, Tk, H, tk_pad, the byte offsets of ks, V8^T, vs, kn
    and kmax in the pre-pass's scratch, which starts with k8, and its size
    in bytes) and the int64 array (B, Tq, Tk, H, pv8, tk_pad, the head,
    token and batch byte strides of q, k and v, the offsets of ks, V8^T and
    vs, f32: the fp32-q form, whose float4 loads take the same 16-byte
    strides, no_max: the no-max form, then the offsets of kn and kmax).
    no_max's scratch adds kn (B, H, tk_pad) fp32, each key's ks ||k8||
    (zero past Tk), and kmax (B, H) fp32, their max. Checked once per set
    of layouts (the addresses are checked per call)."""
    b, tq, tk, h = _shapes(q_layout[0], k_layout[0], v_layout[0])
    if tk > SINGLE_STEP_MAX_K:
        raise ValueError(f"K8 takes at most {SINGLE_STEP_MAX_K} keys (the JAX package's "
                         f"one-shot kernel), got {tk}")
    strides = [s for shape, stride in (q_layout, k_layout, v_layout)
               for s in _map_strides(shape, stride, 4 if f32 else 2)]
    tk_pad = -(-tk // INT8_KTILE) * INT8_KTILE
    ks_off = b * tk * h * 64
    v8t_off = ks_off + b * h * tk_pad * 4
    vs_off = v8t_off + (b * h * 64 * tk_pad if pv8 else 0)
    kn_off = vs_off + (b * h * 64 * 4 if pv8 else 0)
    kmax_off = kn_off + (b * h * tk_pad * 4 if no_max else 0)
    size = kmax_off + (-(-b * h // 4) * 16 if no_max else 0)
    return ((b, tq, tk, h, tk_pad, ks_off, v8t_off, vs_off, kn_off, kmax_off, size),
            (ctypes.c_longlong * 22)(b, tq, tk, h, int(pv8), tk_pad, *strides, ks_off, v8t_off,
                                     vs_off, int(f32), int(no_max), kn_off, kmax_off))


def _flash_int8_sm90(q, k, v, pv8, phases=3, scratch=None, no_max=False):
    """K8 on the card: dtypes, layouts, addresses and device checked, O, LSE
    and the pre-pass's scratch allocated (or `scratch` reused), then the
    quantize pre-pass (phases bit 0; no_max: also the key bound's max) and
    the main kernel (bit 1) launched: the bf16 form, or the fp32-q form for
    fp32 q, k and v; no_max through its own C entry. -> (O, LSE, scratch)."""
    f32 = q.dtype == k.dtype == v.dtype == torch.float32
    if not (f32 or q.dtype == k.dtype == v.dtype == torch.bfloat16):
        raise TypeError(f"K8 takes bfloat16 or fp32 q, k and v of one dtype, got {q.dtype}, "
                        f"{k.dtype}, {v.dtype}")
    meta, plan = _int8_plan((q.shape, q.stride()), (k.shape, k.stride()),
                            (v.shape, v.stride()), pv8, f32, no_max)
    b, tq, _, h = meta[:4]
    qp, kp, vp = q.data_ptr(), k.data_ptr(), v.data_ptr()
    if (qp | kp | vp) % 16:
        raise ValueError("K8's tensor maps and loads need 16-byte aligned q, k and v")
    if not (q.is_cuda and q.device == k.device == v.device):
        raise ValueError(f"K8 takes tensors on the card, all on one, got q on {q.device}, "
                         f"k on {k.device}, v on {v.device}")
    if scratch is None:
        scratch = q.new_empty(meta[-1], dtype=torch.uint8)
    elif scratch.numel() < meta[-1] or scratch.dtype != torch.uint8:
        raise ValueError(f"K8's scratch needs {meta[-1]} bytes")
    o = q.new_empty((b, tq, h, 64))
    lse = q.new_empty((b, h, tq), dtype=torch.float32)
    card = q.get_device()
    fn = "kwt_flash_attention_int8_nomax" if no_max else "kwt_flash_attention_int8"
    rc = _build.function("flash_attention_int8", fn)(
        card, qp, kp, vp, o.data_ptr(), lse.data_ptr(), scratch.data_ptr(), plan, phases,
        _build.stream_handle(card))
    if rc != 0:
        raise RuntimeError(f"K8 int8 attention ({'qkpv' if pv8 else 'qk'}"
                           f"{', no-max' if no_max else ''}) launch failed: cudaError {rc}")
    return o, lse, scratch


def int8_prepass(q, k, v, *, mode, no_max=False):
    """K8's quantize pre-pass alone on the card (not counted in
    `flash_attention_int8.launches`: it checks and times the pre-pass);
    no_max: with the key bound's max. -> its outputs as
    `int8_prepass_reference` lays them out, viewed in the scratch."""
    pv8 = mode == "qkpv"
    _, _, scratch = _flash_int8_sm90(q, k, v, pv8, phases=1, no_max=no_max)
    b, _, tk, h, tk_pad, ks_off, v8t_off, vs_off, kn_off, kmax_off, _ = _int8_plan(
        (q.shape, q.stride()), (k.shape, k.stride()), (v.shape, v.stride()), pv8,
        q.dtype == torch.float32, no_max)[0]

    def view(off, dtype, shape):
        n = math.prod(shape) * torch.empty((), dtype=dtype).element_size()
        return scratch[off:off + n].view(dtype).view(shape)

    out = (view(0, torch.int8, (b, tk, h, 64)), view(ks_off, torch.float32, (b, h, tk_pad)))
    out += ((view(v8t_off, torch.int8, (b, h, 64, tk_pad)),
             view(vs_off, torch.float32, (b, h, 64))) if pv8 else (None, None))
    if no_max:
        out += (view(kn_off, torch.float32, (b, h, tk_pad)), view(kmax_off, torch.float32, (b, h)))
    return out


def _int8_twin(q, k, v, pv8, no_max):
    """K8's plain twin from q, k and v: K (and, for qkpv, V) quantized by
    torch ops, as the JAX package quantizes them in XLA."""
    k8, ks = quantize_k_rows(k)
    v_in, vs = quantize_v_cols(v) if pv8 else (v, None)
    return flash_attention_int8_reference(q, k8, ks, v_in, vs, pv8, no_max)


def flash_attention_int8(q, k, v, *, mode, no_max=None):
    """K8 wrapper: for CUDA tensors the quantize pre-pass and the kernel
    (two launches, three with no_max's key bound, one count); for CPU
    tensors K (and, for qkpv, V) quantized with torch ops, as the JAX
    package does it in XLA, and the plain twin. no_max None reads
    KWT_FA_NOMAX. -> (O, LSE) as flash_attention_fwd."""
    if mode not in ("qk", "qkpv"):
        raise ValueError(f"K8 modes are 'qk' and 'qkpv', got {mode!r}")
    if no_max is None:
        no_max = read_switches()[0]
    pv8 = mode == "qkpv"
    if q.device.type == "cpu":
        return _int8_twin(q, k, v, pv8, no_max)
    o, lse, _ = _flash_int8_sm90(q, k, v, pv8, no_max=no_max)
    flash_attention_int8.launches += 1
    flash_attention_int8.nomax_launches += int(no_max)
    return o, lse


flash_attention_int8.launches = 0        # K8, both modes
flash_attention_int8.nomax_launches = 0  # its no-max forms (also counted in launches)


def attention_delta(o, do):
    """D = rowsum(dO * O) in fp32, (B, H, Tq): the plain twin's D (the
    JAX package computes it in XLA; on the card K5's pre-pass does)."""
    return (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()


def flash_attention_bwd_reference(q, k, v, o, lse, do, *, causal):
    """Plain twin of K5, step by step in fp32 in the order of the JAX
    package's `_bwd_dq_kernel` and `_bwd_dkv_kernel` (not autograd): P from
    the saved LSE, dP = dO V^T, dS = P (dP - D); P and dS are cast to the
    input dtype before their products, and dQ is multiplied by the scale
    at the end. -> (dQ, dK, dV) in q's, k's and v's dtypes."""
    in_dtype = q.dtype
    scale = 1.0 / q.shape[-1] ** 0.5
    qs, s = _scores(q, k, causal)
    p = torch.exp(s - lse[..., None])
    dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), v.float())
    ds = (p * (dp - attention_delta(o, do)[..., None])).to(in_dtype).float()
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, k.float()) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qs.float())
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(in_dtype).float(), do.float())
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _flash_bwd_sm90(q, k, v, o, lse, do, causal):
    """K5 on the card: dtypes, layouts, addresses and device checked,
    outputs and scratch allocated, one C call: the bf16 form (three
    launches, two where dQ is direct) or, for fp32 q, k, v, o and do, the
    fp32 one (one launch for a causal call of at most 8 key tiles, else
    three)."""
    f32 = q.dtype == k.dtype == v.dtype == o.dtype == do.dtype == torch.float32
    if not ((f32 or q.dtype == k.dtype == v.dtype == o.dtype == do.dtype == torch.bfloat16)
            and lse.dtype == torch.float32):
        raise TypeError(f"K5 takes bfloat16 or fp32 q, k, v, o and do of one dtype and an fp32 "
                        f"lse, got {q.dtype}, {k.dtype}, {v.dtype}, {o.dtype}, {do.dtype}, "
                        f"{lse.dtype}")
    (b, tq, tk, h, n_scratch), plan = (_bwd_f32_plan if f32 else _bwd_plan)(
        (q.shape, q.stride()), (k.shape, k.stride()), (v.shape, v.stride()),
        (o.shape, o.stride()), (do.shape, do.stride()), (lse.shape, lse.stride()), causal)
    qp, kp, vp, op, dop = q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr()
    if (qp | kp | vp | op | dop) % 16:
        raise ValueError("K5's tensor maps and loads need 16-byte aligned q, k, v, o and do")
    if not (q.is_cuda and q.device == k.device == v.device == o.device == do.device
            == lse.device):
        raise ValueError(f"K5 takes tensors on the card, all on one, got q on {q.device}, k on "
                         f"{k.device}, v on {v.device}, o on {o.device}, do on {do.device}, "
                         f"lse on {lse.device}")
    dq = q.new_empty((b, tq, h, 64))
    dkv = q.new_empty((2, b, tk, h, 64))  # one TMA store map covers dK and dV (bf16)
    scratch = lse.new_empty(n_scratch)
    card = q.get_device()
    entry = (("flash_attention_bwd_f32", "kwt_flash_attention_bwd_f32") if f32
             else ("flash_attention_bwd", "kwt_flash_attention_bwd"))
    rc = _build.function(*entry)(
        card, qp, kp, vp, op, dop, lse.data_ptr(), dq.data_ptr(), dkv.data_ptr(),
        scratch.data_ptr(), plan, _build.stream_handle(card))
    if rc != 0:
        raise RuntimeError(f"K5 flash attention backward{' (fp32)' if f32 else ''} launch "
                           f"failed: cudaError {rc}")
    flash_attention_bwd.launches += 1
    return (dq, *dkv.unbind(0))


def flash_attention_bwd(q, k, v, o, lse, do, *, causal):
    """K5 wrapper: the kernel for CUDA tensors, the plain twin for CPU
    tensors. -> (dQ, dK, dV)."""
    if q.device.type == "cpu":
        return flash_attention_bwd_reference(q, k, v, o, lse, do, causal=causal)
    return _flash_bwd_sm90(q, k, v, o, lse, do, causal)


flash_attention_bwd.launches = 0  # K5 calls


class FlashAttention(torch.autograd.Function):
    """Forward through K1/K4 (or K8 under an int8 mode), backward through
    K5; saves (q, k, v, O, LSE) as the JAX package's custom_vjp does."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        o, lse = flash_attention_fwd(q, k, v, causal=causal)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal = causal
        return o

    @staticmethod
    def backward(ctx, do):
        # K5 reads q, k, v and o through their strides, as the forward
        # does, so fused projections' column blocks go in without copies;
        # autograd may hand over an expanded (stride 0) do
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do.contiguous(), causal=ctx.causal)
        return dq, dk, dv, None


def flash_attention(q, k, v, *, causal=False):
    """(B, Tq, H, D) x (B, Tk, H, D) -> (B, Tq, H, D); softmax(QK^T/sqrt(D))V,
    differentiable. causal requires Tq == Tk (the model's only causal use,
    decoder self-attention over a full block)."""
    if causal and q.shape[1] != k.shape[1]:
        raise ValueError("causal flash attention requires Tq == Tk")
    return FlashAttention.apply(q, k, v, causal)
