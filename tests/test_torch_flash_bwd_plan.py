"""K5's plan and walk, on the CPU (csrc/flash_attention_bwd.cu).

- `bwd_tile_plan`: the 64-row query tiles each 128-key work item visits
  hold every (query, key) pair the end-aligned mask keeps exactly once,
  no visited tile is dropped whole, and only the tiles that cross the
  diagonal (or hold keys past tk) are masked.
- A pure-torch walk of the backward in the kernel's order (work items,
  query tiles, P and dS rounded where the kernel rounds them, dQ summed in
  fp32 over key tiles, D from the pre-pass's formula) equals the JAX
  package's `_flash_bwd` in Pallas interpret mode in fp32 (atol and rtol
  1e-5: the walk takes exp2 of log2-scaled scores where the TPU kernel
  takes exp, a few fp32 ulps apart), and the plain twin in bf16 within
  the card test's bounds (max |err| <= 1e-2 of the largest magnitude,
  relative L2 <= 1e-2).
- `_bwd_plan` packs shapes and byte strides into the array the C entry
  reads, sizes the scratch (direct dQ for one key tile), and rejects what
  the kernel cannot read, before the device is looked at.
- The fp32 form (csrc/flash_attention_bwd_f32.cu): the split form's dQ
  tiles (over `bwd_f32_dq_parts` key parts) and dK/dV chunks, and the
  causal form's cluster rounds, each visit every kept pair once; their
  walk (both forms' products in 3xTF32, emulated bit for bit in the
  operands; dQ's tile sums added in fp32 and its parts summed in order)
  equals `_flash_bwd` in interpret mode to 1e-5 elementwise and relative
  L2 1e-6, also at the cross call's Tk=1500 and causal past 8 key tiles,
  where TF32 products alone read more than 1e-4 away; shared memory, plan
  and wrapper checks.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kotoba_whisper_tpu.ops import flash_attention as jfa
from kotoba_whisper_tpu_torch.ops import flash_attention as fa

LOG2E = 1.4426950408889634


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny CPU tensors: one intra-op thread, so torch's thread pool does
    not spin-wait on cores the parallel test workers oversubscribe."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---- the tile plan -------------------------------------------------------------


def _plan_cases():
    same = [(t, t) for t in (1, 64, 65, 128, 130, 300)]
    return same + [(70, 1500), (1, 128), (64, 130), (100, 1500), (128, 448), (130, 1500)]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("tq, tk", _plan_cases())
def test_bwd_tile_plan_visits_each_kept_pair_once(tq, tk, causal):
    qt_rows, kt_keys = fa.BWD_QTILE, fa.BWD_KTILE
    rows = np.arange(tq)[:, None]
    keys = np.arange(tk)[None, :]
    kept = keys <= rows + tk - tq if causal else np.ones((tq, tk), bool)
    seen = np.zeros((tq, tk), int)
    n_qt = -(-tq // qt_rows)
    for k0 in range(0, tk, kt_keys):
        qt0, n_tiles, free_from = fa.bwd_tile_plan(tq, tk, k0, causal)
        assert qt0 + n_tiles == n_qt and n_tiles >= 1 and qt0 <= free_from <= n_qt
        for qt in range(n_qt):
            r = slice(qt * qt_rows, min((qt + 1) * qt_rows, tq))
            # the item's 128 key slots, those past tk zero-filled and dropped
            slots = np.arange(k0, k0 + kt_keys)[None, :]
            tile_kept = (slots <= np.arange(tq)[r][:, None] + tk - tq if causal
                         else np.ones_like(slots, bool)) & (slots < tk)
            if qt < qt0:  # not visited: no kept pair there
                assert not tile_kept.any(), (k0, qt)
                continue
            assert tile_kept.any(), (k0, qt)  # no visited tile is dropped whole
            if causal:  # only the tiles that cross the diagonal are masked
                assert tile_kept.all() == (qt >= free_from), (k0, qt)
            seen[r, k0:k0 + kt_keys] += tile_kept[:, : tk - k0]
    np.testing.assert_array_equal(seen, kept.astype(int))


# ---- the walk --------------------------------------------------------------------


def k5_walk(q, k, v, o, lse, do, causal):
    """The backward in K5's order and roundings: D and LSE2 as the
    pre-pass makes them, then for each 128-key item and each 64-row query
    tile of its plan S^T = K Q^T, P^T = exp2(S^T log2(e)/8 - LSE2) (masked
    on the plan's masked tiles and past tk), dP^T = V dO^T, dS^T = P^T (dP^T
    - D), P and dS rounded to the input dtype, dV += P^T dO, dK += dS^T Q,
    and dQ += dS K summed in fp32 over the items; dK and dQ times 1/8 at
    the end. (B, T, H, 64) tensors; every (batch, head) walks at once."""
    dtype = q.dtype
    qf, kf, vf, of, dof = (t.float().transpose(1, 2) for t in (q, k, v, o, do))  # (B, H, T, 64)
    tq, tk = qf.shape[2], kf.shape[2]
    delta = (dof * of).sum(-1)            # the pre-pass: fp32 products summed
    lse2 = lse.float() * LOG2E
    dq_acc = torch.zeros_like(qf)
    dk, dv = torch.zeros_like(kf), torch.zeros_like(vf)
    for k0 in range(0, tk, fa.BWD_KTILE):
        ks = slice(k0, min(k0 + fa.BWD_KTILE, tk))
        kt, vt = kf[:, :, ks], vf[:, :, ks]
        dk_i, dv_i = torch.zeros_like(kt), torch.zeros_like(vt)
        qt0, n_tiles, free_from = fa.bwd_tile_plan(tq, tk, k0, causal)
        for qt in range(qt0, qt0 + n_tiles):
            rs = slice(qt * fa.BWD_QTILE, min((qt + 1) * fa.BWD_QTILE, tq))
            qr, dor = qf[:, :, rs], dof[:, :, rs]
            x = kt @ qr.transpose(-1, -2) * (0.125 * LOG2E) - lse2[:, :, None, rs]
            if causal and qt < free_from:
                key = torch.arange(ks.start, ks.stop)[:, None]
                row = torch.arange(rs.start, rs.stop)[None, :]
                x = x.masked_fill(key > row + tk - tq, float("-inf"))
            p = torch.exp2(x)
            ds = p * (vt @ dor.transpose(-1, -2) - delta[:, :, None, rs])
            p_r, ds_r = p.to(dtype).float(), ds.to(dtype).float()
            dv_i += p_r @ dor
            dk_i += ds_r @ qr
            dq_acc[:, :, rs] += ds_r.transpose(-1, -2) @ kt
        dk[:, :, ks], dv[:, :, ks] = dk_i * 0.125, dv_i
    return tuple((t.transpose(1, 2)).to(dtype) for t in (dq_acc * 0.125, dk, dv))


def _inputs(seed, b, tq, tk, h=2, d=64):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, t, h, d)).astype(np.float32) for t in (tq, tk, tk, tq)]


def _to_bh(x):
    b, t, h, d = x.shape
    return jnp.asarray(x).transpose(0, 2, 1, 3).reshape(b * h, t, d)


def _from_bh(x, b, h):
    bh, t, d = x.shape
    return np.asarray(x).reshape(b, h, t, d).transpose(0, 2, 1, 3)


@pytest.mark.parametrize("tq, tk, causal", [(130, 130, True), (70, 300, False)])
def test_walk_matches_jax_kernels_fp32(tq, tk, causal):
    b, h = 2, 2
    q, k, v, g = _inputs(tq * 5 + tk, b, tq, tk, h)
    qt, kt, vt, gt = map(torch.from_numpy, (q, k, v, g))
    o, lse = fa.flash_attention_fwd(qt, kt, vt, causal=causal)
    got = k5_walk(qt, kt, vt, o, lse, gt, causal)
    bq, bk = jfa._blocks(tq, tk)
    ref = jfa._flash_bwd(
        _to_bh(q), _to_bh(k), _to_bh(v), _to_bh(o.numpy()),
        jnp.asarray(lse.numpy()).reshape(b * h, tq, 1), _to_bh(g),
        causal=causal, block_q=bq, block_k=bk, interpret=True,
    )
    for name, a, r in zip(("dq", "dk", "dv"), got, ref):
        np.testing.assert_allclose(a.numpy(), _from_bh(r, b, h), atol=1e-5, rtol=1e-5,
                                   err_msg=name)


@pytest.mark.parametrize("tq, tk, causal", [(130, 130, True), (128, 128, True), (70, 1500, False)])
def test_walk_matches_plain_twin_bf16(tq, tk, causal):
    b, h = 2, 3
    q, k, v, g = (torch.from_numpy(x).to(torch.bfloat16) for x in _inputs(tq + tk, b, tq, tk, h))
    o, lse = fa.flash_attention_fwd(q, k, v, causal=causal)
    got = k5_walk(q, k, v, o, lse, g, causal)
    ref = fa.flash_attention_bwd_reference(q, k, v, o, lse, g, causal=causal)
    for name, a, r in zip(("dq", "dk", "dv"), got, ref):
        assert a.dtype == torch.bfloat16 and a.shape == r.shape
        a, r = a.float(), r.float()
        err = float((a - r).abs().max())
        assert err <= 1e-2 * float(r.abs().max()), (name, err)
        assert float((a - r).norm() / r.norm()) <= 1e-2, name


# ---- the cached plan ---------------------------------------------------------------


def _bf16(*shape):
    return torch.zeros(*shape, dtype=torch.bfloat16)


def _layouts(*ts):
    return tuple((t.shape, t.stride()) for t in ts)


@pytest.mark.parametrize("causal, tk", [(True, 130), (True, 128), (False, 300)])
def test_bwd_plan_packs_shapes_strides_and_scratch(causal, tk):
    """Fused qkv column views (causal) or a q and fused kv views (cross)
    for q, k, v; contiguous o and do."""
    b, tq, h = 2, 128 if tk == 128 else 130, 4
    if causal:
        tq = tk
        q, k, v = (x.reshape(b, tq, h, 64) for x in _bf16(b, tq, 3 * h * 64).chunk(3, dim=-1))
    else:
        q = _bf16(b, tq, h, 64)
        k, v = (x.reshape(b, tk, h, 64) for x in _bf16(b, tk, 2 * h * 64).chunk(2, dim=-1))
    o, do = _bf16(b, tq, h, 64), _bf16(b, tq, h, 64)
    lse = torch.zeros(b, h, tq)
    (bb, tq_, tk_, hh, n_scratch), plan = fa._bwd_plan(*_layouts(q, k, v, o, do, lse), causal)
    assert (bb, tq_, tk_, hh) == (b, tq, tk, h)
    direct = tk <= fa.BWD_KTILE
    strides = [s for t in (q, k, v, do, o) for s in fa._map_strides(t.shape, t.stride(), 2)]
    assert list(plan) == [b, tq, tk, h, int(causal), int(direct), *strides]
    n_qt = math.ceil(tq / fa.BWD_QTILE)
    rows = b * h * n_qt * fa.BWD_QTILE
    assert n_scratch == 2 * rows + (0 if direct else rows * 64)


@pytest.mark.parametrize("what", ["token stride", "o shape", "lse layout", "causal tq > tk",
                                  "head dim"])
def test_bwd_plan_rejects_what_the_kernel_cannot_read(what):
    b, t, h = 2, 10, 3
    q, k, v, o, do = (_bf16(b, t, h, 64) for _ in range(5))
    lse = torch.zeros(b, h, t)
    causal = False
    if what == "token stride":  # 4 extra elements a token: 8 bytes
        q = _bf16(b * t * (h * 64 + 4)).as_strided((b, t, h, 64), (t * (h * 64 + 4), h * 64 + 4, 64, 1))
    elif what == "o shape":
        o = _bf16(b, t + 1, h, 64)
    elif what == "lse layout":
        lse = torch.zeros(b, t, h).transpose(1, 2)
    elif what == "causal tq > tk":
        k, v, causal = _bf16(b, t - 1, h, 64), _bf16(b, t - 1, h, 64), True
    else:
        q, k, v, o, do = (_bf16(b, t, h, 32) for _ in range(5))
    with pytest.raises(ValueError):
        fa._bwd_plan(*_layouts(q, k, v, o, do, lse), causal)


def test_bwd_wrapper_raises_on_misaligned_address_before_the_device():
    """The card path's checks run before it looks at the device, so CPU
    tensors reach them: an address 8 bytes off raises ValueError."""
    b, t, h = 1, 8, 2
    q = _bf16(b * t * h * 64 + 4)[4:].view(b, t, h, 64)
    k, v, o, do = (_bf16(b, t, h, 64) for _ in range(4))
    with pytest.raises(ValueError, match="16-byte aligned"):
        fa._flash_bwd_sm90(q, k, v, o, torch.zeros(b, h, t), do, False)
    with pytest.raises(TypeError):
        fa._flash_bwd_sm90(q.float(), k, v, o, torch.zeros(b, h, t), do, False)


# ---- the fp32 form (csrc/flash_attention_bwd_f32.cu) ---------------------------------


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("tq, tk", [(1, 1), (64, 64), (65, 65), (128, 128), (130, 130),
                                    (70, 300), (128, 1500), (1, 130), (600, 600), (513, 1500)])
def test_bwd_f32_tiles_cover_each_kept_pair_once(tq, tk, causal):
    """The split form: the dQ items' 32-key tiles (per 128-row tile, over
    its key parts, `bwd_f32_dq_tiles`) and the dK/dV items' 32-row chunks
    (per 128 keys, from `bwd_f32_dkv_first_chunk` to the last) each visit
    every (query, key) pair the end-aligned mask keeps exactly once, and no
    visited tile or chunk holds no kept pair for the items' rows or keys."""
    rows, keys = np.arange(tq)[:, None], np.arange(tk)[None, :]
    kept = keys <= rows + tk - tq if causal else np.ones((tq, tk), bool)
    by_dq, by_dkv = np.zeros((tq, tk), int), np.zeros((tq, tk), int)
    qr, kk = fa.BWD_F32_DQ_ROWS, fa.BWD_F32_DQ_KEYS
    parts = fa.bwd_f32_dq_parts(2, tq, tk, 3)
    for qt in range(-(-tq // qr)):
        spans = [fa.bwd_f32_dq_tiles(tq, tk, qt, p, parts, causal) for p in range(parts)]
        assert all(a[1] <= b[0] or b[0] >= b[1] for a, b in zip(spans, spans[1:]))
        for j0, j1 in spans:
            for j in range(j0, j1):
                tile = kept[qt * qr:qt * qr + qr, j * kk:j * kk + kk]
                assert tile.any(), (qt, j)
                by_dq[qt * qr:qt * qr + qr, j * kk:j * kk + kk] += tile
    kb, cr = fa.BWD_F32_DKV_KEYS, fa.BWD_F32_DKV_ROWS
    for k0 in range(0, tk, kb):
        for c in range(fa.bwd_f32_dkv_first_chunk(tq, tk, k0, causal), -(-tq // cr)):
            chunk = kept[c * cr:c * cr + cr, k0:k0 + kb]
            assert chunk.any(), (k0, c)
            by_dkv[c * cr:c * cr + cr, k0:k0 + kb] += chunk
    np.testing.assert_array_equal(by_dq, kept.astype(int))
    np.testing.assert_array_equal(by_dkv, kept.astype(int))


@pytest.mark.parametrize("b, tq, tk, h", [(8, 128, 1500, 20), (1, 1, 1, 1), (2, 70, 300, 3),
                                          (1, 600, 600, 2), (64, 448, 1500, 20)])
def test_bwd_f32_dq_parts_fill_the_card(b, tq, tk, h):
    """The split form's dQ key parts: 3 at the training cross shape (160
    row tiles: 480 items on 132 SMs); otherwise enough for three items an
    SM unless the key tiles or BWD_F32_MAX_PARTS cap them; the parts' spans
    tile the key tiles, none empty."""
    parts = fa.bwd_f32_dq_parts(b, tq, tk, h)
    items = b * h * -(-tq // fa.BWD_F32_DQ_ROWS)
    n_kt = -(-tk // fa.BWD_F32_DQ_KEYS)
    assert 1 <= parts <= min(n_kt, fa.BWD_F32_MAX_PARTS)
    spans = [fa.bwd_f32_dq_tiles(tq, tk, 0, p, parts, False) for p in range(parts)]
    assert spans[0][0] == 0 and spans[-1][1] == n_kt
    assert all(j0 < j1 for j0, j1 in spans)
    assert all(a[1] == b_[0] for a, b_ in zip(spans, spans[1:]))
    if items * parts < 3 * fa.N_SMS:  # capped: one part more would leave one empty
        per = -(-n_kt // min(n_kt, fa.BWD_F32_MAX_PARTS))
        assert parts == -(-n_kt // per)
    if (b, tq, tk, h) == (8, 128, 1500, 20):
        assert parts == 3 and items * parts == 480


def _tf32(x, nearest=True):
    """fp32 as TF32 (10 mantissa bits): rounded to nearest, ties away from
    zero (the kernel's high part), or truncated (what the tensor core
    reads of a residual's bits)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000 if nearest else bits) & -8192).view(torch.float32)


def _mm3(a, b):
    """a @ b^T in 3xTF32, as both forms' tensor-core products take it (b
    by rows: both operands K-major): each operand a TF32 high part and its
    residual as TF32, a_lo b_hi + a_hi b_lo + a_hi b_hi (a_lo b_lo
    dropped), fp32 sums."""
    b = b.transpose(-1, -2)
    ah, bh = _tf32(a), _tf32(b)
    al, bl = _tf32(a - ah, False), _tf32(b - bh, False)
    return al @ bh + ah @ bl + ah @ bh


def _tf32_only(a, b):
    """a @ b^T on TF32 operands alone (no residual terms)."""
    return _tf32(a) @ _tf32(b.transpose(-1, -2))


def k5_f32_walk(q, k, v, o, lse, do, causal, product=_mm3):
    """The backward in K5's fp32 order (fp32 throughout, every product in
    3xTF32, `product`). The causal form (`bwd_f32_cluster`): CTA c of a
    (batch, head) over keys [64c, 64c + 64) takes the query tiles from
    `bwd_f32_first_qtile` on, one a round: S = (Q / 8) K^T and dP = dO V^T,
    P = exp(S - LSE) masked past the end-aligned bound, dS = P (dP - D)
    with D = rowsum(dO * O), dV += P^T dO, dK += dS^T (Q / 8), and its share
    dS K of the tile's dQ; tile r's dQ is the shares of the round summed in
    rank order, times 1/8. The split form (the cross call, causal past 8
    key tiles): the dQ items' 128-row tiles over their key parts'
    (`bwd_f32_dq_parts`, `bwd_f32_dq_tiles`) 32-key tiles, each tile's dS K
    a sum of its own added to the item's fp32 sum, the item's dQ / 8 summed
    over the parts in part order; the dK/dV items' 64 keys over their
    32-row chunks from `bwd_f32_dkv_first_chunk`, S^T = K (Q / 8)^T and dP^T
    = V dO^T, each chunk's P^T dO and dS^T (Q / 8) a sum of its own added
    to dV and dK in fp32.
    (B, T, H, 64) fp32 tensors; every (batch, head) at once."""
    t = fa.BWD_F32_TILE
    qf, kf, vf, of, dof = (x.float().transpose(1, 2) for x in (q, k, v, o, do))
    tq, tk = qf.shape[2], kf.shape[2]
    qs, delta = qf * 0.125, (dof * of).sum(-1)
    n_ctas = fa.bwd_f32_cluster(tq, tk, causal)
    b, h = qf.shape[:2]

    def p_ds(rs, ks):
        s = product(qs[:, :, rs], kf[:, :, ks])
        keep = torch.ones(s.shape[-2:], dtype=torch.bool)
        if causal:
            keep = (torch.arange(ks.start, ks.stop)[None, :]
                    <= torch.arange(rs.start, rs.stop)[:, None] + tk - tq)
        p = torch.where(keep, torch.exp(s - lse[:, :, rs, None]), 0.0)
        dp = product(dof[:, :, rs], vf[:, :, ks])
        return p, p * (dp - delta[:, :, rs, None])

    dq, dk, dv = torch.zeros_like(qf), torch.zeros_like(kf), torch.zeros_like(vf)
    if n_ctas:
        shares = {}  # (round, rank) -> the CTA's share of the tile's dQ
        for c in range(n_ctas):
            ks = slice(c * t, min(c * t + t, tk))
            for r in range(fa.bwd_f32_first_qtile(tq, tk, c * t, causal), -(-tq // t)):
                rs = slice(r * t, min(r * t + t, tq))
                p, ds = p_ds(rs, ks)
                dv[:, :, ks] += product(p.transpose(-1, -2), dof[:, :, rs].transpose(-1, -2))
                dk[:, :, ks] += product(ds.transpose(-1, -2), qs[:, :, rs].transpose(-1, -2))
                shares[r, c] = product(ds, kf[:, :, ks].transpose(-1, -2))
        for (r, c) in sorted(shares):
            dq[:, :, r * t:min(r * t + t, tq)] += shares[r, c]
        return tuple(x.transpose(1, 2) for x in (dq * 0.125, dk, dv))
    qr, kk = fa.BWD_F32_DQ_ROWS, fa.BWD_F32_DQ_KEYS
    parts = fa.bwd_f32_dq_parts(b, tq, tk, h)
    for qt in range(-(-tq // qr)):
        rs = slice(qt * qr, min(qt * qr + qr, tq))
        for part in range(parts):
            item = torch.zeros_like(dq[:, :, rs])
            j0, j1 = fa.bwd_f32_dq_tiles(tq, tk, qt, part, parts, causal)
            for j in range(j0, j1):
                ks = slice(j * kk, min(j * kk + kk, tk))
                item += product(p_ds(rs, ks)[1], kf[:, :, ks].transpose(-1, -2))
            dq[:, :, rs] += item * 0.125
    kb, cr = fa.BWD_F32_DKV_KEYS, fa.BWD_F32_DKV_ROWS
    for k0 in range(0, tk, kb):
        first = fa.bwd_f32_dkv_first_chunk(tq, tk, k0, causal)
        for k1 in range(k0, min(k0 + kb, tk), 64):  # a consumer's 64 keys
            ks = slice(k1, min(k1 + 64, tk))
            for c in range(first, -(-tq // cr)):
                rs = slice(c * cr, min(c * cr + cr, tq))
                p, ds = p_ds(rs, ks)
                dv[:, :, ks] += product(p.transpose(-1, -2), dof[:, :, rs].transpose(-1, -2))
                dk[:, :, ks] += product(ds.transpose(-1, -2), qs[:, :, rs].transpose(-1, -2))
    return tuple(x.transpose(1, 2) for x in (dq, dk, dv))


def _rel_l2(a, r):
    return float(np.linalg.norm(np.asarray(a, np.float64) - r) / np.linalg.norm(r))


@pytest.mark.parametrize("tq, tk, causal, b, h", [
    (130, 130, True, 2, 2),     # the causal form, ragged
    (65, 200, True, 2, 2),      # the causal form, end-aligned Tq < Tk
    (70, 300, False, 2, 2),     # the split form, ragged
    (130, 1500, False, 1, 2),   # the split form at the cross call's Tk, ragged Tq
    (600, 600, True, 1, 1),     # the split form, causal past 8 key tiles
])
def test_f32_walk_matches_jax_kernels(tq, tk, causal, b, h):
    """K5's fp32 walk (3xTF32 products) against the JAX package's
    `_flash_bwd` in Pallas interpret mode on fp32 inputs (P and dS kept in
    fp32 there too): 1e-5 elementwise and relative L2 <= 1e-6, and against
    the plain twin."""
    q, k, v, g = _inputs(tq * 7 + tk, b, tq, tk, h)
    qt, kt, vt, gt = map(torch.from_numpy, (q, k, v, g))
    o, lse = fa.flash_attention_fwd(qt, kt, vt, causal=causal)
    got = k5_f32_walk(qt, kt, vt, o, lse, gt, causal)
    bq, bk = jfa._blocks(tq, tk)
    ref = jfa._flash_bwd(
        _to_bh(q), _to_bh(k), _to_bh(v), _to_bh(o.numpy()),
        jnp.asarray(lse.numpy()).reshape(b * h, tq, 1), _to_bh(g),
        causal=causal, block_q=bq, block_k=bk, interpret=True,
    )
    for name, a, r in zip(("dq", "dk", "dv"), got, ref):
        np.testing.assert_allclose(a.numpy(), _from_bh(r, b, h), atol=1e-5, rtol=1e-5,
                                   err_msg=name)
        assert _rel_l2(a.numpy(), _from_bh(r, b, h)) <= 1e-6, name
    for name, a, r in zip(("dq", "dk", "dv"), got,
                          fa.flash_attention_bwd_reference(qt, kt, vt, o, lse, gt, causal=causal)):
        torch.testing.assert_close(a, r, atol=1e-5, rtol=1e-5, msg=name)


@pytest.mark.parametrize("tq, tk, causal", [(130, 130, True), (130, 1500, False),
                                            (600, 600, True)])
def test_f32_causal_walk_needs_the_residual_products(tq, tk, causal):
    """Both forms' 3xTF32 products (the causal form's at T=130, the split
    form's at the cross call's Tk and causal past 8 key tiles) hold the
    fp32 twin to relative L2 1e-5 (the card's bar); TF32 products alone, a
    10-bit mantissa, read more than 1e-4 away: the residual terms are what
    keep fp32 parity."""
    q, k, v, g = _inputs(31, 1, tq, tk, 2)
    qt, kt, vt, gt = map(torch.from_numpy, (q, k, v, g))
    o, lse = fa.flash_attention_fwd(qt, kt, vt, causal=causal)
    ref = fa.flash_attention_bwd_reference(qt, kt, vt, o, lse, gt, causal=causal)
    split = k5_f32_walk(qt, kt, vt, o, lse, gt, causal)
    one = k5_f32_walk(qt, kt, vt, o, lse, gt, causal, product=_tf32_only)
    for name, a, b, r in zip(("dq", "dk", "dv"), split, one, ref):
        assert float((a - r).norm() / r.norm()) <= 1e-5, name
        assert float((b - r).norm() / r.norm()) > 1e-4, name


def test_bwd_f32_smem_fits_a_block():
    """The causal form's CTA fits two an SM (233,472 bytes, 1 KB of them
    reserved a CTA): 320 CTAs at B=8, H=20, T=128 in one wave and a fifth.
    (The split form's dQ and dK/dV CTAs, one an SM, are held to the 227 KB
    a block may use by static_asserts on their structs in the C source.)"""
    assert 2 * (fa.BWD_F32_CAUSAL_SMEM + 1024) <= 233472


@pytest.mark.parametrize("tq, tk", [(1, 1), (3, 3), (63, 63), (64, 64), (65, 65), (127, 127),
                                    (128, 128), (130, 130), (448, 448), (512, 512), (1, 128),
                                    (65, 300), (100, 512), (513, 513), (128, 1500)])
def test_bwd_f32_cluster_rounds_cover_each_kept_pair_once(tq, tk):
    """The causal form: a cluster of one CTA a 64-key tile (at most 8, Tk
    <= 512; past that, and for the cross call, the split form); CTA c's
    rounds, from `bwd_f32_first_qtile` to the last query tile, visit every
    kept (query, key) pair once, each visited tile holds a kept pair, the
    owner of every round is a CTA of the cluster (Tq <= Tk), and the CTAs
    whose shares make tile r's dQ are the key tiles the split form's dQ
    kernel walks for it."""
    t = fa.BWD_F32_TILE
    n_ctas = fa.bwd_f32_cluster(tq, tk, True)
    assert fa.bwd_f32_cluster(tq, tk, False) == 0
    n_kt, n_qt = -(-tk // t), -(-tq // t)
    if n_kt > fa.BWD_F32_MAX_CLUSTER:
        assert n_ctas == 0
        return
    assert n_ctas == n_kt and n_qt <= n_ctas
    rows, keys = np.arange(tq)[:, None], np.arange(tk)[None, :]
    kept = keys <= rows + tk - tq
    seen = np.zeros((tq, tk), int)
    takers = {r: [] for r in range(n_qt)}
    for c in range(n_ctas):
        for r in range(fa.bwd_f32_first_qtile(tq, tk, c * t, True), n_qt):
            tile = kept[r * t:r * t + t, c * t:c * t + t]
            assert tile.any(), (r, c)
            seen[r * t:r * t + t, c * t:c * t + t] += tile
            takers[r].append(c)
    np.testing.assert_array_equal(seen, kept.astype(int))
    for r in range(n_qt):
        assert takers[r] == list(range(fa.bwd_f32_key_tiles(tq, tk, r * t, True))), r


def _f32(*shape):
    return torch.zeros(*shape)


@pytest.mark.parametrize("causal, tk", [(True, 130), (False, 300), (True, 600)])
def test_bwd_f32_plan_packs_shapes_strides_and_scratch(causal, tk):
    """Fused qkv column views (causal) or a q and fused kv views (cross),
    contiguous o and do: element strides (batch, token, head) of q, k, v,
    do and o, the form, the dQ key parts, and the split form's scratch: the
    padded LSE and D rows, then with parts each part's dQ."""
    b, h = 2, 4
    tq = tk if causal else 70
    if causal:
        q, k, v = (x.reshape(b, tq, h, 64) for x in _f32(b, tq, 3 * h * 64).chunk(3, dim=-1))
    else:
        q = _f32(b, tq, h, 64)
        k, v = (x.reshape(b, tk, h, 64) for x in _f32(b, tk, 2 * h * 64).chunk(2, dim=-1))
    o, do, lse = _f32(b, tq, h, 64), _f32(b, tq, h, 64), torch.zeros(b, h, tq)
    (bb, tq_, tk_, hh, n_scratch), plan = fa._bwd_f32_plan(*_layouts(q, k, v, o, do, lse), causal)
    assert (bb, tq_, tk_, hh) == (b, tq, tk, h)
    strides = [s for t in (q, k, v, do, o) for s in (t.stride(0), t.stride(1), t.stride(2))]
    cluster = fa.bwd_f32_cluster(tq, tk, causal) > 0  # the causal call of 3 key tiles
    assert cluster == (causal and tk == 130)
    parts = 0 if cluster else fa.bwd_f32_dq_parts(b, tq, tk, h)
    assert parts > 1 or cluster  # few rows: dQ is cut into key parts
    assert list(plan) == [b, tq, tk, h, int(causal), *strides, int(cluster), parts]
    if causal:
        assert strides[1] == 3 * h * 64  # q's token stride: the fused row
    want = 0 if cluster else (2 * b * h * math.ceil(tq / 128) * 128 + parts * b * tq * h * 64)
    assert n_scratch == want
    assert fa._bwd_f32_plan(*_layouts(q, k, v, o, do, lse), causal)[1] is plan


@pytest.mark.parametrize("what", ["token stride", "head dim stride", "o shape", "lse layout",
                                  "causal tq > tk", "head dim"])
def test_bwd_f32_plan_rejects_what_the_kernel_cannot_read(what):
    b, t, h = 2, 10, 3
    q, k, v, o, do = (_f32(b, t, h, 64) for _ in range(5))
    lse = torch.zeros(b, h, t)
    causal = False
    if what == "token stride":  # 2 extra elements a token: not a float4 multiple
        q = _f32(b * t * (h * 64 + 2)).as_strided((b, t, h, 64), (t * (h * 64 + 2), h * 64 + 2, 64, 1))
    elif what == "head dim stride":
        q = _f32(b, t, h, 64).transpose(2, 3).contiguous().transpose(2, 3)
    elif what == "o shape":
        o = _f32(b, t + 1, h, 64)
    elif what == "lse layout":
        lse = torch.zeros(b, t, h).transpose(1, 2)
    elif what == "causal tq > tk":
        k, v, causal = _f32(b, t - 1, h, 64), _f32(b, t - 1, h, 64), True
    else:
        q, k, v, o, do = (_f32(b, t, h, 32) for _ in range(5))
    with pytest.raises(ValueError):
        fa._bwd_f32_plan(*_layouts(q, k, v, o, do, lse), causal)


def test_bwd_f32_wrapper_checks_before_the_device():
    """fp32 q, k, v, o and do take the fp32 form's checks before the
    device is looked at: an address 8 bytes off raises ValueError, a
    well-formed CPU call ValueError (not on the card), a bf16 lse
    TypeError."""
    b, t, h = 1, 8, 2
    q, k, v, o, do = (_f32(b, t, h, 64) for _ in range(5))
    off = _f32(b * t * h * 64 + 2)[2:].view(b, t, h, 64)
    with pytest.raises(ValueError, match="16-byte aligned"):
        fa._flash_bwd_sm90(off, k, v, o, torch.zeros(b, h, t), do, False)
    with pytest.raises(ValueError, match="on the card"):
        fa._flash_bwd_sm90(q, k, v, o, torch.zeros(b, h, t), do, True)
    with pytest.raises(TypeError):
        fa._flash_bwd_sm90(q, k, v, o, torch.zeros(b, h, t, dtype=torch.bfloat16), do, True)
