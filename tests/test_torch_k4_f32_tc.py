"""K4's fp32 form on the tensor cores, on the CPU (csrc/flash_attention_f32.cu
`flash_fwd_f32_causal_kernel`).

The causal kernel runs K1 fp32's 3xTF32 tile steps under the end-aligned
mask (row i sees keys j <= i + Tk - Tq), one warpgroup a CTA: a CTA takes
F32_CAUSAL_ROWS query rows of one (batch, head), the CTAs of the last
query tiles first, and computes the F32_TC_KEYS-key tiles at or below its
last row's bound, masking only those past its first row's bound (and the
ragged last tile past Tk); the tile counts are `causal_tile_plan` at the
fp32 kernel's sizes.

- `schedule` walks the kernel's grid: over Tq == Tk from 1 to 300 and Tq <
  Tk, every query row lies in one CTA, every kept (row, key) pair of the
  brute-force mask (the JAX kernel's `k_pos < valid_len & k_pos <= q_pos
  + offset`) in one of its computed tiles, no computed tile is masked for
  all its rows, the unmasked tiles keep every pair, and no CTA has more
  key tiles than one before it. The fp32 plan visits no key that the bf16
  plan (`causal_tile_plan` at 128 x 128) does not.
- `k4_f32_tc_walk` runs that schedule in the kernel's arithmetic order
  (tests/test_torch_k1_f32_tc.py's per tile) and holds the JAX package's
  `_flash_fwd(causal=True)` in Pallas interpret mode in fp32: O within
  relative L2 1e-6 and the LSE within 1e-5; TF32 products alone, the
  control, read more than 1e-5 away.
"""
import numpy as np
import pytest
import torch

from kotoba_whisper_tpu.ops import flash_attention as jfa
from kotoba_whisper_tpu_torch.ops import flash_attention as fa
from tests.test_torch_k1_f32_tc import LN2, LOG2E, _qkv, _rel, _split, _to_bh

ROWS, KEYS = fa.F32_CAUSAL_ROWS, fa.F32_TC_KEYS


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny CPU tensors: one intra-op thread, so torch's thread pool does
    not spin-wait on cores the parallel test workers oversubscribe."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def schedule(tq, tk):
    """The causal kernel's CTAs of one (batch, head), in launch order: (its
    first row, the tiles it computes, the leading ones it leaves
    unmasked)."""
    n_qt = -(-tq // ROWS)
    return [(r0, *fa.causal_tile_plan(tq, tk, r0, ROWS, KEYS))
            for r0 in ((n_qt - 1 - i) * ROWS for i in range(n_qt))]


def _kept(rows, keys, tq, tk):
    """The JAX kernel's mask over (rows, keys): kept pairs."""
    return (keys[None, :] < tk) & (keys[None, :] <= rows[:, None] + tk - tq)


def _check_schedule(tq, tk):
    seen = np.zeros(tq, int)
    kept_done = np.zeros((tq, tk), bool)
    ctas = schedule(tq, tk)
    assert [n for _, n, _ in ctas] == sorted((n for _, n, _ in ctas), reverse=True)
    for r0, n_tiles, n_free in ctas:
        rows = np.arange(r0, min(r0 + ROWS, tq))
        seen[rows] += 1
        bf16_tiles, _ = fa.causal_tile_plan(tq, tk, r0 - r0 % fa.TILE)  # the bf16 item's
        assert min(n_tiles * KEYS, tk) <= min(bf16_tiles * fa.TILE, tk)
        assert 1 <= n_tiles <= -(-tk // KEYS) and 0 <= n_free <= n_tiles
        for j in range(-(-tk // KEYS)):
            keys = np.arange(j * KEYS, (j + 1) * KEYS)
            kept = _kept(rows, keys, tq, tk)
            if j >= n_tiles:
                assert not kept.any(), (r0, j)
                continue
            assert kept.any(), (r0, j)
            assert kept.all() == (j < n_free), (r0, j)
            kk = keys[keys < tk]
            kept_done[rows[:, None], kk[None, :]] |= kept[:, :kk.size]
    assert (seen == 1).all()
    assert (kept_done == _kept(np.arange(tq), np.arange(tk), tq, tk)).all()


SCHEDULE_CASES = [(1, 1), (63, 63), (64, 64), (65, 65), (127, 127), (128, 128), (129, 129),
                  (192, 192), (300, 300), (1, 300), (37, 200), (64, 65), (100, 300),
                  (128, 300), (129, 257), (200, 256)]


@pytest.mark.parametrize("tq, tk", SCHEDULE_CASES)
def test_schedule_covers_each_kept_pair(tq, tk):
    _check_schedule(tq, tk)


def test_schedule_covers_every_length_to_300():
    """Tq == Tk for every T in 1..300, and Tq < Tk on a grid of both."""
    for t in range(1, 301):
        _check_schedule(t, t)
    for tq in range(1, 301, 23):
        for tk in range(tq + 1, 301, 37):
            _check_schedule(tq, tk)


def k4_f32_tc_walk(q, k, v, *, three=True):
    """K4 fp32's causal kernel in its grid and order, (B, T, H, 64) fp32 ->
    (O (B, Tq, H, 64), LSE (B, H, Tq)); three=False takes TF32 high parts
    alone (the control)."""
    qh, kh, vh = (x.transpose(1, 2) for x in (q, k, v))  # (B, H, T, 64)
    b, h, tq, _ = qh.shape
    tk = kh.shape[2]
    scale_log2 = 0.125 * LOG2E
    n_kt = -(-tk // KEYS)
    pad = n_kt * KEYS - tk
    kh, vh = (torch.nn.functional.pad(x, (0, 0, 0, pad)) for x in (kh, vh))
    out = torch.zeros(b, h, tq, 64)
    lse = torch.zeros(b, h, tq)
    for r0, n_tiles, n_free in schedule(tq, tk):
        rows = torch.arange(r0, r0 + ROWS)
        qt = torch.nn.functional.pad(qh[:, :, r0:r0 + ROWS], (0, 0, 0, ROWS))[:, :, :ROWS]
        q_hi, q_lo = _split(qt)
        m = torch.full((b, h, ROWS), float("-inf"))
        l = torch.zeros(b, h, ROWS)
        o = torch.zeros(b, h, ROWS, 64)
        for j in range(n_tiles):
            keys = torch.arange(j * KEYS, (j + 1) * KEYS)
            kt, vt = kh[:, :, j * KEYS:(j + 1) * KEYS], vh[:, :, j * KEYS:(j + 1) * KEYS]
            k_hi, k_lo = _split(kt)
            v_hi, v_lo = _split(vt)
            s = q_hi @ k_hi.transpose(-1, -2)
            if three:
                s = (s + q_lo @ k_hi.transpose(-1, -2)) + q_hi @ k_lo.transpose(-1, -2)
            if j >= n_free or (j == n_kt - 1 and pad):
                keep = (keys[None, :] < tk) & (keys[None, :] <= rows[:, None] + tk - tq)
                s = s.masked_fill(~keep, float("-inf"))
            m_new = torch.maximum(m, s.amax(-1) * scale_log2)
            corr = torch.exp2(m - m_new)
            m = m_new
            p = torch.exp2(s * scale_log2 - m[..., None])
            l = l * corr + p.sum(-1)
            p_hi, p_lo = _split(p)
            tile = p_hi @ v_hi
            if three:
                tile = (p_lo @ v_hi + p_hi @ v_lo) + tile
            o = o * corr[..., None] + tile
        n = min(ROWS, tq - r0)
        out[:, :, r0:r0 + n] = (o / l[..., None])[:, :, :n]
        lse[:, :, r0:r0 + n] = ((m + torch.log2(l)) * LN2)[:, :, :n]
    return out.transpose(1, 2), lse


def _jax_causal(q, k, v):
    """JAX's `_flash_fwd(causal=True)` in interpret mode at the blocks its
    `_fwd_call` picks -> (O (B, Tq, H, D), LSE (B, H, Tq)) as numpy fp32."""
    b, tq, h, d = q.shape
    block_q, block_k = jfa._blocks(tq, k.shape[1])
    o, lse = jfa._flash_fwd(*(_to_bh(x) for x in (q, k, v)), causal=True, block_q=block_q,
                            block_k=block_k, interpret=True)
    o = np.asarray(o).reshape(b, h, tq, d).transpose(0, 2, 1, 3)
    return o, np.asarray(lse)[..., 0].reshape(b, h, tq)


WALK_CASES = {"train": (2, 128, 128), "ragged": (1, 150, 150), "one": (1, 1, 1),
              "tq<tk": (1, 37, 200), "long": (1, 300, 300), "tile": (2, 64, 65)}


@pytest.mark.parametrize("case", list(WALK_CASES))
def test_walk_matches_jax(case):
    """3xTF32 in the kernel's schedule and order holds JAX's fp32 causal
    kernel to rel-L2 1e-6 (O) and 1e-5 (LSE), where one TF32 product alone
    reads > 1e-5 away."""
    b, tq, tk = WALK_CASES[case]
    q, k, v = _qkv(2 * tq + tk, b, tq, tk)
    ref_o, ref_lse = _jax_causal(q, k, v)
    o, lse = k4_f32_tc_walk(*map(torch.from_numpy, (q, k, v)))
    assert _rel(o, ref_o) <= 1e-6
    np.testing.assert_allclose(lse.numpy(), ref_lse, atol=1e-5, rtol=1e-6)
    one, _ = k4_f32_tc_walk(*map(torch.from_numpy, (q, k, v)), three=False)
    assert _rel(one, ref_o) > 1e-5


def test_walk_matches_the_port_twin():
    """The walk equals the port's plain twin (`flash_attention_reference`)
    as closely, so the card test's twin is the JAX kernel's stand-in."""
    q, k, v = (torch.from_numpy(x) for x in _qkv(5, 2, 130, 130, h=3))
    o, lse = k4_f32_tc_walk(q, k, v)
    ro, rlse = fa.flash_attention_reference(q, k, v, causal=True)
    assert _rel(o, ro) <= 1e-6
    torch.testing.assert_close(lse, rlse, atol=1e-5, rtol=1e-6)
