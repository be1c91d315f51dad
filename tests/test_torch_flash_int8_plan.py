"""K8's arithmetic, layouts and plan, on the CPU (csrc/flash_attention_int8.cu).

- V8^T's key order (`V8T_KEY_ORDER`) is a bijection on every 32-key group,
  and it is the order in which the kernel's `pack_p8` lays a thread's s32
  score accumulators into the s8 A fragment of the P V product: P V taken
  with the permuted V8^T and the accumulator-order P equals the plain
  product exactly in integers.
- The kernel's arithmetic shortcuts, emulated in fp32: round(p * 127)
  through adding 1.5 * 2^23 equals torch.round (half to even) on a dense
  grid of p in [0, 1], ties included; the quantizers' x / d taken as x
  times the rounded reciprocal, with the true quotient where the product
  lies near a half, rounds as round(x / d) does; and the epilogue's x / l
  taken the same way rounds to the same bf16.
- A pure-torch walk in the kernel's work-item and tile order (qk: one
  pass, online softmax in log2 units; qkpv: the row max in a first pass,
  then P against it), fed the twin's quantized inputs, equals the JAX
  package's `_fwd_kernel_single_int8` in Pallas interpret mode in fp32
  (atol and rtol 1e-4, the bound of tests/test_torch_flash_int8.py: the
  walk takes exp2 of log2-scaled scores where the TPU kernel takes exp),
  with ragged query and key tiles; in bf16 it stays within the card
  test's bounds of the plain twin (the online softmax rounds P to bf16
  against a running max).
- The pre-pass's twin lays out the twin quantizers' outputs as the kernel
  writes them, and `_int8_plan` packs shapes, strides and scratch offsets,
  rejects what the kernel cannot read, and the wrapper checks addresses
  before it looks at the device.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kotoba_whisper_tpu.ops import flash_attention as jfa
from kotoba_whisper_tpu_torch.ops import flash_attention as fa

LOG2E = torch.tensor(1.4426950408889634, dtype=torch.float32)
MAGIC = 12582912.0  # 1.5 * 2^23
INV127 = torch.tensor(1.0 / 127.0, dtype=torch.float32)
# csrc/flash_attention_int8.cu `pack_p8`: the accumulator entries b[4j + e]
# (n8 block j of the 32-key step, column 8j + 2t + (e & 1), row e >> 1)
# packed into bytes 0..3 of A registers 0..3 (registers 0 and 2 row lane/4,
# 1 and 3 row lane/4 + 8; logical k = 16 (reg >> 1) + 4t + byte)
PACK_P8 = ((0, 1, 4, 5), (2, 3, 6, 7), (8, 9, 12, 13), (10, 11, 14, 15))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny CPU tensors: one intra-op thread, so torch's thread pool does
    not spin-wait on cores the parallel test workers oversubscribe."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---- the V8^T key order ----------------------------------------------------------


def test_v8t_key_order_is_a_bijection_on_each_group():
    assert sorted(fa.V8T_KEY_ORDER) == list(range(32))
    perm = np.array(fa.V8T_KEY_ORDER)
    for tk_pad in (128, 1536):
        full = (np.arange(tk_pad) // 32) * 32 + perm[np.arange(tk_pad) % 32]
        assert sorted(full) == list(range(tk_pad))


@pytest.mark.parametrize("t", range(4))
def test_pack_p8_slots_hold_the_v8t_keys(t):
    """For each lane quad position t, the key `pack_p8` puts at logical k
    of a 32-key step is V8T_KEY_ORDER[k], in the row the register
    belongs to."""
    for reg, slots in enumerate(PACK_P8):
        for byte, idx in enumerate(slots):
            j, e = divmod(idx, 4)
            key, row = 8 * j + 2 * t + (e & 1), e >> 1
            assert row == reg & 1, (reg, byte)
            assert key == fa.V8T_KEY_ORDER[16 * (reg >> 1) + 4 * t + byte], (reg, byte)


@pytest.mark.parametrize("tk", [1, 70, 128, 300])
def test_permuted_pv_equals_plain_product(tk):
    """P8 (rows x keys) V8 (keys x 64) taken as the kernel takes it: V8^T
    from the pre-pass's twin (keys permuted and zero-padded) against P8 in
    accumulator order, equals P8 V8 exactly in integers."""
    rng = np.random.default_rng(tk)
    v = torch.from_numpy(rng.standard_normal((1, tk, 1, 64)).astype(np.float32))
    _, _, v8t, _ = fa.int8_prepass_reference(v, v, True)
    v8, _ = fa.quantize_v_cols(v)
    p8 = torch.from_numpy(rng.integers(0, 128, (40, tk))).long()
    tk_pad = v8t.shape[-1]
    p8_pad = torch.nn.functional.pad(p8, (0, tk_pad - tk))
    order = torch.tensor(fa.V8T_KEY_ORDER)
    # logical k of each 32-key step holds the accumulator entry of key ORDER[k]
    a = p8_pad.view(40, tk_pad // 32, 32)[..., order].reshape(40, tk_pad)
    got = a @ v8t[0, 0].long().T
    want = p8 @ v8[0, :, 0].long()
    assert torch.equal(got, want)
    # pad keys hold zeros wherever the order places them
    pad_pos = (torch.arange(tk_pad) // 32) * 32 + order[torch.arange(tk_pad) % 32] >= tk
    assert not v8t[0, 0][:, pad_pos].any()


# ---- the full-rate rounding ----------------------------------------------------------


def test_magic_round_of_p127_is_round_half_even():
    grid = (torch.arange(0, (1 << 22) + 1, dtype=torch.float64) / (1 << 22)).float()
    # p whose p * 127 lands on or next to a half: n + 0.5 for every level
    near = torch.tensor([(n + 0.5) / 127 for n in range(127)], dtype=torch.float32)
    ties = [near]
    for _ in range(3):
        ties += [torch.nextafter(ties[-2 if len(ties) > 1 else 0], torch.tensor(0.0)),
                 torch.nextafter(ties[-1], torch.tensor(1.0))]
    p = torch.cat([grid, *ties]).clamp(0, 1)
    y = p * 127.0                      # one fp32 rounding, as __fmul_rn
    word = (y + MAGIC)                 # one more, as __fadd_rn
    got = word - MAGIC
    want = torch.round(y)              # the twin's round: half to even
    assert torch.equal(got, want)
    assert torch.equal(word.view(torch.int32) & 0xFF, want.int())  # the byte the kernel packs
    half = y - y.floor() == 0.5
    assert bool(half.any()), "no tie in the grid"
    assert {int(v) % 2 for v in y[half].floor()} == {0, 1}


def _ulps(x, n):
    """x moved n fp32 ulps (n may be negative)."""
    return (x.view(torch.int32) + n).view(torch.float32)


def test_reciprocal_quantize_rounds_as_the_true_quotient():
    """`quant_words`: rint(x * (1/d)) where that product lies 2.4e-4 or more
    from a half, rint(x / d) where it does not, equals torch.round(x / d),
    on random rows and on quotients placed on and a few ulps around every
    half-integer level."""
    rng = np.random.default_rng(8)
    x = torch.from_numpy(rng.standard_normal((4096, 64)).astype(np.float32))
    x *= torch.from_numpy(10.0 ** rng.uniform(-6, 3, (4096, 1)).astype(np.float32))
    d = torch.clamp(x.abs().amax(-1, keepdim=True), min=1e-8) * INV127
    halves = torch.arange(-127, 127, dtype=torch.float32) + 0.5
    near = torch.cat([_ulps(halves[None, :] * d[:64], n) for n in range(-3, 4)], 0)
    xs = torch.cat([x.flatten(), near.flatten()])
    ds = torch.cat([d.expand_as(x).flatten(), d[:64].repeat(7, 1).expand_as(near).flatten()])
    y = xs * (1.0 / ds)
    n = (y + MAGIC) - MAGIC
    fall = ((y - n).abs() - 0.5).abs() < 2.4e-4
    got = torch.where(fall, torch.round(xs / ds), n)
    assert torch.equal(got, torch.round(xs / ds))
    assert bool(fall[x.numel():].any()) and float(fall[: x.numel()].float().mean()) < 1e-2


def test_reciprocal_division_rounds_to_the_same_bf16():
    """`div_for_bf16`: x * (1/l) where its low 16 bits lie outside 16 ulps
    of 0x8000, x / l where they do not, rounds to the bf16 of x / l, on
    random values and on quotients placed a few ulps around bf16 rounding
    boundaries."""
    rng = np.random.default_rng(9)
    x = torch.from_numpy((rng.standard_normal(1 << 20) * 10.0 ** rng.uniform(-8, 4, 1 << 20))
                         .astype(np.float32))
    lv = torch.from_numpy(10.0 ** rng.uniform(-6, 6, 1 << 20).astype(np.float32))
    q = x / lv
    edge = ((q.view(torch.int32) & ~0xFFFF) | 0x8000).view(torch.float32)
    xb = torch.cat([x] + [_ulps(edge, n) * lv for n in range(-3, 4)])
    lb = lv.repeat(8)
    y = xb * (1.0 / lb)
    low = y.view(torch.int32) & 0xFFFF
    near = (low >= 0x7FF0) & (low < 0x8010)
    got = torch.where(near, xb / lb, y).to(torch.bfloat16)
    assert torch.equal(got, (xb / lb).to(torch.bfloat16))
    assert bool(near.any())


# ---- the walk ------------------------------------------------------------------------


def _fma(a, b, c):
    """fp32 a * b + c with one rounding (the product is exact in float64)."""
    return (a.double() * b.double() + c.double()).float()


def k8_walk(q, k8, ks, v_in, vs, pv8):
    """K8's main kernel in its order: 128-row query tiles of each (batch,
    head) (every head at once), q quantized per row, 128-key tiles of
    s32 = Q8 K8^T converted to fp32 (cvt) and dequantized as s32 *
    ((qs / 8) * ks), keys past tk masked; qk: the online softmax in log2
    units, P in q's dtype times V, O rescaled by exp2(m_old - m_new); qkpv:
    the row max over every tile, then p = exp2(s log2(e) - m log2(e)), p8
    by adding 1.5 * 2^23, integer P V, times (1/127) * vs; O / l_safe.
    -> (O (B, Tq, H, 64) in q's dtype, LSE (B, H, Tq))."""
    dtype = q.dtype
    b, tq, h, d = q.shape
    tk = k8.shape[1]
    qf = q.float().transpose(1, 2)                       # (B, H, Tq, 64)
    k8f = k8.double().transpose(1, 2)                    # (B, H, Tk, 64)
    vt = (v_in.double() if pv8 else v_in.float()).transpose(1, 2)
    o = torch.empty(b, h, tq, d)
    lse = torch.empty(b, h, tq)
    tile = fa.INT8_KTILE
    for q0 in range(0, tq, 128):
        rows = qf[:, :, q0:q0 + 128]
        qs = torch.clamp(rows.abs().amax(-1, keepdim=True), min=1e-8) * INV127
        q8 = torch.round(rows / qs).double()
        qsc = qs * 0.125

        def scores(k0):
            s32 = (q8 @ k8f[:, :, k0:k0 + tile].transpose(-1, -2)).round()
            s = s32.float() * (qsc * ks[:, :, None, k0:k0 + tile])
            if k0 + tile > tk:  # the ragged last tile: the kernel masks keys past tk
                s = torch.nn.functional.pad(s, (0, k0 + tile - tk), value=float("-inf"))
            return s

        n_rows = rows.shape[2]
        l_run = torch.zeros(b, h, n_rows, 1)
        if pv8:
            m = torch.full((b, h, n_rows, 1), float("-inf"))
            for k0 in range(0, tk, tile):
                m = torch.maximum(m, scores(k0).amax(-1, keepdim=True))
            m_log2 = m * LOG2E
            acc = torch.zeros(b, h, n_rows, d, dtype=torch.float64)
            for k0 in range(0, tk, tile):
                p = torch.exp2(_fma(scores(k0), LOG2E, -m_log2))
                l_run += p.sum(-1, keepdim=True)
                p8 = (p * 127.0 + MAGIC) - MAGIC
                acc += p8[..., : tk - k0].double() @ vt[:, :, k0:k0 + tile]
            out = acc.float() * (INV127 * vs[:, :, None, :])
            lse_t = m
        else:
            m_run = torch.full((b, h, n_rows, 1), float("-inf"))
            acc = torch.zeros(b, h, n_rows, d)
            for k0 in range(0, tk, tile):
                s = scores(k0)
                m_new = torch.maximum(m_run, s.amax(-1, keepdim=True) * LOG2E)
                corr = torch.exp2(m_run - m_new)
                p = torch.exp2(_fma(s, LOG2E, -m_new))
                l_run = l_run * corr + p.sum(-1, keepdim=True)
                acc = acc * corr + p[..., : tk - k0].to(dtype).float() @ vt[:, :, k0:k0 + tile]
                m_run = m_new
            out = acc
            lse_t = m_run * torch.log(torch.tensor(2.0))
        l_safe = torch.clamp(l_run, min=1e-30)
        o[:, :, q0:q0 + 128] = out / l_safe
        lse[:, :, q0:q0 + 128] = (lse_t + torch.log(l_safe))[..., 0]
    return o.transpose(1, 2).to(dtype), lse


def _qkv(seed, b, tq, tk, h):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, t, h, 64)).astype(np.float32) for t in (tq, tk, tk)]


def _to_bh(x):
    b, t, h, d = x.shape
    return jnp.asarray(x).transpose(0, 2, 1, 3).reshape(b * h, t, d)


def _twin_inputs(k, v, pv8):
    k8, ks = fa.quantize_k_rows(k)
    v_in, vs = fa.quantize_v_cols(v) if pv8 else (v, None)
    return k8, ks, v_in, vs


@pytest.mark.parametrize("mode", ["qk", "qkpv"])
@pytest.mark.parametrize("tq, tk", [(200, 300), (130, 1), (70, 260)])
def test_walk_matches_pallas_int8_kernel_fp32(mode, tq, tk):
    b, h = 2, 2
    pv8 = mode == "qkpv"
    q, k, v = _qkv(tq * 7 + tk, b, tq, tk, h)
    qt, kt, vt = map(torch.from_numpy, (q, k, v))
    got_o, got_lse = k8_walk(qt, *_twin_inputs(kt, vt, pv8), pv8)
    bq, bk = jfa._blocks(tq, tk)
    ref_o, ref_lse = jfa._flash_fwd(_to_bh(q), _to_bh(k), _to_bh(v), causal=False, block_q=bq,
                                    block_k=bk, interpret=True, int8_mode=mode)
    ref_o = np.asarray(ref_o).reshape(b, h, tq, 64).transpose(0, 2, 1, 3)
    ref_lse = np.asarray(ref_lse)[..., 0].reshape(b, h, tq)
    np.testing.assert_allclose(got_o.numpy(), ref_o, atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(got_lse.numpy(), ref_lse, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("mode", ["qk", "qkpv"])
def test_walk_matches_plain_twin_bf16(mode):
    """bf16, several query and key tiles: the card test's bounds (max
    |err| 5e-3, relative L2 1e-2, LSE 1e-3)."""
    b, h, tq, tk = 2, 3, 260, 300
    pv8 = mode == "qkpv"
    q, k, v = (torch.from_numpy(x).to(torch.bfloat16) for x in _qkv(5, b, tq, tk, h))
    inputs = _twin_inputs(k, v, pv8)
    got_o, got_lse = k8_walk(q, *inputs, pv8)
    ref_o, ref_lse = fa.flash_attention_int8_reference(q, *inputs, pv8)
    assert got_o.dtype == torch.bfloat16
    a, r = got_o.float(), ref_o.float()
    assert float((a - r).abs().max()) <= 5e-3
    assert float((a - r).norm() / r.norm()) <= 1e-2
    assert float((got_lse - ref_lse).abs().max()) <= 1e-3


def k8_f32_walk(q, k, v, pv8):
    """K8's fp32-q kernel in its order, from the pre-pass's outputs (its
    twin's layout): 64-row query tiles, q quantized per row, 64-key tiles
    of s32 = Q8 K8^T dequantized as s32 * ((qs / 8) * ks), keys past tk
    masked; qk: the online softmax in log2 units with P and V in fp32;
    qkpv: the row max over every tile, then p = exp(s - m), p8 by adding
    1.5 * 2^23, V8 of each key read from V8^T at the kernel's position
    formula, integer P V, times (1/127) * vs; O / l_safe.
    -> (O (B, Tq, H, 64) fp32, LSE (B, H, Tq))."""
    b, tq, h, d = q.shape
    tk = k.shape[1]
    t = 64
    k8, ks, v8t, vs = fa.int8_prepass_reference(k, v, pv8)
    qf = q.transpose(1, 2)
    k8f = k8.double().transpose(1, 2)
    if pv8:  # V8 by key, read from V8^T: position p of a tile holds key
        pos = torch.arange(v8t.shape[-1])
        k32 = pos & 31
        key = (pos & ~31) + 16 * (k32 >> 4) + 8 * ((k32 & 3) >> 1) + 2 * ((k32 >> 2) & 3) + (k32 & 1)
        v8 = torch.empty_like(v8t)
        v8[..., key] = v8t
        vt = v8.transpose(-1, -2).double()               # (B, H, tk_pad, 64)
    else:
        vt = v.transpose(1, 2)
    o, lse = torch.empty(b, h, tq, d), torch.empty(b, h, tq)
    for q0 in range(0, tq, t):
        rows = qf[:, :, q0:q0 + t]
        qs = torch.clamp(rows.abs().amax(-1, keepdim=True), min=1e-8) * INV127
        q8 = torch.round(rows / qs).double()

        def scores(k0):
            s32 = (q8 @ k8f[:, :, k0:k0 + t].transpose(-1, -2)).round()
            s = s32.float() * ((qs * 0.125) * ks[:, :, None, k0:k0 + s32.shape[-1]])
            return s

        n = rows.shape[2]
        l_run = torch.zeros(b, h, n, 1)
        if pv8:
            m = torch.full((b, h, n, 1), float("-inf"))
            for k0 in range(0, tk, t):
                m = torch.maximum(m, scores(k0).amax(-1, keepdim=True))
            acc = torch.zeros(b, h, n, d, dtype=torch.float64)
            for k0 in range(0, tk, t):
                p = torch.exp(scores(k0) - m)
                l_run += p.sum(-1, keepdim=True)
                p8 = (p * 127.0 + MAGIC) - MAGIC
                acc += p8.double() @ vt[:, :, k0:k0 + p.shape[-1]]
            out, lse_t = acc.float() * (INV127 * vs[:, :, None, :]), m
        else:
            m_run = torch.full((b, h, n, 1), float("-inf"))
            acc = torch.zeros(b, h, n, d)
            for k0 in range(0, tk, t):
                sc = scores(k0)
                m_new = torch.maximum(m_run, sc.amax(-1, keepdim=True) * LOG2E)
                corr = torch.exp2(m_run - m_new)
                p = torch.exp2(_fma(sc, LOG2E, -m_new))
                l_run = l_run * corr + p.sum(-1, keepdim=True)
                acc = acc * corr + p @ vt[:, :, k0:k0 + p.shape[-1]]
                m_run = m_new
            out, lse_t = acc, m_run * torch.log(torch.tensor(2.0))
        l_safe = torch.clamp(l_run, min=1e-30)
        o[:, :, q0:q0 + t] = out / l_safe
        lse[:, :, q0:q0 + t] = (lse_t + torch.log(l_safe))[..., 0]
    return o.transpose(1, 2), lse


@pytest.mark.parametrize("mode", ["qk", "qkpv"])
@pytest.mark.parametrize("tq, tk", [(200, 300), (130, 1), (70, 260), (64, 128)])
def test_f32_walk_matches_twin_and_pallas_int8_kernel(mode, tq, tk):
    """The fp32-q form's walk against the plain twin on the twin
    quantizers' codes (1e-5: qkpv's p = exp(s - m) takes the twin's p8
    codes) and against the JAX package's `_fwd_kernel_single_int8` in
    Pallas interpret mode on fp32 inputs (1e-4, as the bf16 walk)."""
    b, h = 2, 2
    pv8 = mode == "qkpv"
    q, k, v = _qkv(tq * 11 + tk, b, tq, tk, h)
    qt, kt, vt = map(torch.from_numpy, (q, k, v))
    got_o, got_lse = k8_f32_walk(qt, kt, vt, pv8)
    ref_o, ref_lse = fa.flash_attention_int8_reference(qt, *_twin_inputs(kt, vt, pv8), pv8)
    torch.testing.assert_close(got_o, ref_o, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(got_lse, ref_lse, atol=1e-5, rtol=1e-5)
    bq, bk = jfa._blocks(tq, tk)
    jo, jlse = jfa._flash_fwd(_to_bh(q), _to_bh(k), _to_bh(v), causal=False, block_q=bq,
                              block_k=bk, interpret=True, int8_mode=mode)
    np.testing.assert_allclose(got_o.numpy(), np.asarray(jo).reshape(b, h, tq, 64).transpose(
        0, 2, 1, 3), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(got_lse.numpy(), np.asarray(jlse)[..., 0].reshape(b, h, tq),
                               atol=1e-4, rtol=1e-4)


def test_f32_form_grid_and_smem():
    """The fp32-q kernel's grid, (64-row query tiles, heads, batch), covers
    every row, and its shared memory (Q8 and K8 words with padded rows, the
    scales, a V or V8 tile and a P or p8 tile) stays under the 48 KB a
    launch may take without raising its limit."""
    words = 2 * 16 * 68 * 4
    smem = words + 2 * 64 * 4 + 64 * 64 * 4 + 64 * 68 * 4
    assert smem <= 48 * 1024
    for tq in (1, 64, 65, 1500):
        n = -(-tq // 64)
        assert (n - 1) * 64 < tq <= n * 64


# ---- the pre-pass's layout and the cached plan -------------------------------------------


@pytest.mark.parametrize("tk", [1, 128, 300])
def test_prepass_reference_lays_out_the_twin_quantizers(tk):
    rng = np.random.default_rng(tk)
    k, v = (torch.from_numpy(rng.standard_normal((2, tk, 3, 64)).astype(np.float32))
            for _ in range(2))
    k8, ks, v8t, vs = fa.int8_prepass_reference(k, v, True)
    rk8, rks = fa.quantize_k_rows(k)
    rv8, rvs = fa.quantize_v_cols(v)
    tk_pad = -(-tk // fa.INT8_KTILE) * fa.INT8_KTILE
    assert ks.shape == (2, 3, tk_pad) and v8t.shape == (2, 3, 64, tk_pad)
    assert torch.equal(k8, rk8) and torch.equal(ks[..., :tk], rks) and not ks[..., tk:].any()
    assert torch.equal(vs, rvs)
    key = (torch.arange(tk_pad) // 32) * 32 + torch.tensor(fa.V8T_KEY_ORDER)[torch.arange(tk_pad) % 32]
    real = key < tk
    assert torch.equal(v8t[..., real], rv8.permute(0, 2, 3, 1)[..., key[real]])
    assert not v8t[..., ~real].any()
    assert fa.int8_prepass_reference(k, v, False)[2:] == (None, None)


def _bf16(*shape):
    return torch.zeros(*shape, dtype=torch.bfloat16)


def _layouts(*ts):
    return tuple((t.shape, t.stride()) for t in ts)


@pytest.mark.parametrize("f32", [False, True])
@pytest.mark.parametrize("pv8", [False, True])
@pytest.mark.parametrize("fused", [False, True])
def test_int8_plan_packs_shapes_strides_and_offsets(fused, pv8, f32):
    """bf16, or fp32 (the fp32-q form: the same scratch, 4-byte strides,
    the flag last)."""
    b, tq, tk, h = 2, 70, 300, 4
    dtype, elem = (torch.float32, 4) if f32 else (torch.bfloat16, 2)
    if fused:
        tq = tk
        q, k, v = (x.reshape(b, tk, h, 64)
                   for x in torch.zeros(b, tk, 3 * h * 64, dtype=dtype).chunk(3, dim=-1))
    else:
        q, k, v = (torch.zeros(b, t, h, 64, dtype=dtype) for t in (tq, tk, tk))
    meta, plan = fa._int8_plan(*_layouts(q, k, v), pv8, f32)
    tk_pad = 384
    ks_off = b * tk * h * 64
    v8t_off = ks_off + b * h * tk_pad * 4
    vs_off = v8t_off + (b * h * 64 * tk_pad if pv8 else 0)
    size = vs_off + (b * h * 64 * 4 if pv8 else 0)
    assert meta == (b, tq, tk, h, tk_pad, ks_off, v8t_off, vs_off, size)
    strides = [s for t in (q, k, v) for s in fa._map_strides(t.shape, t.stride(), elem)]
    if fused:
        assert strides[1] == 3 * h * 64 * elem  # q's token stride: the fused row
    assert list(plan) == [b, tq, tk, h, int(pv8), tk_pad, *strides, ks_off, v8t_off, vs_off,
                          int(f32)]
    assert all(off % 16 == 0 for off in (ks_off, v8t_off, vs_off))
    assert fa._int8_plan(*_layouts(q, k, v), pv8, f32)[1] is plan  # cached per set of layouts


@pytest.mark.parametrize("what", ["token stride", "too many keys", "head dim", "kv shapes"])
def test_int8_plan_rejects_what_the_kernel_cannot_read(what):
    b, t, h = 2, 10, 3
    q, k, v = (_bf16(b, t, h, 64) for _ in range(3))
    if what == "token stride":  # 4 extra elements a token: 8 bytes
        k = _bf16(b * t * (h * 64 + 4)).as_strided((b, t, h, 64), (t * (h * 64 + 4), h * 64 + 4, 64, 1))
    elif what == "too many keys":
        k, v = _bf16(1, fa.SINGLE_STEP_MAX_K + 1, 1, 64), _bf16(1, fa.SINGLE_STEP_MAX_K + 1, 1, 64)
        q = _bf16(1, 8, 1, 64)
    elif what == "head dim":
        q, k, v = (_bf16(b, t, h, 32) for _ in range(3))
    else:
        v = _bf16(b, t + 1, h, 64)
    with pytest.raises(ValueError):
        fa._int8_plan(*_layouts(q, k, v), True)


def test_int8_wrapper_checks_before_the_device():
    """The card path's checks run before it looks at the device, so CPU
    tensors reach them: a float32 input raises TypeError, an address 8
    bytes off ValueError, and well-formed CPU tensors ValueError."""
    b, t, h = 1, 8, 2
    q, k, v = (_bf16(b, t, h, 64) for _ in range(3))
    with pytest.raises(TypeError):
        fa._flash_int8_sm90(q.float(), k, v, False)
    off = _bf16(b * t * h * 64 + 4)[4:].view(b, t, h, 64)
    for args in ((off, k, v), (q, off, v), (q, k, off)):
        with pytest.raises(ValueError, match="16-byte aligned"):
            fa._flash_int8_sm90(*args, True)
    with pytest.raises(ValueError, match="on the card"):
        fa._flash_int8_sm90(q, k, v, True)
