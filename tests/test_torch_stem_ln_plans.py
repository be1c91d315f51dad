"""The pure-Python planning of the K6 and K7 wrappers, on the CPU.

K7 (ops/conv_stem.py `tap_coords`, `stem_plan`, `stem_tile`,
`tap_major_weights`): each tap's TMA coordinates read input row
stride * i + tap - 1 and read zero outside [0, T); the stem computed the
way the kernel walks it (its tile order, its K steps of 64 channels of one
tap, rows read through the planned coordinates with zero fill, the
tap-major weights) equals the JAX package's Pallas stem in interpret mode
(fp32, within 1e-5: the same products summed in another order, torch's erf
against the kernel's rational erf); the tap-major weights are the JAX
wrapper's `vv01` and `v[2]` layouts; the tile order covers every (batch
element, row tile, column tile) once and no tile crosses a batch element;
the cached tap-major copy is rebuilt after an in-place weight update.
K7's fp32 form (csrc/conv_stem_f32.cu): its walk (3xTF32 products of the
`split_tf32` operands, each 32-channel K step summed apart and added in
fp32) equals the Pallas stem in interpret mode to relative L2 1e-6 where
TF32 products alone read more than 1e-5 away; its tiles cover every output
once; the split weights are exact (hi + lo == w) and cached.

K6 (ops/layer_norm.py `row_schedule`): the persistent grid's warps,
striding over rows, normalise every row exactly once for ragged row counts
and any grid size.
"""
import itertools
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kotoba_whisper_tpu.ops.conv_stem import conv_stem_pallas
from kotoba_whisper_tpu_torch.ops import conv_stem as cs
from kotoba_whisper_tpu_torch.ops import layer_norm as ln


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny CPU tensors: one intra-op thread, so torch's thread pool does
    not spin-wait on cores the parallel test workers oversubscribe."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _read_rows(a, stride, tap, rows):
    """What K7's TMA box reads for tap `tap` at output rows `rows` of one
    batch element's (T, C) input `a`: the planned coordinates, zero filled
    where they fall outside the map (conv1: rows of (T, C); conv2: pairs
    and parities of the (T/2, 2, C) view)."""
    par, off = cs.tap_coords(stride, tap)
    t, c = a.shape
    out = np.zeros((len(rows), c), a.dtype)
    if stride == 1:
        src = rows + off
        ok = (src >= 0) & (src < t)
        out[ok] = a[src[ok]]
    else:
        pairs = a.reshape(t // 2, 2, c)
        src = rows + off
        ok = (src >= 0) & (src < t // 2)
        out[ok] = pairs[src[ok], par]
    return out


@pytest.mark.parametrize("t", [256, 250, 3000])
@pytest.mark.parametrize("stride, tap", list(itertools.product((1, 2), range(3))))
def test_tap_coords_read_the_conv_rows(stride, tap, t):
    """Tap `tap` of output row i reads input row stride * i + tap - 1, and
    zero exactly where that row is outside [0, T) (the conv's padding)."""
    a = np.arange(1, t + 1, dtype=np.float64)[:, None]  # row r holds r + 1
    rows = np.arange(t // stride)
    got = _read_rows(a, stride, tap, rows)[:, 0]
    want_row = stride * rows + tap - 1
    inside = (want_row >= 0) & (want_row < t)
    np.testing.assert_array_equal(got[inside], want_row[inside] + 1)
    np.testing.assert_array_equal(got[~inside], 0)
    assert (~inside).sum() == (1 if tap != 1 and (tap == 0 or stride == 1) else 0)


def _gelu(v):
    erf = np.vectorize(math.erf)
    return 0.5 * v * (1.0 + erf(v * 2.0**-0.5))


def _stem_as_the_kernel_walks_it(x, conv1, conv2):
    """fp64 emulation of K7's two GEMMs in its own order: the transpose,
    then per conv the work items of `stem_tile`, K steps of TILE_K channels
    of one tap over rows read through `tap_coords`, the weights of
    `tap_major_weights`, bias and GELU, rows past T and channels past d
    never stored."""
    b, c_in, t = x.shape
    w1p, b1, w2p, b2 = (p.double().numpy() for p in cs.tap_major_weights(
        conv1.weight, conv1.bias, conv2.weight, conv2.bias))
    d = w1p.shape[0]
    plan = list(cs.stem_plan(b, t, c_in, d))
    assert plan[:4] == [b, t, c_in, d]
    a = x.double().numpy().transpose(0, 2, 1)
    for stride, w, bias, n_mt in ((1, w1p, b1, plan[4]), (2, w2p, b2, plan[5])):
        t_out, c = t // stride, a.shape[2]
        out = np.full((b, t_out, d), np.nan)
        n_nt = plan[6]
        for wi in range(b * n_mt * n_nt):
            bb, m0, n0 = cs.stem_tile(wi, n_mt, n_nt)
            rows = np.arange(m0, m0 + cs.TILE_M)
            acc = np.zeros((cs.TILE_M, cs.TILE_N))
            for tap in range(3):
                tile_a = _read_rows(a[bb], stride, tap, rows)
                for c0 in range(0, c, cs.TILE_K):
                    wt = np.zeros((cs.TILE_N, cs.TILE_K))
                    blk = w[n0:n0 + cs.TILE_N, tap, c0:c0 + cs.TILE_K]
                    wt[:blk.shape[0], :blk.shape[1]] = blk
                    at = np.zeros((cs.TILE_M, cs.TILE_K))
                    part = tile_a[:, c0:c0 + cs.TILE_K]
                    at[:, :part.shape[1]] = part
                    acc += at @ wt.T
            keep_r, keep_c = min(cs.TILE_M, t_out - m0), min(cs.TILE_N, d - n0)
            out[bb, m0:m0 + keep_r, n0:n0 + keep_c] = _gelu(
                acc[:keep_r, :keep_c] + bias[n0:n0 + keep_c])
        assert not np.isnan(out).any()
        a = out
    return a


def _bf16_values(a):
    """fp32 array of the bf16-rounded values: K7 takes bf16 weights."""
    return torch.from_numpy(a).to(torch.bfloat16).float().numpy()


def _convs(seed, c_in, d, f32=False):
    """The two convs from a seed, and the JAX package's params of them:
    bf16 values (what the bf16 K7 takes), or with f32 fp32 values as drawn
    (whose TF32 splits leave residuals)."""
    rng = np.random.default_rng(seed)
    rnd = (lambda a: a) if f32 else _bf16_values
    # JAX layout: (3, C_in, C_out)
    k1 = rnd(rng.standard_normal((3, c_in, d)).astype(np.float32) * 0.1)
    k2 = rnd(rng.standard_normal((3, d, d)).astype(np.float32) * 0.1)
    b1, b2 = rnd(rng.standard_normal((2, d)).astype(np.float32) * 0.1)
    conv1 = torch.nn.Conv1d(c_in, d, 3, padding=1)
    conv2 = torch.nn.Conv1d(d, d, 3, stride=2, padding=1)
    with torch.no_grad():
        conv1.weight.copy_(torch.from_numpy(k1.transpose(2, 1, 0).copy()))
        conv2.weight.copy_(torch.from_numpy(k2.transpose(2, 1, 0).copy()))
        conv1.bias.copy_(torch.from_numpy(b1))
        conv2.bias.copy_(torch.from_numpy(b2))
    jax_convs = ({"kernel": jnp.asarray(k1), "bias": jnp.asarray(b1)},
                 {"kernel": jnp.asarray(k2), "bias": jnp.asarray(b2)})
    return conv1, conv2, jax_convs


@pytest.mark.parametrize("b, t, c_in, d", [(2, 256, 80, 64), (1, 250, 80, 64),
                                           (1, 262, 72, 320)])
def test_kernel_walk_matches_the_pallas_stem(b, t, c_in, d):
    """Ragged row tiles (T=250, 262), a ragged column tile (d=320) and K
    steps past C (C=72, 80)."""
    conv1, conv2, (j1, j2) = _convs(b + t + d, c_in, d)
    x = _bf16_values((np.random.default_rng(t).standard_normal((b, c_in, t)) * 0.3).astype(
        np.float32))
    ref = np.asarray(conv_stem_pallas(j1, j2, jnp.asarray(x), interpret=True))
    with torch.no_grad():
        got = _stem_as_the_kernel_walks_it(torch.from_numpy(x), conv1, conv2)
    assert got.shape == ref.shape == (b, t // 2, d)
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=1e-5)


def _tf32_np(a, nearest=True):
    """fp32 as TF32 (10 mantissa bits): rounded to nearest, ties away from
    zero (the kernel's high part), or truncated (what the tensor core reads
    of a residual's bits)."""
    bits = np.ascontiguousarray(a, np.float32).view(np.int32)
    return ((bits + 0x1000 if nearest else bits) & -8192).view(np.float32).astype(np.float64)


def _mm3(a, w):
    """a @ w.T as the fp32 form's tensor cores take it: each fp32 operand a
    TF32 high part and its residual (`split_tf32`, the residual's low 13
    bits dropped), a_lo w_hi + a_hi w_lo + a_hi w_hi (a_lo w_lo dropped),
    exact products summed in fp64."""
    ah, wh = (_tf32_np(v) for v in (a, w))
    al = _tf32_np((a.astype(np.float32) - ah).astype(np.float32), False)
    wl = _tf32_np((w.astype(np.float32) - wh).astype(np.float32), False)
    return al @ wh.T + ah @ wl.T + ah @ wh.T


def _stem_f32_as_the_kernel_walks_it(x, conv1, conv2, product=_mm3):
    """K7's fp32 form in its order: per conv the work items of `stem_tile`
    with F32_TILE_N-column tiles (128 rows of one batch element), K steps of
    F32_TILE_K channels of one tap over rows read through `tap_coords` (zero
    outside [0, T) and past C), the fp32 tap-major weights of
    `tap_major_weights`, each step's products (`product`: 3xTF32) in a sum of
    its own rounded to fp32 and added to the tile's fp32 sum, then bias and
    exact-erf GELU in fp32; y1 kept in fp32 between the convs (the kernel
    stores its high parts and residuals, whose sum it is); rows past T and
    channels past d never stored."""
    b, c_in, t = x.shape
    w1h, w1l, b1, w2h, w2l, b2 = (p.numpy() for p in cs.tap_major_weights(
        conv1.weight, conv1.bias, conv2.weight, conv2.bias, torch.float32))
    w1p, w2p = w1h + w1l, w2h + w2l  # the weights, exactly: `_mm3` splits them again
    d = w1p.shape[0]
    plan = list(cs.stem_plan(b, t, c_in, d, cs.F32_TILE_N))
    assert plan[:4] == [b, t, c_in, d]
    tm, tn, tk = cs.TILE_M, cs.F32_TILE_N, cs.F32_TILE_K
    a = x.numpy().transpose(0, 2, 1)
    for stride, w, bias, n_mt in ((1, w1p, b1, plan[4]), (2, w2p, b2, plan[5])):
        t_out, c = t // stride, a.shape[2]
        out = np.full((b, t_out, d), np.nan, np.float32)
        n_nt = plan[6]
        for wi in range(b * n_mt * n_nt):
            bb, m0, n0 = cs.stem_tile(wi, n_mt, n_nt, tn)
            rows = np.arange(m0, m0 + tm)
            acc = np.zeros((tm, tn), np.float32)
            for tap in range(3):
                tile_a = _read_rows(a[bb], stride, tap, rows)
                for c0 in range(0, c, tk):
                    wt = np.zeros((tn, tk), np.float32)
                    blk = w[n0:n0 + tn, tap, c0:c0 + tk]
                    wt[:blk.shape[0], :blk.shape[1]] = blk
                    at = np.zeros((tm, tk), np.float32)
                    part = tile_a[:, c0:c0 + tk]
                    at[:, :part.shape[1]] = part
                    acc += product(at, wt).astype(np.float32)
            keep_r, keep_c = min(tm, t_out - m0), min(tn, d - n0)
            pre = acc[:keep_r, :keep_c] + bias[n0:n0 + keep_c]
            out[bb, m0:m0 + keep_r, n0:n0 + keep_c] = _gelu(pre.astype(np.float64))
        assert not np.isnan(out).any()
        a = out
    return a


def _rel_l2(a, r):
    return float(np.linalg.norm(np.asarray(a, np.float64) - r) / np.linalg.norm(r))


@pytest.mark.parametrize("b, t, c_in, d", [(2, 256, 80, 64), (3, 130, 20, 36), (1, 262, 72, 132)])
def test_f32_walk_matches_the_twin_and_the_pallas_stem(b, t, c_in, d):
    """K7's fp32 form in its order (3xTF32 step sums added in fp32) against
    the JAX package's Pallas stem in interpret mode on fp32 inputs and the
    plain twin: relative L2 <= 1e-6 and elementwise 1e-5 (the Pallas
    stem's rational erf is within 1.5e-7), with ragged row tiles, ragged
    column tiles (d < 128, d = 132) and K steps past C; the TF32 products
    alone (no residual terms) read more than 1e-5 away."""
    conv1, conv2, (j1, j2) = _convs(b * t + d, c_in, d, f32=True)
    x = (np.random.default_rng(t).standard_normal((b, c_in, t)) * 0.3).astype(np.float32)
    with torch.no_grad():
        got = _stem_f32_as_the_kernel_walks_it(torch.from_numpy(x), conv1, conv2)
        one = _stem_f32_as_the_kernel_walks_it(
            torch.from_numpy(x), conv1, conv2, product=lambda a, w: _tf32_np(a) @ _tf32_np(w).T)
        twin = cs.conv_stem_reference(conv1.weight, conv1.bias, conv2.weight, conv2.bias,
                                      torch.from_numpy(x)).numpy()
    ref = np.asarray(conv_stem_pallas(j1, j2, jnp.asarray(x), interpret=True))
    assert got.shape == twin.shape == ref.shape == (b, t // 2, d)
    np.testing.assert_allclose(got, twin, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=1e-5)
    assert _rel_l2(got, ref) <= 1e-6 and _rel_l2(got, twin) <= 1e-6
    assert _rel_l2(one, ref) > 1e-5


@pytest.mark.parametrize("b, t, d", [(16, 3000, 1280), (1, 2, 8), (3, 130, 36)])
def test_f32_grids_cover_every_tile(b, t, d):
    """The fp32 form's work items (`stem_plan` with F32_TILE_N columns,
    `stem_tile`) cover every (batch element, row, channel) of conv1 and
    conv2 once, no tile crosses a batch element or lies wholly past T or d,
    and the column tiles of one row tile are consecutive items."""
    plan = list(cs.stem_plan(b, t, 128, d, cs.F32_TILE_N))
    tn = cs.F32_TILE_N
    for t_out, n_mt in ((t, plan[4]), (t // 2, plan[5])):
        n_nt = plan[6]
        assert (n_mt, n_nt) == cs.stem_tiles(t_out, d, tn)
        tiles = [cs.stem_tile(w, n_mt, n_nt, tn) for w in range(b * n_mt * n_nt)]
        covered = np.zeros((b, t_out, d), np.int64)
        for bb, m0, n0 in tiles:
            assert 0 <= m0 < t_out and 0 <= n0 < d
            covered[bb, m0:m0 + cs.TILE_M, n0:n0 + tn] += 1
        assert (covered == 1).all()
        assert all(tiles[w][:2] == tiles[w - w % n_nt][:2] for w in range(len(tiles)))


def test_split_tf32_is_exact_and_cached_with_the_weights():
    """`split_tf32`: hi + lo == w exactly, hi's low 13 bits are 0 and hi is
    w rounded to nearest (|lo| <= half a TF32 ulp of hi); the fp32 form's
    split tap-major copies are cached and rebuilt after an in-place update
    of a weight."""
    conv1, conv2, _ = _convs(12, 16, 24, f32=True)
    ws = (conv1.weight, conv1.bias, conv2.weight, conv2.bias)
    w1h, w1l, b1, w2h, w2l, b2 = cs.tap_major_weights(*ws, torch.float32)
    for hi, lo, conv in ((w1h, w1l, conv1), (w2h, w2l, conv2)):
        assert hi.dtype == lo.dtype == torch.float32
        assert torch.equal(hi + lo, conv.weight.detach().permute(0, 2, 1))
        assert not (hi.view(torch.int32) & 0x1FFF).any()
        assert bool((lo.abs() <= hi.abs() * 2.0**-11).all())
        assert bool((lo != 0).any())
    assert torch.equal(b1, conv1.bias.detach()) and torch.equal(b2, conv2.bias.detach())
    again = cs.tap_major_weights(*ws, torch.float32)
    assert again[0] is w1h and again[4] is w2l
    with torch.no_grad():
        conv2.weight.mul_(3.0)
    rebuilt = cs.tap_major_weights(*ws, torch.float32)
    assert rebuilt[3] is not w2h
    assert torch.equal(rebuilt[3] + rebuilt[4], conv2.weight.detach().permute(0, 2, 1))
    x = torch.tensor([1.0, 1.0 + 2.0**-11, -(1.0 + 3 * 2.0**-12), 3.0e-5])
    hi, lo = cs.split_tf32(x)
    assert hi.tolist() == [1.0, 1.0 + 2.0**-10, -(1.0 + 2.0**-10), float(_tf32_np(x[3:].numpy())[0])]
    assert torch.equal(hi + lo, x)


@pytest.mark.parametrize("c_in, d", [(22, 64), (80, 62)])
def test_f32_form_refuses_rows_its_tensor_maps_cannot_read(c_in, d):
    """The fp32 form's TMA maps take 16-byte rows: n_mels and d multiples
    of 4, checked before the device is looked at."""
    conv1, conv2, _ = _convs(5, c_in, d, f32=True)
    x = torch.zeros(1, c_in, 16)
    with pytest.raises(ValueError, match="% 4 == 0"):
        cs._conv_stem_f32(conv1.weight, conv1.bias, conv2.weight, conv2.bias, x)


def test_tap_major_weights_in_fp32_are_cached_apart():
    """The fp32 form's tap-major copies are fp32 and split (high parts and
    residuals of the weights as they are, no bf16 rounding), cached apart
    from the bf16 ones."""
    conv1, conv2, _ = _convs(3, 16, 24)
    ws = (conv1.weight, conv1.bias, conv2.weight, conv2.bias)
    f32 = cs.tap_major_weights(*ws, torch.float32)
    bf = cs.tap_major_weights(*ws)
    assert len(f32) == 6 and len(bf) == 4
    assert f32[0].dtype == torch.float32 and bf[0].dtype == torch.bfloat16
    assert torch.equal(f32[0] + f32[1], conv1.weight.detach().permute(0, 2, 1))
    assert cs.tap_major_weights(*ws, torch.float32)[0] is f32[0]


def test_tap_major_weights_are_the_jax_wrapper_layout():
    """conv2's taps 0 and 1 stacked are the JAX wrapper's vv01 = [v0; v1]
    and tap 2 its v[2], transposed to K7's (C_out, tap, C_in) rows; conv1's
    taps are w1[tap]."""
    c_in, d = 80, 64
    conv1, conv2, (j1, j2) = _convs(5, c_in, d)
    w1p, b1, w2p, b2 = cs.tap_major_weights(conv1.weight, conv1.bias, conv2.weight, conv2.bias)
    assert w1p.shape == (d, 3, c_in) and w2p.shape == (d, 3, d)
    assert w1p.dtype == w2p.dtype == b1.dtype == b2.dtype == torch.bfloat16
    v = np.asarray(j2["kernel"].astype(jnp.bfloat16).astype(jnp.float32))
    vv01 = np.concatenate([v[0], v[1]], axis=0)  # (2 * d_in, d_out), as the JAX wrapper
    np.testing.assert_array_equal(w2p[:, :2].float().reshape(d, 2 * d).numpy().T, vv01)
    np.testing.assert_array_equal(w2p[:, 2].float().numpy().T, v[2])
    w1 = np.asarray(j1["kernel"].astype(jnp.bfloat16).astype(jnp.float32))
    for tap in range(3):
        np.testing.assert_array_equal(w1p[:, tap].float().numpy().T, w1[tap])


@pytest.mark.parametrize("b", [1, 2, 16])
@pytest.mark.parametrize("t", [256, 250, 3000])
def test_tile_schedule_covers_each_tile_once(b, t):
    d = 1280
    plan = list(cs.stem_plan(b, t, 128, d))
    for t_out, n_mt in ((t, plan[4]), (t // 2, plan[5])):
        n_nt = plan[6]
        assert (n_mt, n_nt) == cs.stem_tiles(t_out, d)
        tiles = [cs.stem_tile(w, n_mt, n_nt) for w in range(b * n_mt * n_nt)]
        assert len(set(tiles)) == len(tiles)
        assert set(tiles) == {(bb, mt * cs.TILE_M, nt * cs.TILE_N) for bb in range(b)
                              for mt in range(n_mt) for nt in range(n_nt)}
        covered = np.zeros((b * t_out, d), np.int64)
        for bb, m0, n0 in tiles:
            assert 0 <= m0 < t_out and 0 <= n0 < d  # inside one batch element
            rows = slice(bb * t_out + m0, bb * t_out + min(m0 + cs.TILE_M, t_out))
            covered[rows, n0:n0 + cs.TILE_N] += 1
        assert (covered == 1).all()
        # the column tiles of one row tile are consecutive work items
        assert all(tiles[w][:2] == tiles[w - w % n_nt][:2] for w in range(len(tiles)))


def test_stem_plan_packs_shapes_tiles_and_taps():
    plan = list(cs.stem_plan(16, 3000, 128, 1280))
    assert plan == [16, 3000, 128, 1280, 24, 12, 5,
                    0, 0, 0, -1, 0, 1,     # conv1: parities, row offsets
                    1, 0, 1, -1, 0, 0]     # conv2: parities, pair offsets


def test_tap_major_weights_rebuilt_after_in_place_update():
    conv1, conv2, _ = _convs(9, 16, 32)
    conv1, conv2 = conv1.to(torch.bfloat16), conv2.to(torch.bfloat16)
    first = cs.tap_major_weights(conv1.weight, conv1.bias, conv2.weight, conv2.bias)
    again = cs.tap_major_weights(conv1.weight, conv1.bias, conv2.weight, conv2.bias)
    assert all(a is f for a, f in zip(again, first))  # cached: no copy per call
    with torch.no_grad():
        conv2.weight.add_(1.0)
    rebuilt = cs.tap_major_weights(conv1.weight, conv1.bias, conv2.weight, conv2.bias)
    assert rebuilt[2] is not first[2]
    torch.testing.assert_close(rebuilt[2], conv2.weight.detach().permute(0, 2, 1), atol=0,
                               rtol=0)
    torch.testing.assert_close(rebuilt[0], conv1.weight.detach().permute(0, 2, 1), atol=0,
                               rtol=0)


def test_tap_major_weights_not_shared_between_modules():
    """Two stems with equal shapes keep their own copies."""
    a1, a2, _ = _convs(1, 16, 32)
    b1, b2, _ = _convs(2, 16, 32)
    wa = cs.tap_major_weights(a1.weight, a1.bias, a2.weight, a2.bias)
    wb = cs.tap_major_weights(b1.weight, b1.bias, b2.weight, b2.bias)
    assert not torch.equal(wa[2], wb[2])
    torch.testing.assert_close(wb[2].float(), b2.weight.detach().permute(0, 2, 1).to(
        torch.bfloat16).float(), atol=0, rtol=0)


@pytest.mark.parametrize("rows", [1, 3, 4, 37, 24000, 24001])
@pytest.mark.parametrize("grid", [1, 5, 132, 528, 6001])
def test_layer_norm_row_schedule_covers_every_row_once(rows, grid):
    sched = ln.row_schedule(rows, grid)
    assert len(sched) == grid * ln.WARPS_PER_BLOCK
    seen = np.zeros(rows, np.int64)
    for warp_rows in sched.values():
        seen[warp_rows] += 1
        assert all(b - a == grid * ln.WARPS_PER_BLOCK for a, b in zip(warp_rows, warp_rows[1:]))
    assert (seen == 1).all()


def test_tap_major_weights_of_inference_tensors_made_per_call():
    """Inference tensors carry no version counter: their tap-major copies
    are made on every call, so an in-place update is never missed."""
    with torch.inference_mode():
        conv1, conv2, _ = _convs(4, 16, 32)
        first = cs.tap_major_weights(conv1.weight, conv1.bias, conv2.weight, conv2.bias)
        conv2.weight.add_(1.0)
        again = cs.tap_major_weights(conv1.weight, conv1.bias, conv2.weight, conv2.bias)
    assert again[2] is not first[2]
    torch.testing.assert_close(again[2].float(), conv2.weight.permute(0, 2, 1).to(
        torch.bfloat16).float(), atol=0, rtol=0)
