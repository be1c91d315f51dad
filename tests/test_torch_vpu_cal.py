"""K9's plain twin (the port's tools/vpu_cal.py on CPU tensors) vs the JAX
tool's calibration kernel `_kernel` in Pallas interpret mode, at (8, 128)
x 4 iterations, both ops. The twin takes torch's exp where the kernel on
the card takes ex2 on log2(e)-scaled scores; here both sides are fp32
exp, so they agree within 1e-6 relative (sums in another order). The
port's second column, each row's sum over the iterations of its row sum
l, which the JAX kernel does not give, is held to the same loop in
float64 (`_l_sums`).

`cal_walk` repeats the card kernel's order (csrc/vpu_cal.cu): a row over
w = ROW_WARPS[op] warps of 32 lanes, column c in lane c % 32 of warp c //
32 % w, register c // (32 w), -inf past cols; s = fma(acc,
1e-9, x); exp: each lane's sum in SUMS running sums (register j into sum
j % SUMS) added pairwise from the widest, the lanes' by xor shuffles 16,
8, 4, 2, 1, the warps' by xor shuffles from the widest; softmax: each
lane's exponentials against its own max, its sum rebased to the warp's
max, the warps' (max, sum) pairs rebased to the row's, acc += l / l; lsum
+= l. It holds the JAX kernel and `_l_sums` at the card test's rtol 1e-4,
rows and cols past the kernel's CTA and row width included; with its
exponentials or its rebase knocked out, lsum no longer does, though the
softmax form's acc still holds.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from kotoba_whisper_tpu_torch.tools import vpu_cal as tcal
from tools import vpu_cal as jcal


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny CPU tensors: one intra-op thread, so torch's thread pool does
    not spin-wait on cores the parallel test workers oversubscribe."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("op", ["softmax", "exp"])
def test_calibration_twin_matches_pallas(op):
    x = np.random.default_rng(0).standard_normal((8, 128)).astype(np.float32)
    ref = pl.pallas_call(
        functools.partial(jcal._kernel, iters=4, op=op),
        out_shape=jax.ShapeDtypeStruct((8, 1), jnp.float32),
        interpret=True,
    )(jnp.asarray(x))
    got = tcal.vpu_cal(torch.from_numpy(x), 4, op)
    assert got.shape == (8, 2)
    np.testing.assert_allclose(got[:, :1].numpy(), np.asarray(ref), rtol=1e-6, atol=0)
    np.testing.assert_allclose(got[:, 1].numpy(), _l_sums(x, 4, op), rtol=1e-6, atol=0)


def _l_sums(x, iters, op):
    """Each row's sum over the iterations of its row sum l (softmax: of
    exp(s - max s), exp: of exp(s)), the JAX tool's loop in float64."""
    x = x.astype(np.float64)
    acc = np.zeros((x.shape[0], 1))
    lsum = np.zeros(x.shape[0])
    for _ in range(iters):
        s = x + acc * 1e-9
        if op == "softmax":
            l = np.exp(s - s.max(-1, keepdims=True)).sum(-1, keepdims=True)
            acc = acc + 1.0
        else:
            l = np.exp(s).sum(-1, keepdims=True)
            acc = acc + l
        lsum = lsum + l[:, 0]
    return lsum


LOG2E = 1.4426950408889634


def _xor_sum(v):
    """The sum of v (..., n) over its last axis as the kernel's xor
    shuffles take it (offsets n / 2 .. 1), the same value in every lane."""
    lanes = torch.arange(v.shape[-1])
    off = v.shape[-1] // 2
    while off:
        v = v + v[..., lanes ^ off]
        off //= 2
    return v


def _lane_sum(p):
    """A lane's sum of p (rows, per, ...) over its registers: SUMS running
    sums, then added pairwise from the widest."""
    sums = [torch.zeros_like(p[:, 0]) for _ in range(tcal.SUMS)]
    for j in range(p.shape[1]):
        sums[j % tcal.SUMS] = sums[j % tcal.SUMS] + p[:, j]
    w = tcal.SUMS // 2
    while w:
        for i in range(w):
            sums[i] = sums[i] + sums[i + w]
        w //= 2
    return sums[0]


def _fma(a, b, c):
    """fp32 a * b + c rounded once (the exact product fits fp64)."""
    return (a.double() * b.double() + c.double()).float()


def cal_walk(x, iters, op, ex2=torch.exp2, rebase=True):
    """K9's card kernel in its order (fp32, ex2 as torch.exp2) -> (rows, 2),
    acc and lsum; `ex2` and `rebase` (False: the lanes' sums added as they
    are) knock parts of its body out."""
    rows, cols = x.shape
    warps = tcal.ROW_WARPS[op]
    per = -(-cols // (32 * warps))
    xs = torch.full((rows, per * 32 * warps), float("-inf"))
    xs[:, :cols] = x
    xs = xs.view(rows, per, warps, 32)  # [row][register][warp][lane]
    acc = torch.zeros(rows)
    lsum = torch.zeros(rows)
    c = torch.tensor(1e-9, dtype=torch.float32)
    log2e = torch.tensor(LOG2E, dtype=torch.float32)
    for _ in range(iters):
        s = _fma(acc[:, None, None, None], c, xs)
        if op == "exp":
            warp = _xor_sum(_lane_sum(ex2(s * log2e)))[..., 0]
            total = _xor_sum(warp)[:, 0]
            acc, lsum = acc + total, lsum + total
            continue
        mt = s.amax(1)  # the lane's max, (row, warp, lane)
        bt = mt * log2e
        shift = torch.where(mt == float("-inf"), torch.zeros_like(bt), bt)
        lt = _lane_sum(ex2(_fma(s, log2e, -shift[:, None])))
        m = mt.amax(-1, keepdim=True) * log2e  # the warp's max
        if rebase:
            lt = torch.where(bt == float("-inf"), torch.zeros_like(lt), lt * torch.exp2(bt - m))
        lw, mw = _xor_sum(lt)[..., 0], m[..., 0]
        big = mw.amax(-1, keepdim=True)  # the row's
        part = torch.where(mw == float("-inf"), torch.zeros_like(lw), lw * torch.exp2(mw - big))
        total = _xor_sum(part)[:, 0]
        acc, lsum = acc + total / total, lsum + total
    return torch.stack([acc, lsum], dim=1)


def _pallas(x, iters, op):
    return np.asarray(pl.pallas_call(
        functools.partial(jcal._kernel, iters=iters, op=op),
        out_shape=jax.ShapeDtypeStruct((x.shape[0], 1), jnp.float32),
        interpret=True,
    )(jnp.asarray(x)))


@pytest.mark.parametrize("op", ["softmax", "exp"])
@pytest.mark.parametrize("rows, cols, iters", [(8, 128, 4), (5, 300, 3), (3, 1, 2),
                                               (6, 1536, 3)])
def test_card_order_matches_pallas(op, rows, cols, iters):
    """The card kernel's order (`cal_walk`) holds the JAX kernel at rtol
    1e-4: rows not a multiple of the CTA's, cols not of the row width, a
    row in one column, the tool's 1536."""
    x = np.random.default_rng(rows * cols).standard_normal((rows, cols)).astype(np.float32)
    got = cal_walk(torch.from_numpy(x), iters, op)
    np.testing.assert_allclose(got[:, :1].numpy(), _pallas(x, iters, op), rtol=1e-4, atol=0)
    np.testing.assert_allclose(got[:, 1].numpy(), _l_sums(x, iters, op), rtol=1e-4, atol=0)


@pytest.mark.parametrize("op, knock", [("softmax", "no_exp"), ("softmax", "no_rebase"),
                                       ("exp", "no_exp")])
def test_row_sums_see_a_knocked_out_body(op, knock):
    """The card kernel's order with its exponentials skipped (each an
    FFMA, the sweep's `no_exp`) or its lane sums not rebased (`no_rebase`)
    is off lsum's reference beyond rtol 1e-4, where the softmax form's acc
    (sum / l each iteration) still holds the JAX kernel: a row of whole
    lane registers, no -inf padding for a skipped exponential to turn into
    a NaN."""
    x = np.random.default_rng(3).standard_normal((6, 256)).astype(np.float32)
    got = cal_walk(torch.from_numpy(x), 3, op,
                   **({"ex2": lambda v: v} if knock == "no_exp" else {"rebase": False}))
    assert not np.allclose(got[:, 1].numpy(), _l_sums(x, 3, op), rtol=1e-4, atol=0)
    if op == "softmax":
        np.testing.assert_allclose(got[:, :1].numpy(), _pallas(x, 3, op), rtol=1e-4, atol=0)


def test_layout_constants_are_the_kernels():
    """ROW_WARPS, SUMS, ROWS_PER_CTA and MAX_COLS are csrc/vpu_cal.cu's
    kSoftmaxWarps / kExpWarps, kSums, kRows and kMaxCols; the sweep's shapes
    are distinct powers of two, the shipped one first, and every variant (a
    shape, or a patch of the shipped source, each text found once) is a
    source of its own, the shipped shape's the source itself."""
    from kotoba_whisper_tpu_torch.ops import _build

    src = open(_build.source_path("vpu_cal")).read()
    shipped = (tcal.ROW_WARPS["softmax"], tcal.ROW_WARPS["exp"], tcal.SUMS)
    assert src.count(tcal.shape_lines(*shipped)) == 1
    assert f"constexpr int kRows = {tcal.ROWS_PER_CTA};" in src
    assert f"constexpr int kMaxCols = {tcal.MAX_COLS};" in src
    assert tcal.SWEEP[0] == shipped and len(set(tcal.SWEEP)) == len(tcal.SWEEP)
    assert all(n & (n - 1) == 0 and all(w & (w - 1) == 0 and 32 * w * tcal.ROWS_PER_CTA <= 1024
                                        for w in ws)
               for *ws, n in tcal.SWEEP)
    sources = tcal.sweep_sources(src)
    assert list(sources) == [f"w{a}_{b}_s{n}" for a, b, n in tcal.SWEEP] + list(tcal.PATCHES)
    assert len(set(sources.values())) == len(sources)
    assert sources["w{}_{}_s{}".format(*shipped)] == src


def test_projection_counts_large_v3_encoder_scores():
    """The JAX tool's projected volume: 32 layers x B*20 heads x 1500^2."""
    assert tcal.encoder_score_elements(32) == 32 * 32 * 20 * 1500 * 1500
    assert tcal.encoder_score_elements(16) * 2 == tcal.encoder_score_elements(32)


def test_measurement_needs_the_card():
    with pytest.raises(RuntimeError, match="needs device cuda"):
        tcal.measure(rows=8, cols=128, iters=2, trials=1, device="cpu")
