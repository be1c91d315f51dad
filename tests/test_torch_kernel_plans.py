"""The pure-Python planning of the K1 and K2 wrappers, on the CPU.

K1 (ops/flash_attention.py `tma_strides`): the byte strides of its 4-D TMA
tensor maps (head dim, heads, tokens, batch) for contiguous tensors and
for the column blocks of fused qkv / kv projections, read in place; TMA
needs 16-byte strides and addresses, so a misaligned stride or address
raises, as does a head dim that is not contiguous.

K2 (ops/decode_attention.py `split_plan`): the slices of the cache rows a
call reads, one CTA each, cover every row of [0, valid) exactly once, for
scalar and per-row valid lengths (rows of a per-row call past its valid
length fall to CTAs that read nothing), and the cluster (the CTAs of one
batch row) divides the grid.
"""
import numpy as np
import pytest
import torch

from kotoba_whisper_tpu_torch.ops import decode_attention as da
from kotoba_whisper_tpu_torch.ops import flash_attention as fa


def _bf16(*shape):
    return torch.zeros(*shape, dtype=torch.bfloat16)


@pytest.mark.parametrize("b, t, h", [(16, 1500, 20), (2, 1, 3), (1, 130, 1), (3, 4100, 2)])
def test_tma_strides_of_contiguous_tensors(b, t, h):
    x = _bf16(b, t, h, 64)
    assert fa.tma_strides(x) == (128, h * 128, t * h * 128)


@pytest.mark.parametrize("b, t, h", [(2, 1500, 20), (1, 128, 20), (3, 65, 4)])
def test_tma_strides_read_fused_projections_in_place(b, t, h):
    qkv = _bf16(b, t, 3 * h * 64)
    for x in qkv.chunk(3, dim=-1):
        view = x.reshape(b, t, h, 64)
        assert not view.is_contiguous()
        assert fa.tma_strides(view) == (128, 3 * h * 128, t * 3 * h * 128)
    kv = _bf16(b, t, 2 * h * 64)
    k, v = (x.reshape(b, t, h, 64) for x in kv.chunk(2, dim=-1))
    assert fa.tma_strides(k) == fa.tma_strides(v) == (128, 2 * h * 128, t * 2 * h * 128)
    # the encoder's token stride, 7680 bytes fused (2560 plain), as the
    # tensor maps of the large-v3 encoder take it
    if h == 20:
        assert fa.tma_strides(qkv[..., : h * 64].reshape(b, t, h, 64))[1] == 7680


def test_tma_strides_of_size_one_dims_follow_a_contiguous_layout():
    x = _bf16(64).as_strided((1, 1, 1, 64), (7, 5, 3, 1))  # odd strides, all unused
    assert fa.tma_strides(x) == (128, 128, 128)


@pytest.mark.parametrize("what", ["token stride", "batch stride", "address", "head dim"])
def test_tma_strides_raise_on_what_tma_cannot_read(what):
    b, t, h = 2, 10, 3
    flat = _bf16(b * t * (h * 64 + 8) + 64)
    if what == "token stride":   # 4 extra elements a token: 8 bytes
        x = flat.as_strided((b, t, h, 64), (t * (h * 64 + 4), h * 64 + 4, 64, 1))
    elif what == "batch stride":
        x = flat.as_strided((b, t, h, 64), (t * h * 64 + 4, h * 64, 64, 1))
    elif what == "address":
        x = flat[4:].as_strided((b, t, h, 64), (t * h * 64, h * 64, 64, 1))
    else:
        x = _bf16(b, t, 64, h).transpose(2, 3)
    with pytest.raises(ValueError):
        fa.tma_strides(x)


def test_tma_box_fits_the_128_byte_swizzle():
    inner, _, rows, _ = fa.TMA_BOX
    assert inner * 2 == 128 and 1 <= rows <= 256 and max(fa.TMA_BOX) <= 256


def _covered(valid, span, n_ctas, rows):
    """How many CTAs read each cache row, CTA r over [r*rows, min((r+1)*rows, valid))."""
    seen = np.zeros(span, np.int64)
    for r in range(n_ctas):
        lo, hi = r * rows, min((r + 1) * rows, valid)
        seen[lo:max(lo, hi)] += 1
    return seen


@pytest.mark.parametrize("t", [1, 51, 64, 65, 1500, 4100])
def test_split_plan_covers_each_valid_row_once(t):
    # scalar valid lengths: the plan spans [0, valid)
    for valid in sorted({1, 2, t // 2 or 1, t - 1 or 1, t}):
        n_ctas, rows = da.split_plan(valid)
        assert 1 <= n_ctas <= da.MAX_CLUSTER
        assert (_covered(valid, valid, n_ctas, rows) == 1).all()
        assert (n_ctas - 1) * rows < valid  # no CTA starts past the rows
    # per-row valid lengths: the plan spans the whole cache, and CTAs past a
    # row's length read nothing
    n_ctas, rows = da.split_plan(t)
    for valid in sorted({1, 2, 63, 64, 65, t // 2 or 1, t}):
        valid = min(valid, t)
        seen = _covered(valid, t, n_ctas, rows)
        assert (seen[:valid] == 1).all() and (seen[valid:] == 0).all()


@pytest.mark.parametrize("b", [1, 2, 16, 64])
@pytest.mark.parametrize("t", [1, 51, 64, 65, 1500])
def test_split_plan_cluster_divides_the_grid(b, t):
    n_ctas, rows = da.split_plan(t)
    grid, cluster = (n_ctas, b), (n_ctas, 1)
    assert grid[0] % cluster[0] == 0 and grid[1] % cluster[1] == 0
    assert n_ctas <= da.MAX_CLUSTER
    # the self-attention cache is one CTA per row; the cross cache at
    # T=1500 is a full cluster of 8 x 188 rows
    if t <= da.MIN_CTA_ROWS:
        assert n_ctas == 1
    if t == 1500:
        assert (n_ctas, rows) == (8, 188)


def test_split_plan_rejects_an_empty_span():
    with pytest.raises(ValueError):
        da.split_plan(0)
