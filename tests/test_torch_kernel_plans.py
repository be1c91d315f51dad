"""The pure-Python planning of the K1-K4 wrappers, on the CPU.

K1 (ops/flash_attention.py `_map_strides`, `_fwd_plan`): the byte strides
of its 4-D TMA tensor maps (head dim, heads, tokens, batch) for contiguous
tensors and for the column blocks of fused qkv / kv projections, read in
place; TMA needs 16-byte strides and addresses, so the wrapper raises on a
misaligned stride or address, and on a head dim that is not contiguous,
before it looks at the device.

K2 (ops/decode_attention.py `split_plan`): the slices of the cache rows a
call reads, one CTA each, cover every row of [0, valid) exactly once, for
scalar and per-row valid lengths (rows of a per-row call past its valid
length fall to CTAs that read nothing), and the cluster (the CTAs of one
batch row) divides the grid. Its ring form's plan (`ring_plan`,
`ring_slot`) reads every (row, head) in exactly one CTA at exactly the
slots of the brute-force age mask, and holds a CTA's K and V in shared
memory for every ring the decoder can fill (T <= 448) and raises where one
head cannot fit, and over int8 with per-head scales gives a ring call one
(row, head) a CTA whose 4-byte scale words hold each of its heads' bf16s;
its beam form's plan (`beam_plan`) covers every (group, head, beam, key)
once with a cluster that divides the grid, takes any beam count, and fits
its CTAs an SM in one wave at beam search's 12 x 5 over T=1500.

K3 (ops/mel.py `fft_plan`, `fft_index_maps`): the kernel's FFT, its
window, radix constants, twiddles and stage indices applied stage by stage
in float64 with the kernel's butterflies (8, 5, 5, then the real split),
equals np.fft.rfft of the windowed frame to 1e-12, bins 0 and 200
included.

K4 (ops/flash_attention.py `causal_tile_plan`): the key tiles each
128-row work item visits hold every (row, key) pair the end-aligned mask
keeps, none of them is masked for all its rows, and only the tiles that
cross the first row's bound (or tk) are masked.
"""
import itertools

import numpy as np
import pytest
import torch

from kotoba_whisper_tpu_torch.ops import decode_attention as da
from kotoba_whisper_tpu_torch.ops import flash_attention as fa
from kotoba_whisper_tpu_torch.ops import mel


def _bf16(*shape):
    return torch.zeros(*shape, dtype=torch.bfloat16)


def _strides(x):
    return fa._map_strides(x.shape, x.stride(), x.element_size())


@pytest.mark.parametrize("b, t, h", [(16, 1500, 20), (2, 1, 3), (1, 130, 1), (3, 4100, 2)])
def test_tma_strides_of_contiguous_tensors(b, t, h):
    x = _bf16(b, t, h, 64)
    assert _strides(x) == (128, h * 128, t * h * 128)


@pytest.mark.parametrize("b, t, h", [(2, 1500, 20), (1, 128, 20), (3, 65, 4)])
def test_tma_strides_read_fused_projections_in_place(b, t, h):
    qkv = _bf16(b, t, 3 * h * 64)
    for x in qkv.chunk(3, dim=-1):
        view = x.reshape(b, t, h, 64)
        assert not view.is_contiguous()
        assert _strides(view) == (128, 3 * h * 128, t * 3 * h * 128)
    kv = _bf16(b, t, 2 * h * 64)
    k, v = (x.reshape(b, t, h, 64) for x in kv.chunk(2, dim=-1))
    assert _strides(k) == _strides(v) == (128, 2 * h * 128, t * 2 * h * 128)
    # the encoder's token stride, 7680 bytes fused (2560 plain), as the
    # tensor maps of the large-v3 encoder take it
    if h == 20:
        assert _strides(qkv[..., : h * 64].reshape(b, t, h, 64))[1] == 7680


def test_tma_strides_of_size_one_dims_follow_a_contiguous_layout():
    x = _bf16(64).as_strided((1, 1, 1, 64), (7, 5, 3, 1))  # odd strides, all unused
    assert _strides(x) == (128, 128, 128)


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
    message = {"address": "16-byte aligned", "head dim": "contiguous head dim"}
    with pytest.raises(ValueError, match=message.get(what, "16-byte strides")):
        fa._flash_fwd_sm90(x, x, x, False)


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


@pytest.mark.parametrize("kv_dtype", [torch.int8, torch.bfloat16], ids=["int8", "bf16"])
@pytest.mark.parametrize("t", [1, 51, 176, 448, 1500])
def test_ring_plan_reads_the_age_mask(t, kv_dtype):
    """K2's ring form: CTA (x, y) of `ring_plan`'s grid reads row y's heads
    [x * heads, (x + 1) * heads) at the slots `ring_slot` gives its keys
    j < valid; over the grid every (row, head) is read by exactly one CTA,
    at each slot whose cyclic age (ring_pos - slot) mod T is below valid,
    once, and at no other. A CTA's K and V fit its shared memory at every
    T <= 448 (the decoder's max_target_positions) in both dtypes, two CTAs
    an SM up to the stream's T=176; where one head's slots cannot fit
    (T=1500 in bf16) the plan raises."""
    b, n_heads = 5, 20
    if kv_dtype == torch.bfloat16 and t == 1500:
        with pytest.raises(ValueError, match="shared memory"):
            da.ring_plan(b, t, n_heads, kv_dtype)
        return
    plan = da.ring_plan(b, t, n_heads, kv_dtype)
    assert plan.smem <= da.SMEM_LIMIT and n_heads % plan.heads == 0
    assert plan.grid == (n_heads // plan.heads, b) and 64 % plan.heads == 0
    if t <= 176:  # the stream's ring and shorter: two CTAs an SM
        assert 2 * (plan.smem + 1024) <= da.SM_SMEM
    rng = np.random.default_rng(t)
    for ring_pos in sorted({0, t - 1, int(rng.integers(t))}):
        valid = np.array(sorted({1, t, (t + 1) // 2, ring_pos + 1, min(t, ring_pos + 2)})[:b]
                         + [1] * b)[:b]
        seen = np.zeros((b, n_heads, t), np.int64)
        for x in range(plan.grid[0]):
            for y in range(plan.grid[1]):
                slots = [da.ring_slot(ring_pos, int(valid[y]), t, j) for j in range(valid[y])]
                for slot in slots:
                    seen[y, x * plan.heads:(x + 1) * plan.heads, slot] += 1
        age = (ring_pos - np.arange(t)) % t
        want = (age[None, :] < valid[:, None]).astype(np.int64)
        np.testing.assert_array_equal(seen, np.broadcast_to(want[:, None], seen.shape))


def test_ring_plan_prefers_a_full_card():
    """At the stream's shape (48 rows, T=176, 20 heads, int8) the plan takes
    the most heads a CTA whose grid still makes two CTAs per SM; a grid that
    cannot reach that takes one head a CTA (the most CTAs)."""
    plan = da.ring_plan(48, 176, 20, torch.int8, 132)
    assert plan.heads == 2 and plan.grid == (10, 48)
    assert da.ring_plan(48, 176, 20, torch.int8, 60).heads == 4
    assert da.ring_plan(2, 176, 20, torch.int8, 132).heads == 1


@pytest.mark.parametrize("t", [1, 51, 1500])
@pytest.mark.parametrize("beams", [1, 5, 6, 7, 8, 9, 16, 17])
def test_beam_plan_covers_each_key_once(beams, t):
    """K2's beam form: over `beam_plan`'s grid, CTA (x, y, z) reads keys
    [x * keys_per_split, ...) of head y % H of group z for beams
    [R (y // H), ...), R the tile's `beam_rows` (16; packed int4's 8):
    every (group, head, beam, key) exactly once, whole 64-key tiles a
    share, and what the launch needs of the cluster, which is the grid's x
    (the key shares of one (group, head, tile)): at most 8 CTAs, and no
    share without keys. Beam counts past a tile take more tiles."""
    n_heads = 20
    for g, kv_dtype in itertools.product((1, 2, 12), (torch.int8, torch.uint8)):
        plan = da.beam_plan(g, t, n_heads, beams, kv_dtype)
        rows = da.beam_rows(kv_dtype)
        splits, y_dim, z_dim = plan.grid
        assert (y_dim, z_dim) == (n_heads * plan.m_tiles, g) and splits == plan.splits
        assert 1 <= splits <= da.MAX_CLUSTER
        assert (splits - 1) * plan.keys_per_split < t <= splits * plan.keys_per_split
        assert plan.keys_per_split % da.BEAM_KEY_TILE == 0
        assert plan.m_tiles == -(-beams // rows)
        if splits > 1:  # key shares only while the CTAs would not fill one wave
            assert splits * y_dim * z_dim <= da.beam_ctas_per_sm(kv_dtype) * da.N_SMS
        seen = np.zeros((g, n_heads, beams, t), np.int64)
        for x in range(splits):
            k0 = x * plan.keys_per_split
            k1 = min(t, k0 + plan.keys_per_split)
            assert k1 > k0
            for y in range(y_dim):
                h, mt = y % n_heads, y // n_heads
                for z in range(z_dim):
                    seen[z, h, mt * rows:(mt + 1) * rows, k0:k1] += 1
        assert (seen == 1).all()


def test_beam_plan_fits_two_ctas_an_sm():
    """At beam search's shape (12 groups x 5 beams over T=1500, 20 heads)
    the plan is one CTA per (group, head, beam tile) in one wave: int8 and
    bf16 240 CTAs and no key split, two to an SM; packed int4's kernel
    (8-beam tiles, BEAM_INT4_WARPS consumer warps) as many key shares as
    keep its grid within BEAM_INT4_CTAS_PER_SM an SM, whose shared memory
    holds them. Two groups split each row's keys over a cluster, one group
    over a full one."""
    for kv_dtype in (torch.int8, torch.bfloat16):
        plan = da.beam_plan(12, 1500, 20, 5, kv_dtype)
        assert plan.grid == (1, 20, 12) and plan.keys_per_split >= 1500
        assert 2 * (plan.smem + 1024) <= da.SM_SMEM
    plan = da.beam_plan(12, 1500, 20, 5, torch.uint8)
    ctas = da.BEAM_INT4_CTAS_PER_SM
    assert plan.m_tiles == 1 and plan.splits == max(1, ctas * da.N_SMS // 240)
    assert plan.splits * 240 <= ctas * da.N_SMS  # one wave
    assert ctas * (plan.smem + 1024) <= da.SM_SMEM
    assert plan.smem == da.beam_smem_bytes(torch.uint8)
    assert da.beam_plan(2, 1500, 20, 5, torch.int8).grid == (6, 20, 2)
    assert da.beam_plan(1, 1500, 20, 5, torch.uint8).grid == (8, 20, 1)


@pytest.mark.parametrize("b, t, n_heads", [(48, 176, 20), (60, 176, 20), (48, 176, 10),
                                          (3, 448, 20), (5, 51, 7)])
def test_ring_plan_per_head_copies_scale_words(b, t, n_heads):
    """K2's ring form over int8 with bf16 per-head scales: the per-row
    form's grid where H is even (at two heads a CTA the slot's scale words
    then add no shared memory: one word a pair of heads), four CTAs an SM
    and one wave at the stream's 48 rows; its shared memory the kernel's layout
    with `ring_scale_words`. Each slot's copies (4-byte words) hold every
    head of the CTA at the half the kernel picks, read no word that holds
    none of them, and copy 2 bytes of a word whose second half is past the
    (B, T, H) tensor."""
    plan = da.ring_plan(b, t, n_heads, torch.int8, 132, per_head=True)
    row = da.ring_plan(b, t, n_heads, torch.int8, 132)
    assert plan.grid == (n_heads // plan.heads, b)
    assert plan.smem == da.ring_smem_bytes(t, plan.heads, torch.int8, True, n_heads=n_heads)
    if n_heads % 2 == 0:
        assert plan[:2] == row[:2]
        assert (plan.smem == row.smem) == (plan.heads <= 2)
    if (b, t, n_heads) == (48, 176, 20):
        assert plan.heads == 2 and 4 * (plan.smem + 1024) <= da.SM_SMEM
        assert plan.grid[0] * plan.grid[1] <= 4 * 132
    n_scales = b * t * n_heads
    for hpc in (h for h in da.RING_HEADS if n_heads % h == 0):
        words = da.ring_scale_words(hpc, True, n_heads)
        assert words == hpc // 2 + (1 if hpc % 2 or n_heads % 2 else 0)
        extra = (da.ring_smem_bytes(t, hpc, torch.int8, True, n_heads=n_heads)
                 - da.ring_smem_bytes(t, hpc, torch.int8, n_heads=n_heads))
        assert extra == 8 * t * (words - 1)
        for y in sorted({0, b - 1}):  # the first row and the last (the tensor's end)
            for slot in range(t):
                for h0 in range(0, n_heads, hpc):
                    el0 = (y * t + slot) * n_heads + h0
                    copies = da.ring_scale_copies(el0, hpc, n_scales, n_heads)
                    assert len(copies) == words
                    held = set()
                    for word, nbytes in copies:
                        assert nbytes in (0, 2, 4)
                        if nbytes:  # a word that holds one of the CTA's heads
                            assert el0 - 1 <= 2 * word < el0 + hpc
                        held.update(range(2 * word, 2 * word + nbytes // 2))
                    assert max(held) < n_scales
                    for e in range(hpc):
                        word, half = ((el0 & 1) + e) >> 1, (el0 + e) & 1
                        assert copies[word][0] * 2 + half == el0 + e and el0 + e in held


def test_beam_wrapper_says_why_it_refuses():
    """The beam form takes any beam count (no cap, unlike the earlier kernel's
    six); what it refuses, such as a head dim other than the kernel's 64, it
    refuses before it looks at the device, saying why (CPU tensors take the
    twin, so meta tensors stand in for card tensors)."""
    kv = torch.empty((2, 1500, 1280), dtype=torch.bfloat16, device="meta")
    q = torch.empty((2, 7, 40, 32), dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="head dim 64"):
        da.decode_attention_beam(q, kv, kv, n_heads=40)


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


@pytest.mark.parametrize("b", [1, 16, 60])
@pytest.mark.parametrize("t, kv_dtype, self_form", [
    (1, torch.int8, True), (51, torch.int8, True), (51, torch.bfloat16, True),
    (51, torch.float32, True), (176, torch.int8, True), (448, torch.bfloat16, True),
    (448, torch.float32, True), (512, torch.int8, True), (513, torch.int8, False),
    (1500, torch.int8, False), (1500, torch.bfloat16, False), (1500, torch.float32, False),
    (1500, torch.uint8, False), (51, torch.uint8, False)])
def test_self_form_takes_the_self_caches(b, t, kv_dtype, self_form):
    """K2's form by the call's shape: a cache of at most 512 slots (every
    self cache the decoder fills: phase 4's T=51, a stream's 176, the
    decoder's most positions 448), in any mode but packed int4, takes the
    self form on `ring_plan`'s grid, which holds it in shared memory and
    gives the row one CTA a group of heads; the cross caches of phases 4,
    4j and 4i (T=1500 in int8, bf16, fp32 and int4, at 20 and a TP rank's 10
    heads) keep `split_plan`'s clusters of 8 CTAs of 188 rows."""
    assert da.self_form(t, kv_dtype) == self_form
    for n_heads in (20, 10):
        if self_form:
            plan = da.ring_plan(b, t, n_heads, kv_dtype, q_dtype=kv_dtype if kv_dtype
                                == torch.float32 else torch.bfloat16)
            # no CTA over a row's every head, no cluster (the grid is the launch's)
            assert plan.smem <= da.SMEM_LIMIT and plan.heads < n_heads
            assert plan.grid == (n_heads // plan.heads, b)
            assert da.split_plan(t)[1] <= da.MIN_CTA_ROWS
        elif t == 1500:
            assert da.split_plan(t) == (8, 188)


def test_split_plan_rejects_an_empty_span():
    with pytest.raises(ValueError):
        da.split_plan(0)


# ---- K3: the FFT plan ---------------------------------------------------------


def _mul_i(z):
    """-i z"""
    return z.imag - 1j * z.real


def _dft8(v, c):
    """csrc/mel.cu `dft8`, step by step."""
    a0, a4, a1, a5 = v[0] + v[4], v[0] - v[4], v[1] + v[5], v[1] - v[5]
    a2, a6, a3, a7 = v[2] + v[6], v[2] - v[6], v[3] + v[7], v[3] - v[7]
    a5 = c * (a5.real + a5.imag) + 1j * c * (a5.imag - a5.real)
    a6 = _mul_i(a6)
    a7 = c * (a7.imag - a7.real) - 1j * c * (a7.real + a7.imag)
    b0, b2, b1, b3 = a0 + a2, a0 - a2, a1 + a3, _mul_i(a1 - a3)
    b4, b6, b5, b7 = a4 + a6, a4 - a6, a5 + a7, _mul_i(a5 - a7)
    return [b0 + b1, b4 + b5, b2 + b3, b6 + b7, b0 - b1, b4 - b5, b2 - b3, b6 - b7]


def _dft5(v, c1, s1, c2, s2):
    """csrc/mel.cu `dft5`, step by step."""
    sa, da_, sb, db = v[1] + v[4], v[1] - v[4], v[2] + v[3], v[2] - v[3]
    r1, r2 = v[0] + c1 * sa + c2 * sb, v[0] + c2 * sa + c1 * sb
    i1, i2 = _mul_i(s1 * da_ + s2 * db), _mul_i(s2 * da_ - s1 * db)
    return [v[0] + sa + sb, r1 + i1, r2 + i2, r2 - i2, r1 - i1]


def _kernel_rfft(frame, plan):
    """K3's DFT of one 400-sample frame as the kernel computes it, in the
    precision of `plan`'s arrays: the windowed even/odd pairs as z, the
    Stockham stages of FFT_STAGES through fft_index_maps, the real split."""
    n = frame.size // 2
    w = plan["window"]
    z = w[0::2] * frame[0::2] + 1j * (w[1::2] * frame[1::2])
    radix = plan["radix"]
    for i, ((r, ns), (src, dst)) in enumerate(zip(mel.FFT_STAGES, mel.fft_index_maps(n)),
                                              start=1):
        v = [z[src[:, k]] for k in range(r)]
        if ns > 1:
            tw = plan[f"tw{i}"][:, np.arange(n // r) % ns]
            v = [v[0]] + [v[k] * tw[k - 1] for k in range(1, r)]
        out = _dft8(v, radix[0]) if r == 8 else _dft5(v, *radix[1:5])
        z = np.empty_like(z)
        for k in range(r):
            z[dst[:, k]] = out[k]
    k = np.arange(n + 1)
    zk, zn = z[k % n], np.conj(z[(n - k) % n])
    return 0.5 * (zk + zn) - 0.5j * plan["split"] * (zk - zn)


def _frame(kind):
    t = np.arange(400)
    if kind.startswith("noise"):
        return np.random.default_rng(int(kind[5:])).standard_normal(400)
    return {"dc": np.ones(400), "nyquist": (-1.0) ** t, "impulse": (t == 0) * 1.0,
            "tone": np.cos(2 * np.pi * 37.3 * t / 400 + 0.4)}[kind]


@pytest.mark.parametrize("kind", ["noise0", "noise1", "noise2", "dc", "nyquist", "impulse",
                                  "tone"])
def test_fft_plan_computes_the_windowed_rfft(kind):
    x = _frame(kind)
    plan = mel.fft_plan(400)
    ref = np.fft.rfft(plan["window"] * x)
    got = _kernel_rfft(x, plan)
    assert got.shape == ref.shape == (201,)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-12)
    if kind in ("dc", "nyquist"):  # the split's two real ends carry the frame
        end = 0 if kind == "dc" else 200
        assert abs(ref[end]) > 100 and abs(got[end] - ref[end]) <= 1e-12


def test_fft_window_is_the_reference_hann():
    np.testing.assert_array_equal(mel.fft_table(400)[:400], mel._dft_window_matrix(400)[:, 0])


@pytest.mark.parametrize("stage", range(len(mel.FFT_STAGES)))
def test_fft_stage_reads_and_writes_every_point_once(stage):
    src, dst = mel.fft_index_maps(200)[stage]
    r, ns = mel.FFT_STAGES[stage]
    assert src.shape == dst.shape == (200 // r, r)
    assert sorted(src.ravel()) == sorted(dst.ravel()) == list(range(200))
    assert np.prod([r for r, _ in mel.FFT_STAGES[:stage]]) == ns


def test_fft_table_is_the_plan_rounded_once():
    plan, table = mel.fft_plan(400), mel.fft_table(400)
    rounded = {k: (v.astype(np.complex64) if np.iscomplexobj(v) else v.astype(np.float32))
               for k, v in plan.items()}
    frame = _frame("noise3")
    # the fp32 plan still computes the DFT, to fp32 rounding of its tables
    got = _kernel_rfft(frame, rounded)
    ref = np.fft.rfft(plan["window"] * frame)
    assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()
    assert table.dtype == np.float32
    off = 0
    for name, size in mel.FFT_TABLE_LAYOUT:
        a = rounded[name]
        flat = np.stack([a.real, a.imag], -1).ravel() if np.iscomplexobj(a) else a
        np.testing.assert_array_equal(table[off:off + flat.size], flat)
        off += size
    assert off == table.size


# ---- K4: the causal tile plan ---------------------------------------------------


def _causal_cases():
    same = [(t, t) for t in (1, 64, 65, 128, 130, 1500)]
    return same + [(1, 64), (1, 130), (64, 130), (100, 1500), (128, 448), (130, 1500)]


@pytest.mark.parametrize("tq, tk", _causal_cases())
def test_causal_tile_plan(tq, tk):
    tile = fa.TILE
    n_key_tiles = -(-tk // tile)
    for q0 in range(0, tq, tile):
        rows = np.arange(q0, min(q0 + tile, tq))[:, None]
        n_tiles, n_free = fa.causal_tile_plan(tq, tk, q0)
        assert 1 <= n_tiles <= n_key_tiles and 0 <= n_free <= n_tiles
        for j in range(n_key_tiles):
            keys = np.arange(j * tile, (j + 1) * tile)[None, :]
            kept = (keys <= rows + tk - tq) & (keys < tk)
            if j >= n_tiles:  # every kept pair lies in a visited tile
                assert not kept.any(), (q0, j)
                continue
            assert kept.any(), (q0, j)  # no visited tile is masked for all its rows
            # the leading n_free tiles keep every pair; only the others are masked
            assert kept.all() == (j < n_free), (q0, j)


@pytest.mark.parametrize("causal", [False, True])
def test_fwd_plan_packs_shapes_and_strides(causal):
    """What K1/K4's C entry reads: (B, Tq, Tk, H, causal) and the byte
    strides of q, k and v's tensor maps, here fused qkv column views."""
    b, t, h = 2, 130, 4
    q, k, v = (x.reshape(b, t, h, 64) for x in _bf16(b, t, 3 * h * 64).chunk(3, dim=-1))
    (bb, tq, hh), plan = fa._fwd_plan((q.shape, q.stride()), (k.shape, k.stride()),
                                      (v.shape, v.stride()), causal)
    assert (bb, tq, hh) == (b, t, h)
    assert list(plan) == [b, t, t, h, int(causal), *_strides(q), *_strides(k),
                          *_strides(v), 0]


@pytest.mark.parametrize("f32", [False, True])
def test_fwd_plan_carries_the_no_max_form(f32):
    """K1's no-max form: the same plan with its flag last, a plan of its own
    in the cache; causal calls and more than SINGLE_STEP_MAX_K keys are
    refused (the JAX package's no-max branch is its one-shot kernel's)."""
    b, t, h = 2, 130, 4
    dtype = torch.float32 if f32 else torch.bfloat16
    q, k, v = (x.reshape(b, t, h, 64)
               for x in torch.zeros(b, t, 3 * h * 64, dtype=dtype).chunk(3, dim=-1))
    plan_of = fa._f32_plan if f32 else fa._fwd_plan
    layouts = ((q.shape, q.stride()), (k.shape, k.stride()), (v.shape, v.stride()))
    _, base = plan_of(*layouts, False)
    meta, plan = plan_of(*layouts, False, True)
    assert meta == (b, t, h) and list(plan) == [*list(base)[:14], 1] and plan is not base
    with pytest.raises(ValueError, match="non-causal"):
        plan_of(*layouts, True, True)
    long_k = torch.zeros(1, fa.SINGLE_STEP_MAX_K + 1, 1, 64, dtype=dtype)
    q1 = torch.zeros(1, 8, 1, 64, dtype=dtype)
    with pytest.raises(ValueError, match="non-causal"):
        plan_of((q1.shape, q1.stride()), *[(long_k.shape, long_k.stride())] * 2, False, True)


def test_fwd_plan_rejects_causal_with_more_queries_than_keys():
    q, k = _bf16(1, 8, 2, 64), _bf16(1, 4, 2, 64)
    layouts = ((q.shape, q.stride()), (k.shape, k.stride()), (k.shape, k.stride()))
    assert list(fa._fwd_plan(*layouts, False)[1])[:5] == [1, 8, 4, 2, 0]
    with pytest.raises(ValueError, match="Tq <= Tk"):
        fa._fwd_plan(*layouts, True)
