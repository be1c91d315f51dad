"""The port's CUDA kernels (K1-K9) vs their plain twins, on the card.

K2 also in its ring form (continuous batching's shared-slot cache,
csrc/decode_attention_ring.cu), its self form (the same kernel without a
ring slot: every self-attention call's cache) and its beam form (a group's beam queries
over one shared cross row, csrc/decode_attention_beam.cu, any beam count),
and both together in a continuous-batching beam step at large-v3 width
(decode/streaming_beam.py), its logits against the plain path; and in the
int4 cache's modes (packed int4 cross K/V and int8 self K/V, each with
bf16 per-head scales) at 20 and 10 heads, every int4 code through each
kernel's unpack, in CUDA graphs, and the wrappers' refusals.

Marked `cuda`: skipped where no card is present. Run on a machine with an
H100:  python -m pytest tests/test_torch_kernels_cuda.py -q
Shapes cover the ragged edges (T not a multiple of the tiles, short and
per-row valid lengths, batch tails). bf16 kernels are held to their twins
elementwise (atol set from the card's readings, rtol 1e-2 for bf16 rounding
of large values) and by relative L2 <= 1e-2, about 10x bf16 rounding, which a
dropped or mis-weighted key tile exceeds; the fp32 mel kernel to 1e-4
after the per-utterance clamp (the bound between the JAX package's Pallas
and XLA frontends) on white noise and on a wide dynamic range. K5's
gradients, whose scale follows the inputs, are held elementwise to 1e-2 of
their largest magnitude (rtol 1e-2) and by the same relative L2. K6's
LayerNorm is held to one bf16 ulp of its twin (plus 2e-6 near 0) and its
sum bit for bit, with bf16 and fp32 weights; K7
and K8 like K1 (their outputs are bf16 after fp32 sums taken in another
order; K8 qk rounds P to bf16 against a running max, qkpv may round a p8
the other way), K8's quantize pre-pass bit for bit; K9's fp32 sums to 1e-4
relative. The w8a8 product (torch._int_mm) must be exact at the decode
step's row counts.
"""
import threading

import numpy as np
import pytest
import torch

from kotoba_whisper_tpu_torch.core.config import FeatureConfig
from kotoba_whisper_tpu_torch.models.quantized import dense_int8, int8_matmul, quantize_dense_int8
from kotoba_whisper_tpu_torch.models.whisper import pack_int4, quantize_kv_heads, quantize_kv_rows
from kotoba_whisper_tpu_torch.ops import conv_stem as cs
from kotoba_whisper_tpu_torch.ops import decode_attention as da
from kotoba_whisper_tpu_torch.ops import flash_attention as fa
from kotoba_whisper_tpu_torch.ops import layer_norm as ln
from kotoba_whisper_tpu_torch.ops import mel
from kotoba_whisper_tpu_torch.tools import vpu_cal

pytestmark = pytest.mark.cuda


@pytest.fixture(autouse=True)
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _randn(*shape, seed, dtype=torch.bfloat16):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randn(*shape, generator=g, device="cuda").to(dtype)


def _assert_near(got, ref, atol):
    got, ref = got.float(), ref.float()
    torch.testing.assert_close(got, ref, atol=atol, rtol=1e-2)
    rel = float((got - ref).norm() / ref.norm())
    assert rel <= 1e-2, f"relative L2 error {rel:.3e}"


@pytest.mark.parametrize("b, tq, tk, h", [(2, 1500, 1500, 20), (1, 70, 130, 3), (3, 64, 1, 2)])
def test_flash_attention_kernel(b, tq, tk, h):
    q = _randn(b, tq, h, 64, seed=1)
    k = _randn(b, tk, h, 64, seed=2)
    v = _randn(b, tk, h, 64, seed=3)
    before = fa.flash_attention_fwd.launches
    o, lse = fa.flash_attention_fwd(q, k, v)
    torch.cuda.synchronize()
    assert fa.flash_attention_fwd.launches == before + 1
    ro, rlse = fa.flash_attention_reference(q, k, v)
    _assert_near(o, ro, atol=5e-3)
    torch.testing.assert_close(lse, rlse, atol=1e-3, rtol=1e-4)


@pytest.mark.parametrize("tk", [1, 63, 64, 65, 128, 1500, 4100])
@pytest.mark.parametrize("tq", [1, 128, 1500])
def test_flash_attention_kernel_tiles(tq, tk):
    """K1 (TMA + wgmma) at key counts around its 128-key tiles (a ragged
    last tile masked, one exact tile, streamed long K) and query counts of
    one row, one exact 128-row tile and the encoder's 1500."""
    q = _randn(2, tq, 3, 64, seed=50)
    k = _randn(2, tk, 3, 64, seed=51)
    v = _randn(2, tk, 3, 64, seed=52)
    o, lse = fa.flash_attention_fwd(q, k, v)
    torch.cuda.synchronize()
    ro, rlse = fa.flash_attention_reference(q, k, v)
    _assert_near(o, ro, atol=5e-3)
    torch.testing.assert_close(lse, rlse, atol=1e-3, rtol=1e-4)


@pytest.mark.parametrize("tq, tk", [(1500, 1500), (128, 1500)])
def test_flash_attention_kernel_reads_fused_strides(tq, tk):
    """K1 on the column blocks of a fused qkv (self) and of a q + fused kv
    (cross) projection at large-v3 width: equal to the kernel on copies and
    near the twin."""
    b, h = 2, 20
    if tq == tk:
        q, k, v = (x.reshape(b, tq, h, 64) for x in _randn(b, tq, 3 * h * 64, seed=53).chunk(3, -1))
    else:
        q = _randn(b, tq, h, 64, seed=54)
        k, v = (x.reshape(b, tk, h, 64) for x in _randn(b, tk, 2 * h * 64, seed=55).chunk(2, -1))
    o, lse = fa.flash_attention_fwd(q, k, v)
    o2, lse2 = fa.flash_attention_fwd(q.contiguous(), k.contiguous(), v.contiguous())
    torch.cuda.synchronize()
    assert torch.equal(o, o2) and torch.equal(lse, lse2)
    _assert_near(o, fa.flash_attention_reference(q, k, v)[0], atol=5e-3)


def test_flash_attention_kernel_raises_on_misaligned_strides():
    x = _randn(2 * 10 * (3 * 64 + 4), seed=56).as_strided((2, 10, 3, 64), (10 * 196, 196, 64, 1))
    with pytest.raises(ValueError):
        fa.flash_attention_fwd(x, x, x)


def test_flash_attention_autograd_cross_on_card():
    """FlashAttention's gradients through K1's forward (LSE included) and
    K5's backward at the training cross-attention shape (128 labels x 1500
    frames) against autograd of the plain twin, bf16 on the card."""
    q = _randn(2, 128, 4, 64, seed=57).requires_grad_()
    k, v = (_randn(2, 1500, 4, 64, seed=s).requires_grad_() for s in (58, 59))
    do = _randn(2, 128, 4, 64, seed=60)
    fa.flash_attention(q, k, v).backward(do)
    got = [t.grad for t in (q, k, v)]
    q2, k2, v2 = (t.detach().clone().requires_grad_() for t in (q, k, v))
    fa.flash_attention_reference(q2, k2, v2)[0].backward(do)
    for name, g, t in zip(("dq", "dk", "dv"), got, (q2, k2, v2)):
        _assert_grad_near(g, t.grad, name)


@pytest.mark.parametrize("b, t, h", [(2, 130, 3), (8, 128, 20), (3, 64, 2), (1, 1, 1),
                                     (2, 65, 3), (2, 448, 4), (2, 1500, 3)])
def test_causal_flash_attention_kernel(b, t, h):
    """K4: causal T around its 128-row work items and 128-key tiles (one
    row, part of a tile, one tile, a ragged second tile, several tiles, the
    encoder's length) and the training shape."""
    q, k, v = (_randn(b, t, h, 64, seed=s) for s in (7, 8, 9))
    before = fa.flash_attention_fwd.causal_launches
    o, lse = fa.flash_attention_fwd(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert fa.flash_attention_fwd.causal_launches == before + 1
    ro, rlse = fa.flash_attention_reference(q, k, v, causal=True)
    _assert_near(o, ro, atol=5e-3)
    torch.testing.assert_close(lse, rlse, atol=1e-3, rtol=1e-4)


@pytest.mark.parametrize("tq, tk", [(1, 128), (64, 130), (100, 1500), (128, 448)])
def test_causal_flash_attention_kernel_end_aligned(tq, tk):
    """K4 with fewer queries than keys: row i sees keys j <= i + tk - tq."""
    q = _randn(2, tq, 3, 64, seed=66)
    k, v = _randn(2, tk, 3, 64, seed=67), _randn(2, tk, 3, 64, seed=68)
    o, lse = fa.flash_attention_fwd(q, k, v, causal=True)
    torch.cuda.synchronize()
    ro, rlse = fa.flash_attention_reference(q, k, v, causal=True)
    _assert_near(o, ro, atol=5e-3)
    torch.testing.assert_close(lse, rlse, atol=1e-3, rtol=1e-4)


def test_causal_flash_attention_kernel_replays_in_a_cuda_graph():
    """K4 allocates only its outputs and launches once: a CUDA graph of the
    call at the training shape replays to the eager result, bit for bit,
    on new inputs too."""
    q, k, v = (_randn(8, 128, 20, 64, seed=s) for s in (69, 70, 71))

    def call():
        return fa.flash_attention_fwd(q, k, v, causal=True)

    want = call()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = call()
    graph.replay()
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(out, want))
    q.copy_(_randn(8, 128, 20, 64, seed=72))
    graph.replay()
    want = call()
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(out, want))


def _assert_grad_near(got, ref, name):
    got, ref = got.float(), ref.float()
    torch.testing.assert_close(got, ref, atol=1e-2 * float(ref.abs().max()), rtol=1e-2,
                               msg=lambda m: f"{name}: {m}")
    rel = float((got - ref).norm() / ref.norm())
    assert rel <= 1e-2, f"{name}: relative L2 error {rel:.3e}"


@pytest.mark.parametrize("b, tq, tk, h, causal", [
    (2, 130, 130, 3, True),      # causal, ragged T
    (8, 128, 128, 20, True),     # training self-attention shape
    (1, 70, 1500, 3, False),     # cross, ragged Tq and Tk
    (3, 64, 200, 2, False),      # one exact Q tile, B*H tail
    (8, 128, 1500, 20, False),   # training cross-attention shape
    (2, 300, 300, 3, True),      # several query and key tiles, causal
    (1, 260, 1500, 2, False),    # several query and key tiles, cross
])
def test_flash_attention_backward_kernel(b, tq, tk, h, causal):
    q = _randn(b, tq, h, 64, seed=10)
    k = _randn(b, tk, h, 64, seed=11)
    v = _randn(b, tk, h, 64, seed=12)
    do = _randn(b, tq, h, 64, seed=13)
    o, lse = fa.flash_attention_fwd(q, k, v, causal=causal)
    before = fa.flash_attention_bwd.launches
    got = fa.flash_attention_bwd(q, k, v, o, lse, do, causal=causal)
    torch.cuda.synchronize()
    assert fa.flash_attention_bwd.launches == before + 1
    ref = fa.flash_attention_bwd_reference(q, k, v, o, lse, do, causal=causal)
    for name, g, r in zip(("dq", "dk", "dv"), got, ref):
        assert g.dtype == torch.bfloat16 and g.shape == r.shape
        _assert_grad_near(g, r, name)


def _assert_dq_reordered(got, want):
    """dQ summed over key tiles by fp32 reduce-adds whose order varies from
    run to run: within one bf16 rounding step (2^-7 relative) plus 1e-5 of
    the largest magnitude for sums near zero."""
    torch.testing.assert_close(got.float(), want.float(), rtol=2**-7,
                               atol=1e-5 * float(want.float().abs().max()))


def _k5_inputs(b, tq, tk, h, seed):
    q, do = _randn(b, tq, h, 64, seed=seed), _randn(b, tq, h, 64, seed=seed + 1)
    k, v = _randn(b, tk, h, 64, seed=seed + 2), _randn(b, tk, h, 64, seed=seed + 3)
    return q, k, v, do


@pytest.mark.parametrize("tk, causal", [(128, True), (1500, False)])
def test_flash_attention_backward_kernel_replays_in_a_cuda_graph(tk, causal):
    """K5 allocates only its outputs and scratch and launches its passes on
    the current stream: a CUDA graph of the call at the training shapes
    replays to the eager result (dK, dV bit for bit; dQ, summed by
    reduce-adds across key tiles at Tk=1500, within their reordering), on
    new inputs too."""
    q, k, v, do = _k5_inputs(8, 128, tk, 20, seed=80)
    o, lse = fa.flash_attention_fwd(q, k, v, causal=causal)

    def call():
        return fa.flash_attention_bwd(q, k, v, o, lse, do, causal=causal)

    for fresh in (False, True):
        if fresh:
            do.copy_(_randn(8, 128, 20, 64, seed=85))
        else:
            call()
            torch.cuda.synchronize()
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                out = call()
        graph.replay()
        torch.cuda.synchronize()
        want = call()
        torch.cuda.synchronize()
        assert torch.equal(out[1], want[1]) and torch.equal(out[2], want[2])
        if causal:  # one key tile: dQ written directly, no reduce-add
            assert torch.equal(out[0], want[0])
        else:
            _assert_dq_reordered(out[0], want[0])


def test_flash_attention_backward_first_call_in_a_new_thread():
    """K5 as the first CUDA work of a fresh thread (as in autograd's
    backward thread, where no context is current yet): it encodes its
    tensor maps and launches there, and equals the call on this thread."""
    q, k, v, do = _k5_inputs(2, 130, 300, 3, seed=93)
    o, lse = fa.flash_attention_fwd(q, k, v)
    want = fa.flash_attention_bwd(q, k, v, o, lse, do, causal=False)
    torch.cuda.synchronize()
    got = []
    thread = threading.Thread(
        target=lambda: got.append(fa.flash_attention_bwd(q, k, v, o, lse, do, causal=False)))
    thread.start()
    thread.join()
    assert got, "K5 raised in the new thread"
    torch.cuda.synchronize()
    assert torch.equal(got[0][1], want[1]) and torch.equal(got[0][2], want[2])
    _assert_dq_reordered(got[0][0], want[0])


def test_flash_attention_backward_kernel_runs_agree():
    """Two runs at the cross shape: dK and dV equal, dQ within the
    reordering of its fp32 reduce-adds."""
    q, k, v, do = _k5_inputs(8, 128, 1500, 20, seed=90)
    o, lse = fa.flash_attention_fwd(q, k, v)
    a = fa.flash_attention_bwd(q, k, v, o, lse, do, causal=False)
    b = fa.flash_attention_bwd(q, k, v, o, lse, do, causal=False)
    torch.cuda.synchronize()
    assert torch.equal(a[1], b[1]) and torch.equal(a[2], b[2])
    _assert_dq_reordered(a[0], b[0])


@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_backward_reads_fused_projections_in_place(causal):
    """K5 on the column blocks of a fused qkv (causal, T=130) or of a q
    and a fused kv (cross, 128 x 1500) projection at their strides equals
    K5 on copies, and the twin."""
    b, h = 2, 4
    if causal:
        tq = tk = 130
        q, k, v = (x.reshape(b, tq, h, 64) for x in _randn(b, tq, 3 * h * 64, seed=95).chunk(3, -1))
    else:
        tq, tk = 128, 1500
        q = _randn(b, tq, h, 64, seed=96)
        k, v = (x.reshape(b, tk, h, 64) for x in _randn(b, tk, 2 * h * 64, seed=97).chunk(2, -1))
    assert not k.is_contiguous()
    do = _randn(b, tq, h, 64, seed=98)
    o, lse = fa.flash_attention_fwd(q, k, v, causal=causal)
    got = fa.flash_attention_bwd(q, k, v, o, lse, do, causal=causal)
    copies = fa.flash_attention_bwd(q.contiguous(), k.contiguous(), v.contiguous(), o, lse, do,
                                    causal=causal)
    torch.cuda.synchronize()
    assert torch.equal(got[1], copies[1]) and torch.equal(got[2], copies[2])
    _assert_dq_reordered(got[0], copies[0])
    ref = fa.flash_attention_bwd_reference(q, k, v, o, lse, do, causal=causal)
    for name, g, r in zip(("dq", "dk", "dv"), got, ref):
        _assert_grad_near(g, r, name)


def test_flash_attention_autograd_on_card():
    """FlashAttention's gradients (K4 forward, K5 backward) against autograd
    of the plain twin, bf16 on the card."""
    q, k, v = (_randn(2, 96, 4, 64, seed=s).requires_grad_() for s in (14, 15, 16))
    do = _randn(2, 96, 4, 64, seed=17)
    fa.flash_attention(q, k, v, causal=True).backward(do)
    got = [t.grad for t in (q, k, v)]
    q2, k2, v2 = (t.detach().clone().requires_grad_() for t in (q, k, v))
    fa.flash_attention_reference(q2, k2, v2, causal=True)[0].backward(do)
    for name, g, t in zip(("dq", "dk", "dv"), got, (q2, k2, v2)):
        _assert_grad_near(g, t.grad, name)


@pytest.mark.parametrize("int8", [True, False], ids=["int8", "bf16"])
@pytest.mark.parametrize("t, valid", [(1500, 1500), (51, 7), (200, "rows")])
def test_decode_attention_kernel(int8, t, valid):
    b, h = 4, 20
    q = _randn(b, h, 64, seed=4)
    k = _randn(b, t, h * 64, seed=5)
    v = _randn(b, t, h * 64, seed=6)
    ks = vs = None
    if int8:
        k, ks = quantize_kv_rows(k)
        v, vs = quantize_kv_rows(v)
    if valid == "rows":
        valid = torch.tensor([t, 1, 64, 65], dtype=torch.int32, device="cuda")
    got = da.decode_attention(q, k, v, valid, n_heads=h, k_scale=ks, v_scale=vs)
    torch.cuda.synchronize()
    ref = da.decode_attention_reference(q, k, v, valid, n_heads=h, k_scale=ks, v_scale=vs)
    _assert_near(got, ref, atol=2e-3)


def _k2_counter(t, kv_dtype, ring=False):
    """The launch counter of the K2 form a call takes: the ring form with
    ring_pos, else the self form on the caches `self_form` names (at most
    512 slots, not packed int4), else the prefix form's clusters."""
    if ring:
        return "ring_launches"
    return "self_launches" if da.self_form(t, kv_dtype) else "launches"


def _k2_launches():
    return (da.decode_attention.launches, da.decode_attention.self_launches,
            da.decode_attention.ring_launches)


def _decode_inputs(b, t, h, int8, seed):
    q = _randn(b, h, 64, seed=seed)
    k = _randn(b, t, h * 64, seed=seed + 1)
    v = _randn(b, t, h * 64, seed=seed + 2)
    ks = vs = None
    if int8:
        k, ks = quantize_kv_rows(k)
        v, vs = quantize_kv_rows(v)
    return q, k, v, ks, vs


@pytest.mark.parametrize("int8", [True, False], ids=["int8", "bf16"])
@pytest.mark.parametrize("t", [1, 51, 64, 65, 1500])
@pytest.mark.parametrize("per_row", [False, True], ids=["scalar", "rows"])
def test_decode_attention_kernel_splits(int8, t, per_row):
    """K2 at cache lengths around its plans (the self form up to 512
    slots, then clusters of up to 8 CTAs); per-row valid lengths of 1 and 2
    leave whole CTAs of a cluster empty, which the combine must skip. One
    launch a call, on the form `self_form` names."""
    b, h = 4, 20
    q, k, v, ks, vs = _decode_inputs(b, t, h, int8, seed=61)
    valid = (torch.tensor([t, 1, min(t, 2), (t + 1) // 2], dtype=torch.int32, device="cuda")
             if per_row else t)
    counter = _k2_counter(t, k.dtype)
    before = getattr(da.decode_attention, counter)
    got = da.decode_attention(q, k, v, valid, n_heads=h, k_scale=ks, v_scale=vs)
    torch.cuda.synchronize()
    assert getattr(da.decode_attention, counter) == before + 1
    ref = da.decode_attention_reference(q, k, v, valid, n_heads=h, k_scale=ks, v_scale=vs)
    _assert_near(got, ref, atol=2e-3)


@pytest.mark.parametrize("int8", [True, False], ids=["int8", "bf16"])
def test_decode_attention_kernel_replays_in_a_cuda_graph(int8):
    """K2 allocates only its output and launches once: a CUDA graph of the
    call replays to the eager result, bit for bit, on new inputs too."""
    b, t, h = 16, 1500, 20
    q, k, v, ks, vs = _decode_inputs(b, t, h, int8, seed=64)
    valid = torch.tensor([t, 700, 1, 188], dtype=torch.int32, device="cuda").repeat(4)

    def call():
        return da.decode_attention(q, k, v, valid, n_heads=h, k_scale=ks, v_scale=vs)

    want = call()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = call()
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, want)
    q.copy_(_randn(b, h, 64, seed=65))
    valid.fill_(999)
    graph.replay()
    want = call()
    torch.cuda.synchronize()
    assert torch.equal(out, want)


@pytest.mark.parametrize("int8", [True, False], ids=["int8", "bf16"])
@pytest.mark.parametrize("t", [51, 176, 448])
@pytest.mark.parametrize("at", ["third", "first", "last"])
def test_decode_attention_ring_kernel(int8, t, at):
    """K2's ring form (csrc/decode_attention_ring.cu): each row's keys are
    its valid most recent slots, ending at ring_pos (a third of the way in,
    slot 0, or slot t - 1); rows longer than ring_pos + 1 wrap past slot
    t - 1, one row ends exactly at slot 0, another takes every slot. One
    launch a call."""
    b, h = 6, 20
    ring = {"third": t // 3, "first": 0, "last": t - 1}[at]
    q, k, v, ks, vs = _decode_inputs(b, t, h, int8, seed=70)
    valid = torch.tensor([t, 1, ring + 1, min(t, ring + 2), t - 1, (2 * t) // 3],
                         dtype=torch.int32, device="cuda")
    ring_pos = torch.tensor(ring, dtype=torch.int32, device="cuda")
    before = da.decode_attention.ring_launches
    got = da.decode_attention(q, k, v, valid, n_heads=h, k_scale=ks, v_scale=vs,
                              ring_pos=ring_pos)
    torch.cuda.synchronize()
    assert da.decode_attention.ring_launches == before + 1
    ref = da.decode_attention_reference(q, k, v, valid, n_heads=h, k_scale=ks, v_scale=vs,
                                        ring_pos=ring_pos)
    _assert_near(got, ref, atol=2e-3)
    # a scalar valid length over the same ring
    got = da.decode_attention(q, k, v, t - 5, n_heads=h, k_scale=ks, v_scale=vs,
                              ring_pos=ring_pos)
    ref = da.decode_attention_reference(q, k, v, t - 5, n_heads=h, k_scale=ks, v_scale=vs,
                                        ring_pos=ring_pos)
    _assert_near(got, ref, atol=2e-3)


def _self_inputs(b, t, h, mode, seed):
    """q and a self cache in mode `mode`: bf16; int8 with fp32 row scales;
    int8 with bf16 per-head scales (the int4 cache's self K/V); fp32 (q
    fp32 too). -> (q, k, v, k_scale, v_scale)."""
    f32 = mode == "fp32"
    q = _randn(b, h, 64, seed=seed, dtype=torch.float32 if f32 else torch.bfloat16)
    out = []
    for s in (seed + 1, seed + 2):
        x = _randn(b, t, h * 64, seed=s, dtype=torch.float32 if f32 else torch.bfloat16)
        if mode == "int8":
            out += list(quantize_kv_rows(x))
        elif mode == "int8h":
            out += list(quantize_kv_heads(x, h, 8))
        else:
            out += [x, None]
    k, ks, v, vs = out
    return q, k, v, ks, vs


@pytest.mark.parametrize("heads", [20, 10])
@pytest.mark.parametrize("valid", ["scalar", "rows"])
@pytest.mark.parametrize("t", [1, 51, 448])
@pytest.mark.parametrize("mode", ["bf16", "int8", "int8h", "fp32"])
def test_decode_attention_self_form(mode, t, valid, heads):
    """K2's self form (the ring kernel without ring_pos: key j at slot j)
    in the four modes of a self cache, at T=1 (a first step), 51 (phase 4's
    cache) and 448 (the decoder's most positions), a scalar valid length
    and ragged per-row ones, at 20 heads and a TP rank's 10. One launch of
    the self form a call; bf16 outputs within K2's bounds (atol 2e-3,
    relative L2 <= 1e-2), fp32 within 1e-5, each above a control: the twin
    without the last half of each row's keys reads >= 1e-2 away."""
    b = 6
    q, k, v, ks, vs = _self_inputs(b, t, heads, mode, seed=300 + t)
    if valid == "rows":
        valid = torch.tensor([t, 1, max(1, t // 2), max(1, t - 1), max(1, (2 * t) // 3),
                              min(t, 2)], dtype=torch.int32, device="cuda")
    else:
        valid = max(1, t - 3)
    kw = dict(n_heads=heads, k_scale=ks, v_scale=vs)
    before = _k2_launches()
    got = da.decode_attention(q, k, v, valid, **kw)
    torch.cuda.synchronize()
    assert _k2_launches() == (before[0], before[1] + 1, before[2])
    ref = da.decode_attention_reference(q, k, v, valid, **kw)
    if mode == "fp32":
        _assert_fp32(got, ref)
    else:
        _assert_near(got, ref, atol=2e-3)
    n = torch.as_tensor(valid, device="cuda").expand(b)
    if int(n.max()) >= 2:  # the control: keys [0, ceil(n / 2)) only, on rows of >= 2 keys
        half = da.decode_attention_reference(q, k, v, ((n + 1) // 2).to(torch.int32), **kw)
        rows = n >= 2
        control = float((half[rows] - ref[rows]).float().norm() / ref[rows].float().norm())
        assert control >= 1e-2, f"control relative L2 {control:.3e}"


@pytest.mark.parametrize("mode", ["bf16", "int8", "int8h", "fp32"])
def test_decode_attention_self_form_replays_in_a_cuda_graph(mode):
    """The self form allocates only its output and launches once: a CUDA
    graph of a call at phase 4's shape (B=16, T=51, 20 heads) with per-row
    valid lengths replays to the eager result bit for bit, also after new
    queries and valid lengths are written into the captured inputs."""
    b, t, h = 16, 51, 20
    q, k, v, ks, vs = _self_inputs(b, t, h, mode, seed=320)
    valid = torch.arange(1, b + 1, dtype=torch.int32, device="cuda") * 3

    def call():
        return da.decode_attention(q, k, v, valid, n_heads=h, k_scale=ks, v_scale=vs)

    want = call()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = call()
    before = _k2_launches()
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, want) and _k2_launches() == before
    q.copy_(_randn(*q.shape, seed=321, dtype=q.dtype))
    valid.copy_(torch.arange(b, 0, -1, dtype=torch.int32, device="cuda") * 3)
    graph.replay()
    want = call()
    torch.cuda.synchronize()
    assert torch.equal(out, want)


@pytest.mark.parametrize("int8", [True, False], ids=["int8", "bf16"])
@pytest.mark.parametrize("beams", [1, 3, 5, 8, 17])
@pytest.mark.parametrize("t", [1, 51, 1500])
def test_decode_attention_beam_kernel(int8, beams, t):
    """K2's beam form (csrc/decode_attention_beam.cu): a group's beam
    queries against its one shared row, read once; beam counts past 6 (the
    earlier kernel's cap) and past one 16-beam tile; 3 groups split T=1500
    over a cluster of key shares. One launch a call."""
    g, h = 3, 20
    q = _randn(g, beams, h, 64, seed=80)
    _, k, v, ks, vs = _decode_inputs(g, t, h, int8, seed=81)
    before = da.decode_attention_beam.launches
    got = da.decode_attention_beam(q, k, v, n_heads=h, k_scale=ks, v_scale=vs)
    torch.cuda.synchronize()
    assert da.decode_attention_beam.launches == before + 1
    ref = da.decode_attention_reference_beam(q, k, v, n_heads=h, k_scale=ks, v_scale=vs)
    _assert_near(got, ref, atol=2e-3)


@pytest.mark.parametrize("form", ["ring", "beam"])
def test_decode_attention_forms_replay_in_a_cuda_graph(form):
    """Both new forms allocate only their output and launch once: a CUDA
    graph replays them to the eager result, bit for bit, after new
    ring_pos and valid values (ring) or new queries (beam) are written
    into the captured inputs."""
    h = 20
    if form == "ring":
        b, t = 16, 176
        q, k, v, ks, vs = _decode_inputs(b, t, h, True, seed=90)
        valid = torch.arange(1, b + 1, dtype=torch.int32, device="cuda") * 11
        ring_pos = torch.tensor(20, dtype=torch.int32, device="cuda")

        def call():
            return da.decode_attention(q, k, v, valid, n_heads=h, k_scale=ks, v_scale=vs,
                                       ring_pos=ring_pos)
    else:
        q = _randn(12, 5, h, 64, seed=91)
        _, k, v, ks, vs = _decode_inputs(12, 1500, h, True, seed=92)

        def call():
            return da.decode_attention_beam(q, k, v, n_heads=h, k_scale=ks, v_scale=vs)

    want = call()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = call()
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, want)
    if form == "ring":
        ring_pos.fill_(170)
        valid.copy_(torch.arange(b, 0, -1, dtype=torch.int32, device="cuda") * 11)
    else:
        q.copy_(_randn(12, 5, h, 64, seed=93))
    graph.replay()
    want = call()
    torch.cuda.synchronize()
    assert torch.equal(out, want)


def _heads_inputs(b, t, h, bits, seed):
    """q, and K/V quantized per head (bf16 scales): packed int4 (4 bits, the
    int4 cache's cross K/V) or int8 (8 bits, its self K/V)."""
    q = _randn(b, h, 64, seed=seed)
    out = [q]
    for s in (seed + 1, seed + 2):
        codes, scale = quantize_kv_heads(_randn(b, t, h * 64, seed=s), h, bits)
        out += [pack_int4(codes) if bits == 4 else codes, scale]
    q, k, ks, v, vs = out
    return q, k, v, ks, vs


@pytest.mark.parametrize("heads", [20, 10])
@pytest.mark.parametrize("form", ["prefix-int4-cross", "prefix-int4-rows", "prefix-int8-self",
                                  "ring-int8", "beam-int4"])
def test_decode_attention_per_head_forms(form, heads):
    """K2's three forms in the int4 cache's modes, at large-v3's 20 heads
    and a tensor-parallel rank's 10: the prefix form over packed int4 cross
    K/V (T=1500, scalar and per-row valid lengths), the self form over int8
    self K/V (T=51), the ring form over int8 self K/V (T=176, rows wrapping), the
    beam form over packed int4 cross K/V (3 groups x 5 beams and 12 x 5);
    per-head bf16 scales; one launch a call, held to the twin."""
    if form == "beam-int4":
        for g in (3, 12):
            q = _randn(g, 5, heads, 64, seed=100)
            _, k, v, ks, vs = _heads_inputs(g, 1500, heads, 4, seed=101)
            before = da.decode_attention_beam.launches
            got = da.decode_attention_beam(q, k, v, n_heads=heads, k_scale=ks, v_scale=vs)
            torch.cuda.synchronize()
            assert da.decode_attention_beam.launches == before + 1
            ref = da.decode_attention_reference_beam(q, k, v, n_heads=heads, k_scale=ks,
                                                     v_scale=vs)
            _assert_near(got, ref, atol=2e-3)
        return
    t = {"prefix-int8-self": 51, "ring-int8": 176}.get(form, 1500)
    bits = 4 if "int4" in form else 8
    q, k, v, ks, vs = _heads_inputs(6, t, heads, bits, seed=102)
    kw = dict(n_heads=heads, k_scale=ks, v_scale=vs)
    valid = t
    counter = _k2_counter(t, k.dtype)
    if form == "ring-int8":
        valid = torch.tensor([t, 1, 41, 100, t - 1, 7], dtype=torch.int32, device="cuda")
        kw["ring_pos"] = torch.tensor(40, dtype=torch.int32, device="cuda")
        counter = "ring_launches"
    elif form == "prefix-int4-rows":
        valid = torch.tensor([t, 1, 2, 700, 188, 189], dtype=torch.int32, device="cuda")
    before = getattr(da.decode_attention, counter)
    got = da.decode_attention(q, k, v, valid, **kw)
    torch.cuda.synchronize()
    assert getattr(da.decode_attention, counter) == before + 1
    ref = da.decode_attention_reference(q, k, v, valid, **kw)
    _assert_near(got, ref, atol=2e-3)


def _every_code(rows, cols):
    """(rows, cols) bytes whose low and high nibbles each take all 16 int4
    codes down every column (rows a multiple of 16)."""
    r = torch.arange(rows)[:, None]
    c = torch.arange(cols)[None, :]
    return (((r + c) % 16) | (((r + 3 * c + 5) % 16) << 4)).to(torch.uint8).cuda()


@pytest.mark.parametrize("form", ["prefix", "beam"])
def test_int4_unpack_takes_every_code(form):
    """Every int4 code (-8 .. 7, at every nibble position) through the
    kernels' unpack: with one key the output is that key's V row times its
    scale, exact in bf16, so it must equal the twin's bit for bit; over 64
    keys whose K takes every code the output is held to the twin."""
    h, rows = 20, 16
    ones = torch.ones(rows, 1, h, dtype=torch.bfloat16, device="cuda")
    kv = _every_code(rows, h * 32)[:, None]  # (16, 1, H*32): T=1
    if form == "prefix":
        q = _randn(rows, h, 64, seed=103)
        got = da.decode_attention(q, kv, kv.clone(), 1, n_heads=h, k_scale=ones, v_scale=ones)
        ref = da.decode_attention_reference(q, kv, kv, 1, n_heads=h, k_scale=ones,
                                            v_scale=ones)
    else:
        q = _randn(rows, 3, h, 64, seed=103)
        got = da.decode_attention_beam(q, kv, kv.clone(), n_heads=h, k_scale=ones, v_scale=ones)
        ref = da.decode_attention_reference_beam(q, kv, kv, n_heads=h, k_scale=ones,
                                                 v_scale=ones)
    torch.cuda.synchronize()
    assert torch.equal(got, ref.to(torch.bfloat16))
    assert set(da.unpack_int4(kv).unique().tolist()) == set(range(-8, 8))
    # 64 keys: every code in K's scores
    k = _every_code(64, h * 32).view(1, 64, h * 32).repeat(rows // 16 * 2, 1, 1)
    scale = torch.full((k.shape[0], 64, h), 0.25, dtype=torch.bfloat16, device="cuda")
    v = k.roll(7, dims=1).contiguous()
    if form == "prefix":
        q = _randn(k.shape[0], h, 64, seed=104)
        got = da.decode_attention(q, k, v, 64, n_heads=h, k_scale=scale, v_scale=scale)
        ref = da.decode_attention_reference(q, k, v, 64, n_heads=h, k_scale=scale,
                                            v_scale=scale)
    else:
        q = _randn(k.shape[0], 5, h, 64, seed=104)
        got = da.decode_attention_beam(q, k, v, n_heads=h, k_scale=scale, v_scale=scale)
        ref = da.decode_attention_reference_beam(q, k, v, n_heads=h, k_scale=scale,
                                                 v_scale=scale)
    _assert_near(got, ref, atol=2e-3)


@pytest.mark.parametrize("form", ["prefix-int4", "prefix-int8-self", "ring-int8", "beam-int4"])
def test_decode_attention_per_head_forms_replay_in_a_cuda_graph(form):
    """The int4 cache's forms allocate only their output and launch once: a
    CUDA graph replays each to the eager result, bit for bit, after new
    queries (and ring values) are written into the captured inputs."""
    h = 20
    if form == "beam-int4":
        q = _randn(12, 5, h, 64, seed=105)
        _, k, v, ks, vs = _heads_inputs(12, 1500, h, 4, seed=106)

        def call():
            return da.decode_attention_beam(q, k, v, n_heads=h, k_scale=ks, v_scale=vs)
    else:
        b, t = 16, {"prefix-int4": 1500, "prefix-int8-self": 51, "ring-int8": 176}[form]
        q, k, v, ks, vs = _heads_inputs(b, t, h, 4 if "int4" in form else 8, seed=107)
        valid = torch.arange(1, b + 1, dtype=torch.int32, device="cuda") * (t // b)
        ring_pos = torch.tensor(20, dtype=torch.int32, device="cuda") if form == "ring-int8" \
            else None

        def call():
            return da.decode_attention(q, k, v, valid, n_heads=h, k_scale=ks, v_scale=vs,
                                       ring_pos=ring_pos)

    want = call()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = call()
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, want)
    q.copy_(_randn(*q.shape, seed=108))
    if form == "ring-int8":
        ring_pos.fill_(170)
    graph.replay()
    want = call()
    torch.cuda.synchronize()
    assert torch.equal(out, want)


@pytest.mark.parametrize("bad", ["int4-fp32-scales", "int4-row-scales", "int8-head-shape",
                                 "int8-fp16-scales", "ring-int4", "beam-int8-heads",
                                 "beam-int4-misaligned-scales", "int4-no-scales"])
def test_decode_attention_refuses_mismatched_scales(bad):
    """On the card each K/V mode takes only its own scales, and a form
    refuses a mode its kernel lacks, with a ValueError and no launch."""
    h, t = 4, 64
    q = _randn(2, h, 64, seed=109)
    _, k4, v4, ks4, vs4 = _heads_inputs(2, t, h, 4, seed=110)
    _, k8, v8, ks8, vs8 = _heads_inputs(2, t, h, 8, seed=111)
    kw = {}
    if bad == "int4-fp32-scales":
        k, v, ks, vs = k4, v4, ks4.float(), vs4.float()
    elif bad == "int4-row-scales":
        k, v, ks, vs = k4, v4, ks4[..., :1].contiguous(), vs4[..., :1].contiguous()
    elif bad == "int8-head-shape":
        k, v, ks, vs = k8, v8, ks8[..., :3].contiguous(), vs8[..., :3].contiguous()
    elif bad == "int8-fp16-scales":
        k, v, ks, vs = k8, v8, ks8[..., :1].half().contiguous(), vs8[..., :1].half().contiguous()
    elif bad == "ring-int4":
        k, v, ks, vs = k4, v4, ks4, vs4
        kw["ring_pos"] = torch.tensor(3, dtype=torch.int32, device="cuda")
    elif bad == "int4-no-scales":
        k, v, ks, vs = k4, v4, None, None
    else:
        qb = _randn(2, 3, h, 64, seed=112)
        if bad == "beam-int8-heads":
            k, v, ks, vs = k8, v8, ks8, vs8
        else:  # scales one bf16 into a buffer: 2-byte aligned
            buf_k = torch.empty(ks4.numel() + 1, dtype=torch.bfloat16, device="cuda")
            buf_v = torch.empty_like(buf_k)
            ks, vs = buf_k[1:].view(ks4.shape), buf_v[1:].view(vs4.shape)
            ks.copy_(ks4)
            vs.copy_(vs4)
            k, v = k4, v4
        before = da.decode_attention_beam.launches
        with pytest.raises(ValueError, match="K2"):
            da.decode_attention_beam(qb, k, v, n_heads=h, k_scale=ks, v_scale=vs)
        assert da.decode_attention_beam.launches == before
        return
    before = _k2_launches()
    with pytest.raises(ValueError, match="K2"):
        da.decode_attention(q, k, v, t, n_heads=h, k_scale=ks, v_scale=vs, **kw)
    assert _k2_launches() == before


def _wide_range_audio(b, n, seed):
    """A 440 Hz tone at amplitude 0.5 over noise at 1e-4, with a stretch of
    exact zeros: mel bins near the max-8 clamp and at the 1e-10 floor."""
    t = np.arange(n) / 16000.0
    audio = 0.5 * np.sin(2 * np.pi * 440.0 * t) + 1e-4 * np.random.default_rng(seed).standard_normal((b, n))
    audio[:, n // 3: n // 2] = 0.0
    return audio


@pytest.mark.parametrize("n_samples", [480000, 400, 401, 16037])
@pytest.mark.parametrize("signal", ["noise", "wide"])
@pytest.mark.parametrize("n_mels", [80, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.int16])
def test_log_mel_kernel(n_mels, dtype, signal, n_samples):
    """K3 against its dense twin: white noise and a wide dynamic range, a
    30 s window and clips of one and two frames and a ragged frame count."""
    cfg = FeatureConfig(n_mels=n_mels)
    if signal == "noise":
        audio = np.random.default_rng(n_mels).standard_normal((3, n_samples)) * 0.1
    else:
        audio = _wide_range_audio(3, n_samples, seed=n_mels)
    if dtype == torch.int16:
        audio = np.clip(np.round(audio * 32768), -32768, 32767).astype(np.int16)
    x = torch.from_numpy(np.asarray(audio, dtype=np.float32 if dtype == torch.float32 else np.int16)).cuda()
    before = mel.log_mel_frames.launches
    got = mel.finish_log_mel(mel.log_mel_frames(x, cfg))
    assert mel.log_mel_frames.launches == before + 1
    ref = mel.finish_log_mel(mel.log_mel_frames_reference(x, cfg))
    assert got.shape == ref.shape == (3, n_mels, n_samples // 160)
    torch.testing.assert_close(got, ref, atol=1e-4, rtol=0)
    rel = float((got - ref).norm() / ref.norm())
    assert rel <= 1e-2, f"relative L2 error {rel:.3e}"


def test_log_mel_kernel_short_clip():
    """A clip whose frame count is not a multiple of the block's 16."""
    cfg = FeatureConfig(n_mels=128)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((2, 16000 + 37)).astype(np.float32)).cuda()
    torch.testing.assert_close(
        mel.log_mel_frames(x, cfg), mel.log_mel_frames_reference(x, cfg), atol=1e-4, rtol=0
    )


@pytest.mark.parametrize("causal", [False, True])
def test_flash_attention_reads_fused_projections_in_place(causal):
    """K1/K4 on the q/k/v column blocks of a fused (B, T, 3*H*64) qkv
    projection (token stride 3*H*64) equal the kernel on copies."""
    b, t, h = 2, 130, 4
    qkv = _randn(b, t, 3 * h * 64, seed=20)
    q, k, v = (x.reshape(b, t, h, 64) for x in qkv.chunk(3, dim=-1))
    assert not q.is_contiguous()
    o, lse = fa.flash_attention_fwd(q, k, v, causal=causal)
    o2, lse2 = fa.flash_attention_fwd(q.contiguous(), k.contiguous(), v.contiguous(), causal=causal)
    torch.cuda.synchronize()
    assert torch.equal(o, o2) and torch.equal(lse, lse2)


def test_decode_attention_reads_a_fused_row():
    b, h, t = 3, 20, 40
    qkv = _randn(b, 1, 3 * h * 64, seed=21)
    q = qkv[..., : h * 64].reshape(b, h, 64)
    k, ks = quantize_kv_rows(_randn(b, t, h * 64, seed=22))
    v, vs = quantize_kv_rows(_randn(b, t, h * 64, seed=23))
    got = da.decode_attention(q, k, v, t, n_heads=h, k_scale=ks, v_scale=vs)
    ref = da.decode_attention(q.contiguous(), k, v, t, n_heads=h, k_scale=ks, v_scale=vs)
    torch.cuda.synchronize()
    assert torch.equal(got, ref)


def _assert_within_bf16_ulp(got, ref):
    """One bf16 ulp of the twin, plus 2e-6: where x is close to the row's
    mean the output is near 0 and a last-bit difference of the fp32 mean
    (sums in another order) is many ulps of that small value."""
    got, ref = got.float(), ref.float()
    ulp = torch.exp2(torch.floor(torch.log2(ref.abs().clamp(min=1e-30))) - 7)
    excess = float(((got - ref).abs() / (ulp + 2e-6)).max())
    assert excess <= 1.0, f"{excess:.2f} of one bf16 ulp + 2e-6"


@pytest.mark.parametrize("w_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", [(2, 1500, 1280), (3, 37, 64), (1, 5, 2048), (24001, 384),
                                   (16, 1500, 1280), (1001, 1280), (4099, 2048)])
def test_layer_norm_kernel(shape, w_dtype):
    """K6 with the weight and bias as stored (bf16 or fp32, read by the
    kernel as they are), widths 64 to 2048, and row counts that do not
    divide the persistent grid (its warps stride over the rows)."""
    d = shape[-1]
    x = _randn(*shape, seed=30) * 3 + 1
    y = _randn(*shape, seed=31)
    w, b = _randn(d, seed=32, dtype=w_dtype), _randn(d, seed=33, dtype=w_dtype)
    before = (ln.layer_norm.launches, ln.add_layer_norm.launches)
    got = ln.layer_norm(x, w, b)
    s, got2 = ln.add_layer_norm(x, y, w, b)
    torch.cuda.synchronize()
    assert (ln.layer_norm.launches, ln.add_layer_norm.launches) == (before[0] + 1, before[1] + 1)
    _assert_within_bf16_ulp(got, ln.layer_norm_reference(x, w, b))
    ref_s, ref2 = ln.add_layer_norm_reference(x, y, w, b)
    assert torch.equal(s, x + y) and torch.equal(s, ref_s)
    _assert_within_bf16_ulp(got2, ref2)


def _stem_convs(seed):
    conv1 = torch.nn.Conv1d(128, 1280, 3, padding=1).cuda()
    conv2 = torch.nn.Conv1d(1280, 1280, 3, stride=2, padding=1).cuda()
    with torch.no_grad():
        for c in (conv1, conv2):
            c.weight.normal_(0.0, 0.02, generator=torch.Generator(device="cuda").manual_seed(seed))
            c.bias.normal_(0.0, 0.1, generator=torch.Generator(device="cuda").manual_seed(seed + 1))
    return conv1.to(torch.bfloat16), conv2.to(torch.bfloat16)


@pytest.mark.parametrize("b", [1, 16])
@pytest.mark.parametrize("t", [3000, 256, 250])
def test_conv_stem_kernel(b, t):
    """K7 at large-v3 width: the full 3000 frames, T=256, and T=250 (ragged
    conv1 and conv2 row tiles), one utterance and the pseudo-labelling
    batch."""
    conv1, conv2 = _stem_convs(34)
    x = _randn(b, 128, t, seed=36)
    before = cs.conv_stem.launches
    with torch.no_grad():
        got = cs.conv_stem(conv1, conv2, x)
        torch.cuda.synchronize()
        ref = cs.conv_stem_reference(conv1.weight, conv1.bias, conv2.weight, conv2.bias, x)
    assert cs.conv_stem.launches == before + 1
    assert got.shape == ref.shape == (b, t // 2, 1280)
    _assert_near(got, ref, atol=1e-2 * float(ref.abs().max()))


def test_conv_stem_kernel_sees_an_in_place_weight_update():
    """K7's cached tap-major weights are rebuilt when a weight changes in
    place: the second call uses the new conv2 weights."""
    conv1, conv2 = _stem_convs(37)
    x = _randn(2, 128, 3000, seed=38)
    with torch.no_grad():
        first = cs.conv_stem(conv1, conv2, x)
        conv2.weight.add_(_randn(*conv2.weight.shape, seed=39) * 0.01)
        before = cs.conv_stem.launches
        got = cs.conv_stem(conv1, conv2, x)
        torch.cuda.synchronize()
        ref = cs.conv_stem_reference(conv1.weight, conv1.bias, conv2.weight, conv2.bias, x)
    assert cs.conv_stem.launches == before + 1
    assert not torch.equal(got, first)
    _assert_near(got, ref, atol=1e-2 * float(ref.abs().max()))


def _int8_twin(q, k, v, mode):
    pv8 = mode == "qkpv"
    k8, ks = fa.quantize_k_rows(k)
    v_in, vs = fa.quantize_v_cols(v) if pv8 else (v, None)
    return fa.flash_attention_int8_reference(q, k8, ks, v_in, vs, pv8)


@pytest.mark.parametrize("mode", ["qk", "qkpv"])
@pytest.mark.parametrize("b, tq, tk, h", [
    (2, 300, 300, 4), (2, 1500, 1500, 20), (1, 70, 70, 3),
    (8, 128, 1500, 20),   # the training cross-attention under KWT_FA_INT8
    (1, 200, 4096, 2),    # the most keys K8 takes
    (3, 64, 1, 2),        # a single key
])
def test_int8_attention_kernel(mode, b, tq, tk, h):
    q = _randn(b, tq, h, 64, seed=40)
    k, v = _randn(b, tk, h, 64, seed=41), _randn(b, tk, h, 64, seed=42)
    before = fa.flash_attention_int8.launches
    o, lse = fa.flash_attention_fwd(q, k, v, int8_mode=mode)
    torch.cuda.synchronize()
    assert fa.flash_attention_int8.launches == before + 1
    ro, rlse = _int8_twin(q, k, v, mode)
    _assert_near(o, ro, atol=5e-3)
    torch.testing.assert_close(lse, rlse, atol=1e-3, rtol=1e-4)


@pytest.mark.parametrize("mode", ["qk", "qkpv"])
@pytest.mark.parametrize("b, tq, tk, h, fused", [
    (2, 1500, 1500, 20, False), (1, 70, 70, 3, False), (8, 128, 1500, 20, False),
    (3, 64, 1, 2, False), (2, 300, 300, 4, True),
])
def test_int8_prepass_equals_the_twin_quantizers(mode, b, tq, tk, h, fused):
    """K8's pre-pass writes k8 and ks equal to `quantize_k_rows` and (qkpv)
    V8^T and vs equal to `quantize_v_cols` after the key permutation, bit for
    bit (`int8_prepass_reference` lays them out), also from the column blocks
    of a fused qkv projection."""
    if fused:
        qkv = _randn(b, tk, 3 * h * 64, seed=44)
        q, k, v = (x.reshape(b, tk, h, 64) for x in qkv.chunk(3, dim=-1))
    else:
        q = _randn(b, tq, h, 64, seed=45)
        k, v = _randn(b, tk, h, 64, seed=46), _randn(b, tk, h, 64, seed=47)
    got = fa.int8_prepass(q, k, v, mode=mode)
    torch.cuda.synchronize()
    want = fa.int8_prepass_reference(k, v, mode == "qkpv")
    for name, g, w in zip(("k8", "ks", "v8t", "vs"), got, want):
        if w is None:
            assert g is None, name
            continue
        assert g.dtype == w.dtype and g.shape == w.shape, name
        assert torch.equal(g, w), name


@pytest.mark.parametrize("mode", ["qk", "qkpv"])
def test_int8_attention_kernel_replays_in_a_cuda_graph(mode):
    """K8 allocates only its outputs and scratch and launches its two
    kernels on the current stream: a CUDA graph of the call at the
    encoder's shape replays to the eager result, bit for bit, on new
    inputs too."""
    q, k, v = (_randn(2, 1500, 20, 64, seed=s) for s in (48, 49, 50))

    def call():
        return fa.flash_attention_int8(q, k, v, mode=mode)

    call()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = call()
    for fresh in (False, True):
        if fresh:
            k.copy_(_randn(2, 1500, 20, 64, seed=51))
        graph.replay()
        torch.cuda.synchronize()
        want = call()
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(out, want)), fresh


def test_int8_attention_first_call_in_a_new_thread():
    """K8 as the first CUDA work of a fresh thread: it encodes its tensor
    maps and launches there, and equals the call on this thread."""
    q, k, v = (_randn(2, 130, 3, 64, seed=s) for s in (52, 53, 54))
    for mode in ("qk", "qkpv"):
        want = fa.flash_attention_int8(q, k, v, mode=mode)
        torch.cuda.synchronize()
        got = []
        thread = threading.Thread(
            target=lambda: got.append(fa.flash_attention_int8(q, k, v, mode=mode)))
        thread.start()
        thread.join()
        assert got, f"K8 {mode} raised in the new thread"
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(got[0], want)), mode


@pytest.mark.parametrize("mode", ["qk", "qkpv"])
def test_int8_attention_kernel_runs_agree(mode):
    """Two runs at the encoder's shape are bitwise equal (no atomics)."""
    q, k, v = (_randn(4, 1500, 20, 64, seed=s) for s in (55, 56, 57))
    a = fa.flash_attention_int8(q, k, v, mode=mode)
    b = fa.flash_attention_int8(q, k, v, mode=mode)
    torch.cuda.synchronize()
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_int8_attention_reads_fused_projections_in_place():
    b, t, h = 2, 300, 4
    qkv = _randn(b, t, 3 * h * 64, seed=43)
    q, k, v = (x.reshape(b, t, h, 64) for x in qkv.chunk(3, dim=-1))
    for mode in ("qk", "qkpv"):
        o, lse = fa.flash_attention_fwd(q, k, v, int8_mode=mode)
        o2, lse2 = fa.flash_attention_fwd(q.contiguous(), k.contiguous(), v.contiguous(),
                                          int8_mode=mode)
        torch.cuda.synchronize()
        assert torch.equal(o, o2) and torch.equal(lse, lse2), mode


@pytest.mark.parametrize("op", ["softmax", "exp"])
@pytest.mark.parametrize("rows, cols, iters", [(512, 1536, 64), (8, 128, 4), (3, 300, 5)])
def test_vpu_cal_kernel(op, rows, cols, iters):
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((rows, cols)).astype(
        np.float32)).cuda()
    got = vpu_cal.vpu_cal(x, iters, op)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, vpu_cal.vpu_cal_reference(x, iters, op), rtol=1e-4, atol=0)


@pytest.mark.parametrize("m", [1, 16, 17, 48])
def test_int8_matmul_on_card(m):
    """torch._int_mm through int8_matmul at the decode step's B rows (1,
    16) and above: exact against an int64 product."""
    rng = np.random.default_rng(m)
    a = torch.from_numpy(rng.integers(-127, 128, (m, 1280)).astype(np.int8)).cuda()
    w = torch.from_numpy(rng.integers(-127, 128, (3840, 1280)).astype(np.int8)).cuda()
    got = int8_matmul(a, w)
    torch.cuda.synchronize()
    assert got.dtype == torch.int32 and got.shape == (m, 3840)
    assert torch.equal(got.cpu().long(), a.cpu().long() @ w.cpu().long().T)


def test_dense_int8_on_card_equals_cpu():
    """The w8a8 projection runs the same fp32 steps on the card as on the
    CPU (where it equals the JAX package's)."""
    lin = torch.nn.Linear(1280, 1280)
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((16, 1, 1280)).astype(
        np.float32))
    q = quantize_dense_int8(lin)
    want = dense_int8(q, x)
    got = dense_int8(q.cuda(), x.cuda())
    torch.testing.assert_close(got.cpu(), want, atol=1e-5, rtol=1e-6)


def _wide_model(decoder_layers=2, encoder_layers=1):
    """large-v3's widths (d=1280, 20 heads, vocab 51866, 128 mels) at a cut
    depth, seeded random bf16 weights on the card, fused projections."""
    from kotoba_whisper_tpu_torch.core.config import PRESETS
    from kotoba_whisper_tpu_torch.models import whisper
    from kotoba_whisper_tpu_torch.models.optimized import fuse_for_inference

    cfg = PRESETS["large-v3"].replace(decoder_layers=decoder_layers,
                                      encoder_layers=encoder_layers)
    model = whisper.init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                                device="cuda", dtype=torch.bfloat16)
    return fuse_for_inference(model), cfg


@pytest.mark.parametrize("kv_dtype", ["int8", "compute"])
@pytest.mark.parametrize("layout", ["ring", "scatter"])
def test_ring_and_beam_forms_in_one_decode_step(monkeypatch, kv_dtype, layout):
    """A beam stream's step at large-v3 width: 12 groups of 5 beams at
    per-group counts, the self rows read through K2's ring form at a ring
    slot that wraps ("ring") or its prefix form at per-row lengths
    ("scatter"), the cross rows (one a group) through its beam form, in
    one step; the logits against the plain path's on the same cache."""
    from kotoba_whisper_tpu_torch.models import whisper

    model, cfg = _wide_model()
    g, k, cap = 12, 5, 176
    enc = _randn(g, 1500, 1280, seed=11) * 0.5
    counts = torch.from_numpy(np.repeat(np.arange(g, dtype=np.int32) * 13 % 150 + 3, k)).cuda()

    def step():
        cache = whisper.init_cache(model, enc, cap, kv_dtype=kv_dtype, beam_size=k)
        if kv_dtype == "int8":
            cache.self_k, cache.self_k_scale = quantize_kv_rows(
                _randn(*cache.self_k.shape, seed=12))
            cache.self_v, cache.self_v_scale = quantize_kv_rows(
                _randn(*cache.self_v.shape, seed=13))
        else:
            cache.self_k = _randn(*cache.self_k.shape, seed=12)
            cache.self_v = _randn(*cache.self_v.shape, seed=13)
        cache.length = counts.clone()
        ids = torch.arange(g * k, device="cuda")[:, None] * 7 + 100
        ring = torch.tensor(5, dtype=torch.int32, device="cuda") if layout == "ring" else None
        logits, cache = whisper.decode(model, ids, cache=cache, beam_size=k, ring_pos=ring)
        return logits[:, 0].float(), cache

    self_count = (lambda: da.decode_attention.ring_launches) if layout == "ring" else (
        lambda: da.decode_attention.self_launches)
    self0, beam0 = self_count(), da.decode_attention_beam.launches
    got, cache = step()
    torch.cuda.synchronize()
    assert self_count() - self0 == cfg.decoder_layers
    assert da.decode_attention_beam.launches - beam0 == cfg.decoder_layers
    assert torch.equal(cache.length, counts + 1)
    monkeypatch.setattr(whisper, "decode_attention", da.decode_attention_reference)
    monkeypatch.setattr(whisper, "decode_attention_beam", da.decode_attention_reference_beam)
    ref, _ = step()
    rel = float((got - ref).norm() / ref.norm())
    assert torch.isfinite(got).all() and rel <= 5e-2, f"logits rel-L2 {rel:.3e}"


def test_beam_stream_at_the_4g_geometry_with_two_groups():
    """Phase 4g's stream (5 beams, refills of 1 here, 8 steps a round, ring
    layout, int8 KV, capacity 176, bench.py's budgets) at 2 groups and a
    cut depth: every utterance is its prompt, then at most its budget's
    tokens (ending at eot or at the budget), then pads, with a finite
    score; K2's ring and beam forms launch once a layer a step each."""
    from kotoba_whisper_tpu_torch.core.config import SpecialTokens
    from kotoba_whisper_tpu_torch.decode import streaming_beam as sb
    from kotoba_whisper_tpu_torch.decode.greedy import GenerateOptions, transcribe_prompt
    from kotoba_whisper_tpu_torch.tools.step_time import realistic_stops

    model, cfg = _wide_model()
    st = SpecialTokens.for_vocab(cfg.vocab_size)
    n, k = 5, 5
    rng = np.random.default_rng(0)
    audio = torch.from_numpy(rng.standard_normal((n, 480000)).astype(np.float32) * 0.1).cuda()
    prompt = transcribe_prompt(st, st.lang_begin + 6)
    stops = realistic_stops(n, len(prompt), rng)
    feats = mel.log_mel_spectrogram(audio, FeatureConfig(n_mels=128)).to(torch.bfloat16)
    ring0, beam0 = da.decode_attention.ring_launches, da.decode_attention_beam.launches
    toks, scores = sb.generate_beam_streaming(
        model, feats, GenerateOptions(prompt_ids=prompt, max_length=176), st, kv_dtype="int8",
        stream=sb.BeamStreamConfig(groups=2, num_beams=k, encode_batch=1, steps_per_round=8),
        stop_at=stops)
    ring_n = da.decode_attention.ring_launches - ring0
    assert ring_n > 0 and ring_n % cfg.decoder_layers == 0
    assert da.decode_attention_beam.launches - beam0 == ring_n
    assert toks.shape == (n, 176) and np.isfinite(scores).all()
    p, pad = len(prompt), cfg.pad_token_id
    for i in range(n):
        row = toks[i]
        assert (row[:p] == prompt).all() and (row[stops[i]:] == pad).all(), i
        sampled = row[p:stops[i]].tolist()
        end = sampled.index(st.eot) + 1 if st.eot in sampled else len(sampled)
        assert all(0 <= t < cfg.vocab_size for t in sampled[:end]), i
        assert all(t == pad for t in sampled[end:]), i


@pytest.mark.parametrize("num_beams", [1, 3])
def test_pipeline_runs_the_kernels_and_matches_the_cpu_twins(monkeypatch, num_beams):
    """AsrPipeline at test-tiny's depths (2 + 2 layers) with the kernels'
    head dim (d=128, 2 heads of 64) in bf16 on a 40 s input (4 chunks in one
    batch): on the card it launches K3 once, K1 once an encoder layer, and
    K2 once a decoder layer a step for self and for cross attention (its
    beam form for the cross with 3 beams); its text and chunks equal the
    same weights' on the CPU, where the wrappers run their plain twins."""
    import copy

    from kotoba_whisper_tpu_torch.core.config import PRESETS
    from kotoba_whisper_tpu_torch.decode import beam, greedy
    from kotoba_whisper_tpu_torch.decode.pipeline import AsrPipeline
    from kotoba_whisper_tpu_torch.models.whisper import init_params
    from kotoba_whisper_tpu_torch.tokenizer.whisper_tokenizer import WhisperTokenizer

    cfg = PRESETS["test-tiny"].replace(d_model=128, encoder_attention_heads=2,
                                       decoder_attention_heads=2)
    model = init_params(cfg, torch.Generator().manual_seed(0), device="cpu", dtype=torch.bfloat16)
    tok = WhisperTokenizer.byte_vocab(cfg.vocab_size)
    pcm = np.random.default_rng(7).integers(-6000, 6000, 40 * 16000).astype(np.int16)
    audio = pcm.astype(np.float32) / 32768.0
    kw = dict(tok=tok, max_length=16, num_beams=num_beams)
    ref = AsrPipeline(model=model, device="cpu", **kw)(audio)
    steps = []
    loop = beam if num_beams > 1 else greedy
    rules = loop.apply_rules
    monkeypatch.setattr(loop, "apply_rules", lambda *a, **k: steps.append(1) or rules(*a, **k))
    def counts():  # K2's prefix and self forms together: test-tiny's caches are short
        return (fa.flash_attention_fwd.launches,
                da.decode_attention.launches + da.decode_attention.self_launches,
                da.decode_attention_beam.launches, mel.log_mel_frames.launches)

    before = counts()
    got = AsrPipeline(model=copy.deepcopy(model).cuda(), **kw)(audio)
    k1, k2, k2beam, k3 = (n - b for n, b in zip(counts(), before))
    per_step = cfg.decoder_layers * len(steps)
    assert steps and (k1, k3) == (cfg.encoder_layers, 1)
    assert (k2, k2beam) == ((per_step, per_step) if num_beams > 1 else (2 * per_step, 0))
    assert got == ref


@pytest.mark.parametrize("heads", [10, 5], ids=["tp2", "tp4"])
@pytest.mark.parametrize("form", ["K1", "K2-cross-int8", "K2-self-int8", "K2-ring", "K2-beam"])
def test_kernels_at_a_tensor_parallel_shard(form, heads):
    """Each attention kernel at a tensor-parallel rank's shapes: large-v3's
    20 heads over a model axis of 2 or 4 (10 or 5 heads a rank, flat K/V of
    640 or 320): K1 at the encoder's B=2 x 1500, K2's prefix form cross
    (T=1500) and self (T=51) int8, its ring form (T=176, W=6) and its beam
    form (3 groups x 5 beams over T=1500), each against its twin."""
    if form == "K1":
        q, k, v = (_randn(2, 1500, heads, 64, seed=s) for s in (90, 91, 92))
        o, lse = fa.flash_attention_fwd(q, k, v)
        ro, rlse = fa.flash_attention_reference(q, k, v)
        _assert_near(o, ro, atol=5e-3)
        torch.testing.assert_close(lse, rlse, atol=1e-3, rtol=1e-4)
        return
    if form == "K2-beam":
        q = _randn(3, 5, heads, 64, seed=93)
        _, k, v, ks, vs = _decode_inputs(3, 1500, heads, True, seed=94)
        got = da.decode_attention_beam(q, k, v, n_heads=heads, k_scale=ks, v_scale=vs)
        ref = da.decode_attention_reference_beam(q, k, v, n_heads=heads, k_scale=ks, v_scale=vs)
        _assert_near(got, ref, atol=2e-3)
        return
    t = {"K2-cross-int8": 1500, "K2-self-int8": 51, "K2-ring": 176}[form]
    q, k, v, ks, vs = _decode_inputs(6, t, heads, True, seed=95)
    kw = dict(n_heads=heads, k_scale=ks, v_scale=vs)
    if form == "K2-ring":
        valid = torch.tensor([t, 1, 41, 100, t - 1, 7], dtype=torch.int32, device="cuda")
        kw["ring_pos"] = torch.tensor(40, dtype=torch.int32, device="cuda")
    else:
        valid = t
    got = da.decode_attention(q, k, v, valid, **kw)
    ref = da.decode_attention_reference(q, k, v, valid, **kw)
    _assert_near(got, ref, atol=2e-3)


# ---------------------------------------------------------------------------
# The fp32 forms of K1/K4 (csrc/flash_attention_f32.cu) and of K2's prefix,
# ring and beam kernels: fp32 arithmetic end to end, held to their fp32
# twins by relative L2 <= 1e-5 and elementwise to 1e-5 + 1e-4 relative
# (sums in another order, exp2 of log2-scaled scores, the approximate ex2)
# ---------------------------------------------------------------------------

def _assert_fp32(got, ref):
    assert got.dtype == torch.float32 and ref.dtype == torch.float32
    torch.testing.assert_close(got, ref, atol=1e-5, rtol=1e-4)
    rel = float((got - ref).norm() / ref.norm())
    assert rel <= 1e-5, f"relative L2 error {rel:.3e}"


@pytest.mark.parametrize("b, tq, tk, h, causal", [
    (2, 1500, 1500, 20, False), (2, 1500, 1500, 10, False), (1, 70, 130, 3, False),
    (3, 64, 1, 2, False), (2, 128, 1500, 20, False), (8, 128, 128, 20, True),
    (2, 130, 130, 3, True), (1, 1, 1, 1, True), (2, 65, 65, 2, True)])
def test_flash_attention_f32_kernel(b, tq, tk, h, causal):
    """K1 and K4 in fp32: non-causal with Tq != Tk (the decoder's cross
    attention), causal end-aligned, ragged tiles; O and the LSE."""
    q = _randn(b, tq, h, 64, seed=200, dtype=torch.float32)
    k = _randn(b, tk, h, 64, seed=201, dtype=torch.float32)
    v = _randn(b, tk, h, 64, seed=202, dtype=torch.float32)
    name = "causal_launches" if causal else "launches"
    before = getattr(fa.flash_attention_fwd, name)
    o, lse = fa.flash_attention_fwd(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert getattr(fa.flash_attention_fwd, name) == before + 1
    ro, rlse = fa.flash_attention_reference(q, k, v, causal)
    _assert_fp32(o, ro)
    torch.testing.assert_close(lse, rlse, atol=1e-5, rtol=1e-6)


@pytest.mark.parametrize("causal", [False, True])
def test_flash_attention_f32_kernel_reads_fused_strides(causal):
    """fp32 q, k and v as column blocks of one fused projection (token
    stride 3 * H * 64) go in without copies."""
    b, t, h = 2, 200, 4
    qkv = _randn(b, t, 3 * h * 64, seed=203, dtype=torch.float32)
    q, k, v = (x.reshape(b, t, h, 64) for x in qkv.chunk(3, dim=-1))
    o, _ = fa.flash_attention_fwd(q, k, v, causal=causal)
    _assert_fp32(o, fa.flash_attention_reference(q, k, v, causal)[0])


def _f32_kv(b, t, h, kv, seed):
    """fp32 K/V in mode `kv`: fp32, int8 with fp32 row scales, int8 or
    packed int4 with bf16 per-head scales -> (k, v, k_scale, v_scale)."""
    out = []
    for s in (seed, seed + 1):
        x = _randn(b, t, h * 64, seed=s, dtype=torch.float32)
        if kv == "fp32":
            out += [x, None]
        elif kv == "int8":
            out += list(quantize_kv_rows(x))
        else:
            codes, scale = quantize_kv_heads(x, h, 4 if kv == "int4" else 8)
            out += [pack_int4(codes) if kv == "int4" else codes, scale]
    k, ks, v, vs = out
    return k, v, ks, vs


@pytest.mark.parametrize("heads", [20, 10])
@pytest.mark.parametrize("kv", ["fp32", "int8", "int8h", "int4"])
@pytest.mark.parametrize("t, valid", [(1500, 1500), (51, 7), (200, "rows"), (1, 1)])
def test_decode_attention_f32_prefix(t, valid, kv, heads):
    """K2's prefix form with fp32 q and output over fp32, int8 and int4
    K/V (an fp32 model's cross and self caches), scalar and per-row valid
    lengths, at 20 heads and a TP=2 shard's 10."""
    b = 4
    q = _randn(b, heads, 64, seed=204, dtype=torch.float32)
    k, v, ks, vs = _f32_kv(b, t, heads, kv, seed=205)
    if valid == "rows":
        valid = torch.tensor([t, 1, 64, 65], dtype=torch.int32, device="cuda")
    counter = _k2_counter(t, k.dtype)
    before = getattr(da.decode_attention, counter)
    got = da.decode_attention(q, k, v, valid, n_heads=heads, k_scale=ks, v_scale=vs)
    torch.cuda.synchronize()
    assert getattr(da.decode_attention, counter) == before + 1
    _assert_fp32(got, da.decode_attention_reference(q, k, v, valid, n_heads=heads, k_scale=ks,
                                                    v_scale=vs))


@pytest.mark.parametrize("heads", [20, 10])
@pytest.mark.parametrize("kv", ["fp32", "int8", "int8h"])
@pytest.mark.parametrize("t", [51, 176, 448])
@pytest.mark.parametrize("at", ["third", "last"])
def test_decode_attention_f32_ring(at, t, kv, heads):
    """K2's ring form in fp32: rows that wrap, one slot, every slot; at
    T=448 (the decoder's most positions) one head's slots exceed a CTA's
    shared memory and the kernel walks them in boxes."""
    b = 6
    ring = {"third": t // 3, "last": t - 1}[at]
    q = _randn(b, heads, 64, seed=206, dtype=torch.float32)
    k, v, ks, vs = _f32_kv(b, t, heads, kv, seed=207)
    valid = torch.tensor([t, 1, ring + 1, min(t, ring + 2), t - 1, (2 * t) // 3],
                         dtype=torch.int32, device="cuda")
    ring_pos = torch.tensor(ring, dtype=torch.int32, device="cuda")
    kw = dict(n_heads=heads, k_scale=ks, v_scale=vs, ring_pos=ring_pos)
    before = da.decode_attention.ring_launches
    got = da.decode_attention(q, k, v, valid, **kw)
    torch.cuda.synchronize()
    assert da.decode_attention.ring_launches == before + 1
    _assert_fp32(got, da.decode_attention_reference(q, k, v, valid, **kw))
    if t == 448:
        assert da.ring_plan(b, t, heads, k.dtype, q_dtype=torch.float32).chunk < t or kv != "fp32"


@pytest.mark.parametrize("heads", [20, 10])
@pytest.mark.parametrize("kv", ["fp32", "int8", "int4"])
@pytest.mark.parametrize("g, beams, t", [(12, 5, 1500), (3, 17, 1500), (2, 5, 1500), (3, 1, 51),
                                         (2, 8, 1)])
def test_decode_attention_f32_beam(g, beams, t, kv, heads):
    """K2's beam form in fp32 (FFMA): 12 x 5 (one CTA a group and head), 17
    beams (two 16-beam tiles), 2 groups (keys split over a cluster), short
    rows."""
    q = _randn(g, beams, heads, 64, seed=208, dtype=torch.float32)
    k, v, ks, vs = _f32_kv(g, t, heads, kv, seed=209)
    before = da.decode_attention_beam.launches
    got = da.decode_attention_beam(q, k, v, n_heads=heads, k_scale=ks, v_scale=vs)
    torch.cuda.synchronize()
    assert da.decode_attention_beam.launches == before + 1
    _assert_fp32(got, da.decode_attention_reference_beam(q, k, v, n_heads=heads, k_scale=ks,
                                                         v_scale=vs))


@pytest.mark.parametrize("form", ["K1", "K4", "prefix", "ring", "beam"])
def test_f32_forms_replay_in_a_cuda_graph(form):
    """Each fp32 form allocates only its outputs and launches once: a CUDA
    graph of it replays to the eager result, also after its inputs (and
    the ring's valid lengths and slot) change in place."""
    h = 20
    if form in ("K1", "K4"):
        t = 128 if form == "K4" else 300
        q, k, v = (_randn(2, t, h, 64, seed=s, dtype=torch.float32) for s in (210, 211, 212))

        def call():
            return fa.flash_attention_fwd(q, k, v, causal=form == "K4")[0]
    elif form == "beam":
        q = _randn(3, 5, h, 64, seed=213, dtype=torch.float32)
        k, v, ks, vs = _f32_kv(3, 1500, h, "int4", seed=214)

        def call():
            return da.decode_attention_beam(q, k, v, n_heads=h, k_scale=ks, v_scale=vs)
    else:
        t = 448 if form == "ring" else 1500
        q = _randn(6, h, 64, seed=215, dtype=torch.float32)
        k, v, ks, vs = _f32_kv(6, t, h, "fp32", seed=216)
        valid = torch.tensor([t, 1, 200, 300, 7, t - 1], dtype=torch.int32, device="cuda")
        ring_pos = torch.tensor(40, dtype=torch.int32, device="cuda")
        kw = dict(ring_pos=ring_pos) if form == "ring" else {}

        def call():
            return da.decode_attention(q, k, v, valid, n_heads=h, **kw)
    call()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = call()
    graph.replay()
    want = call()
    torch.cuda.synchronize()
    assert torch.equal(out, want)
    q.copy_(_randn(*q.shape, seed=217, dtype=torch.float32))
    if form in ("prefix", "ring"):
        valid.copy_(torch.tensor([3, 448 if form == "ring" else 1500, 1, 9, 100, 41],
                                 dtype=torch.int32, device="cuda"))
        ring_pos.fill_(447)
    graph.replay()
    want = call()
    torch.cuda.synchronize()
    assert torch.equal(out, want)


@pytest.mark.parametrize("bad", ["prefix-f32q-bf16kv", "prefix-bf16q-f32kv", "ring-f32q-bf16kv",
                                 "beam-f32q-bf16kv", "beam-bf16q-f32kv", "f32kv-scales",
                                 "flash-mixed"])
def test_f32_forms_refuse_mixed_dtypes(bad):
    """A call that mixes bf16 and fp32 raises on the card, with no launch."""
    h, t = 4, 64
    f32, bf = torch.float32, torch.bfloat16
    if bad == "flash-mixed":
        q = _randn(1, 64, h, 64, seed=218, dtype=f32)
        before = fa.flash_attention_fwd.launches
        with pytest.raises(TypeError, match="one dtype"):
            fa.flash_attention_fwd(q, q.to(bf), q.to(bf))
        assert fa.flash_attention_fwd.launches == before
        return
    q_dtype = f32 if "-f32q" in bad or bad == "f32kv-scales" else bf
    kv_dtype = f32 if "f32kv" in bad else bf
    kv = _randn(2, t, h * 64, seed=219, dtype=kv_dtype)
    scale = torch.ones(2, t, 1, device="cuda") if bad == "f32kv-scales" else None
    if bad.startswith("beam"):
        before = da.decode_attention_beam.launches
        with pytest.raises(ValueError, match="K2"):
            da.decode_attention_beam(_randn(2, 3, h, 64, seed=220, dtype=q_dtype), kv, kv,
                                     n_heads=h)
        assert da.decode_attention_beam.launches == before
        return
    kw = {"ring_pos": torch.tensor(3, dtype=torch.int32, device="cuda")} if "ring" in bad else {}
    before = _k2_launches()
    with pytest.raises(ValueError, match="K2"):
        da.decode_attention(_randn(2, h, 64, seed=221, dtype=q_dtype), kv, kv, t, n_heads=h,
                            k_scale=scale, v_scale=scale, **kw)
    assert _k2_launches() == before


@pytest.mark.parametrize("kernel", ["K5", "K6", "K7", "K8"])
def test_unported_f32_forms_raise(kernel):
    """The fp32 forms of K5 (the backward), K6 (LayerNorm), K7 (the conv
    stem) and K8 (the int8 core's fp32 q), once refused, now launch on CUDA
    tensors: one count each, fp32 out; a call that mixes bf16 and fp32
    still raises, with no launch."""
    f32, bf = torch.float32, torch.bfloat16
    q = _randn(1, 64, 2, 64, seed=222, dtype=f32)
    if kernel == "K5":
        o, lse = fa.flash_attention_fwd(q, q, q, causal=True)
        call, counter = (lambda: fa.flash_attention_bwd(q, q, q, o, lse, q, causal=True)[0],
                         fa.flash_attention_bwd)
        with pytest.raises(TypeError, match="K5"):
            fa.flash_attention_bwd(q, q, q, o, lse, q.to(bf), causal=True)
    elif kernel == "K6":
        w = torch.ones(64, device="cuda")
        x = _randn(4, 64, seed=223, dtype=f32)
        call, counter = (lambda: ln.layer_norm(x, w, w)), ln.layer_norm
        with pytest.raises(ValueError, match="K6"):
            ln.add_layer_norm(x, x.to(bf), w, w)
    elif kernel == "K7":
        conv1 = torch.nn.Conv1d(80, 64, 3, padding=1, device="cuda")
        conv2 = torch.nn.Conv1d(64, 64, 3, stride=2, padding=1, device="cuda")
        x = _randn(1, 80, 256, seed=224, dtype=f32)
        call, counter = (lambda: cs.conv_stem(conv1, conv2, x)), cs.conv_stem
        with pytest.raises(TypeError, match="K7"):
            cs.conv_stem(conv1, conv2, x.half())
    else:
        call, counter = (lambda: fa.flash_attention_int8(q, q, q, mode="qk")[0],
                         fa.flash_attention_int8)
        with pytest.raises(TypeError, match="K8"):
            fa.flash_attention_int8(q, q, q.to(bf), mode="qk")
    before = counter.launches
    out = call()
    torch.cuda.synchronize()
    assert counter.launches == before + 1 and out.dtype == f32


# ---------------------------------------------------------------------------
# The fp32 forms of K5 (csrc/flash_attention_bwd_f32.cu), K6 (fp32 rows of
# csrc/layer_norm.cu), K7 (csrc/conv_stem_f32.cu) and K8 (the fp32-q kernel
# of csrc/flash_attention_int8.cu): held to their fp32 twins by relative L2
# <= 1e-5 and elementwise as above (K5's gradients to 1e-5 of their largest
# magnitude); K8's quantize pre-pass bit for bit; each replays in a CUDA
# graph and runs as the first CUDA work of a new thread
# ---------------------------------------------------------------------------

def _assert_fp32_grad(got, ref, name):
    assert got.dtype == torch.float32 and got.shape == ref.shape, name
    torch.testing.assert_close(got, ref, atol=1e-5 * float(ref.abs().max()), rtol=1e-4, msg=name)
    rel = float((got - ref).norm() / ref.norm())
    assert rel <= 1e-5, f"{name}: relative L2 error {rel:.3e}"


def _k5_f32_inputs(b, tq, tk, h, seed):
    q, do = (_randn(b, tq, h, 64, seed=seed + i, dtype=torch.float32) for i in (0, 1))
    k, v = (_randn(b, tk, h, 64, seed=seed + i, dtype=torch.float32) for i in (2, 3))
    return q, k, v, do


@pytest.mark.parametrize("b, tq, tk, h, causal", [
    (8, 128, 128, 20, True),     # training self-attention shape
    (8, 128, 1500, 20, False),   # training cross-attention shape
    (2, 130, 130, 3, True),      # causal, ragged T
    (1, 70, 1500, 3, False),     # cross, ragged Tq and Tk
    (2, 65, 300, 2, True),       # causal, Tq < Tk (end-aligned)
    (1, 3, 3, 1, True),          # tiny (one key alone gives dQ = dK = 0 exactly)
])
def test_flash_attention_backward_f32_kernel(b, tq, tk, h, causal):
    q, k, v, do = _k5_f32_inputs(b, tq, tk, h, seed=230)
    o, lse = fa.flash_attention_fwd(q, k, v, causal=causal)
    before = fa.flash_attention_bwd.launches
    got = fa.flash_attention_bwd(q, k, v, o, lse, do, causal=causal)
    torch.cuda.synchronize()
    assert fa.flash_attention_bwd.launches == before + 1
    ref = fa.flash_attention_bwd_reference(q, k, v, o, lse, do, causal=causal)
    for name, g, r in zip(("dq", "dk", "dv"), got, ref):
        _assert_fp32_grad(g, r, name)


@pytest.mark.parametrize("b, tq, tk, h", [
    (2, 1, 1, 3), (2, 63, 63, 3), (2, 65, 65, 3), (2, 127, 127, 3), (8, 128, 128, 20),
    (2, 1, 128, 3), (2, 65, 300, 2), (1, 100, 448, 4), (1, 448, 448, 2)])
def test_flash_attention_backward_f32_causal_form(b, tq, tk, h):
    """K5's fp32 causal form (one launch, a cluster of key tiles a (batch,
    head), 3xTF32 mma.sync): ragged query tiles, end-aligned Tq < Tk, up to
    the decoder's 448 positions (7 key tiles). dQ, dK and dV within
    relative L2 1e-5 of the twin, above a control (the twin without the
    first min(64, Tk / 2) keys reads >= 1e-2 away), and two calls equal bit
    for bit (no atomics). With one key (Tq = Tk = 1) dQ and dK are 0 in
    exact arithmetic (dP = D), and what kernel and twin read is the
    rounding of dP - D, each its own: an output whose twin is below 1e-5
    of the call's largest gradient is held to that bound instead."""
    assert fa.bwd_f32_cluster(tq, tk, True) == -(-tk // 64)
    q, k, v, do = _k5_f32_inputs(b, tq, tk, h, seed=250)
    o, lse = fa.flash_attention_fwd(q, k, v, causal=True)
    before = fa.flash_attention_bwd.launches
    got = fa.flash_attention_bwd(q, k, v, o, lse, do, causal=True)
    again = fa.flash_attention_bwd(q, k, v, o, lse, do, causal=True)
    torch.cuda.synchronize()
    assert fa.flash_attention_bwd.launches == before + 2
    assert all(torch.equal(a, g) for a, g in zip(again, got))
    ref = fa.flash_attention_bwd_reference(q, k, v, o, lse, do, causal=True)
    scale = max(float(r.abs().max()) for r in ref)
    for name, g, r in zip(("dq", "dk", "dv"), got, ref):
        if float(r.abs().max()) <= 1e-5 * scale:
            assert float((g - r).abs().max()) <= 1e-5 * scale, name
        else:
            _assert_fp32_grad(g, r, name)
    if tk >= 2:
        d = min(64, tk // 2)
        cq, ck, cv = fa.flash_attention_bwd_reference(q, k[:, d:], v[:, d:], o, lse, do,
                                                      causal=True)
        pad = torch.zeros_like(k[:, :d])
        full = torch.cat([t.flatten() for t in ref])
        cut = torch.cat([t.flatten() for t in (cq, torch.cat([pad, ck], 1),
                                               torch.cat([pad, cv], 1))])
        control = float((cut - full).norm() / full.norm())
        assert control >= 1e-2, f"control relative L2 {control:.3e}"


@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_backward_f32_reads_fused_projections_in_place(causal):
    """fp32 q, k and v as column blocks of a fused qkv (causal) or of a q
    and a fused kv (cross) projection, at their strides: equal to K5 on
    copies (no atomics: bit for bit) and to the twin."""
    b, h = 2, 4
    f32 = torch.float32
    if causal:
        tq = tk = 130
        q, k, v = (x.reshape(b, tq, h, 64)
                   for x in _randn(b, tq, 3 * h * 64, seed=240, dtype=f32).chunk(3, -1))
    else:
        tq, tk = 128, 1500
        q = _randn(b, tq, h, 64, seed=241, dtype=f32)
        k, v = (x.reshape(b, tk, h, 64)
                for x in _randn(b, tk, 2 * h * 64, seed=242, dtype=f32).chunk(2, -1))
    do = _randn(b, tq, h, 64, seed=243, dtype=f32)
    o, lse = fa.flash_attention_fwd(q, k, v, causal=causal)
    got = fa.flash_attention_bwd(q, k, v, o, lse, do, causal=causal)
    copies = fa.flash_attention_bwd(q.contiguous(), k.contiguous(), v.contiguous(), o, lse, do,
                                    causal=causal)
    torch.cuda.synchronize()
    assert all(torch.equal(g, c) for g, c in zip(got, copies))
    ref = fa.flash_attention_bwd_reference(q, k, v, o, lse, do, causal=causal)
    for name, g, r in zip(("dq", "dk", "dv"), got, ref):
        _assert_fp32_grad(g, r, name)


def test_flash_attention_f32_autograd_on_card():
    """FlashAttention in fp32 (K4's and K1's fp32 forms forward, K5's fp32
    form backward) against autograd of the plain twin."""
    for causal, tk in ((True, 96), (False, 300)):
        q = _randn(2, 96, 4, 64, seed=244, dtype=torch.float32).requires_grad_()
        k, v = (_randn(2, tk, 4, 64, seed=s, dtype=torch.float32).requires_grad_()
                for s in (245, 246))
        do = _randn(2, 96, 4, 64, seed=247, dtype=torch.float32)
        if causal:
            fa.flash_attention(q, k, v, causal=True).backward(do)
        else:
            fa.FlashAttention.apply(q, k, v, False).backward(do)
        got = [t.grad for t in (q, k, v)]
        q2, k2, v2 = (t.detach().clone().requires_grad_() for t in (q, k, v))
        fa.flash_attention_reference(q2, k2, v2, causal=causal)[0].backward(do)
        for name, g, t in zip(("dq", "dk", "dv"), got, (q2, k2, v2)):
            _assert_fp32_grad(g, t.grad, name)


@pytest.mark.parametrize("mode", ["qk", "qkpv"])
@pytest.mark.parametrize("b, tq, tk, h", [(2, 1500, 1500, 20), (1, 70, 130, 3), (3, 64, 1, 2),
                                          (2, 128, 1500, 4)])
def test_int8_attention_f32_kernel(mode, b, tq, tk, h):
    """K8's fp32-q form: O and the LSE against the twin on the twin
    quantizers' codes (qkpv: p = expf of the twin's difference, so p8 takes
    the twin's codes), and its pre-pass codes bit for bit."""
    f32 = torch.float32
    q = _randn(b, tq, h, 64, seed=250, dtype=f32)
    k, v = (_randn(b, tk, h, 64, seed=s, dtype=f32) for s in (251, 252))
    pv8 = mode == "qkpv"
    before = fa.flash_attention_int8.launches
    o, lse = fa.flash_attention_int8(q, k, v, mode=mode)
    torch.cuda.synchronize()
    assert fa.flash_attention_int8.launches == before + 1
    k8, ks = fa.quantize_k_rows(k)
    v_in, vs = fa.quantize_v_cols(v) if pv8 else (v, None)
    ro, rlse = fa.flash_attention_int8_reference(q, k8, ks, v_in, vs, pv8)
    _assert_fp32(o, ro)
    torch.testing.assert_close(lse, rlse, atol=1e-5, rtol=1e-6)
    for part, g, w in zip(("k8", "ks", "v8t", "vs"), fa.int8_prepass(q, k, v, mode=mode),
                          fa.int8_prepass_reference(k, v, pv8)):
        assert (g is None) == (w is None), part
        assert w is None or torch.equal(g, w), part


@pytest.mark.parametrize("shape", [(16 * 1500, 1280), (7, 512), (3, 2048), (5, 8)])
@pytest.mark.parametrize("w_dtype", [torch.bfloat16, torch.float32])
def test_layer_norm_f32_kernel(shape, w_dtype):
    """K6 on fp32 rows with bf16 or fp32 weights: the LayerNorm against the
    twin, the fused add's sum equal to x + y bit for bit."""
    f32 = torch.float32
    x = _randn(*shape, seed=253, dtype=f32) * 3 + 1
    y = _randn(*shape, seed=254, dtype=f32)
    w = (1 + 0.1 * _randn(shape[1], seed=255, dtype=f32)).to(w_dtype)
    bias = (0.1 * _randn(shape[1], seed=256, dtype=f32)).to(w_dtype)
    out = ln.layer_norm(x, w, bias)
    _assert_fp32(out, ln.layer_norm_reference(x, w, bias))
    summed, out = ln.add_layer_norm(x, y, w, bias)
    torch.cuda.synchronize()
    assert torch.equal(summed, x + y)
    _assert_fp32(out, ln.add_layer_norm_reference(x, y, w, bias)[1])


@pytest.mark.parametrize("b, t, n_mels, d", [(2, 3000, 128, 1280), (1, 256, 80, 64),
                                             (3, 130, 20, 36)])
def test_conv_stem_f32_kernel(b, t, n_mels, d):
    """K7's fp32 form against the twin (fp32 sums in another order, erff
    against torch.erf), ragged row and column tiles, tiles across batch
    elements."""
    conv1 = torch.nn.Conv1d(n_mels, d, 3, padding=1, device="cuda")
    conv2 = torch.nn.Conv1d(d, d, 3, stride=2, padding=1, device="cuda")
    x = _randn(b, n_mels, t, seed=257, dtype=torch.float32)
    before = cs.conv_stem.launches
    with torch.no_grad():
        got = cs.conv_stem(conv1, conv2, x)
        torch.cuda.synchronize()
        assert cs.conv_stem.launches == before + 1 and got.shape == (b, t // 2, d)
        _assert_fp32(got, cs.conv_stem_reference(conv1.weight, conv1.bias, conv2.weight,
                                                 conv2.bias, x))


def _f32_form_call(form):
    """A call of one new fp32 form at a small shape, and the tensor whose
    in-place change a replay must see."""
    f32 = torch.float32
    if form == "K5":
        q, k, v, do = _k5_f32_inputs(2, 128, 300, 4, seed=260)
        o, lse = fa.flash_attention_fwd(q, k, v)
        return (lambda: torch.cat([g.flatten() for g in
                                   fa.flash_attention_bwd(q, k, v, o, lse, do, causal=False)])), do
    if form in ("K8qk", "K8qkpv"):
        q = _randn(2, 300, 4, 64, seed=261, dtype=f32)
        k, v = (_randn(2, 300, 4, 64, seed=s, dtype=f32) for s in (262, 263))
        return (lambda: fa.flash_attention_int8(q, k, v, mode=form[2:])[0]), q
    if form == "K6":
        x = _randn(300, 1280, seed=264, dtype=f32)
        w = torch.ones(1280, device="cuda")
        return (lambda: ln.add_layer_norm(x, x, w, w)[1]), x
    conv1 = torch.nn.Conv1d(80, 64, 3, padding=1, device="cuda")
    conv2 = torch.nn.Conv1d(64, 64, 3, stride=2, padding=1, device="cuda")
    x = _randn(2, 80, 300, seed=265, dtype=f32)
    return (lambda: cs.conv_stem(conv1, conv2, x)), x


@pytest.mark.parametrize("form", ["K5", "K6", "K7", "K8qk", "K8qkpv"])
def test_new_f32_forms_replay_in_a_cuda_graph(form):
    """Each new fp32 form allocates only its outputs and scratch and
    launches on the current stream: a CUDA graph of it replays to the eager
    result bit for bit, also after its input changes in place."""
    with torch.no_grad():
        call, x = _f32_form_call(form)
        call()
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = call()
        graph.replay()
        want = call()
        torch.cuda.synchronize()
        assert torch.equal(out, want)
        x.copy_(_randn(*x.shape, seed=266, dtype=torch.float32))
        graph.replay()
        want = call()
        torch.cuda.synchronize()
        assert torch.equal(out, want)


@pytest.mark.parametrize("form", ["K5", "K6", "K7", "K8qk", "K8qkpv"])
def test_new_f32_forms_first_call_in_a_new_thread(form):
    """Each new fp32 form as the first CUDA work of a fresh thread (as in
    autograd's backward thread): it launches there and equals the call on
    this thread."""
    with torch.no_grad():
        call, _ = _f32_form_call(form)
        want = call()
        torch.cuda.synchronize()
        got = []
        thread = threading.Thread(target=lambda: got.append(call()))
        thread.start()
        thread.join()
        assert got, f"{form} raised in the new thread"
        torch.cuda.synchronize()
        assert torch.equal(got[0], want)


# ---------------------------------------------------------------------------
# The no-max forms (KWT_FA_NOMAX) of K1 (bf16 and fp32) and K8 (qk and
# qkpv, bf16 and fp32 q), and KWT_FA_EXP2 on the card: each held to its
# no-max twin as its max-based form is held to its twin (bf16 by
# `_assert_near`, fp32 by `_assert_fp32`), also on `no_max_witness`, where
# rows underflow to 0 in the twin and in the kernel alike and the
# max-based twin reads relative L2 >= 0.5 away
# ---------------------------------------------------------------------------

def _no_max_twin(q, k, v, mode):
    return fa.flash_attention_fwd_reference(q, k, v, int8_mode=mode, no_max=True)


def _assert_form(o, lse, ro, rlse):
    if o.dtype == torch.float32:
        _assert_fp32(o, ro)
        torch.testing.assert_close(lse, rlse, atol=1e-5, rtol=1e-6)
    else:
        _assert_near(o, ro, atol=5e-3)
        torch.testing.assert_close(lse, rlse, atol=1e-3, rtol=1e-4)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
@pytest.mark.parametrize("mode", ["", "qk", "qkpv"], ids=["K1", "K8qk", "K8qkpv"])
@pytest.mark.parametrize("b, tq, tk, h", [
    (2, 1500, 1500, 20),  # the encoder
    (8, 128, 1500, 20),   # the training cross-attention
    (1, 70, 130, 3), (3, 64, 1, 2), (1, 200, 4096, 2),
])
def test_no_max_forms(dtype, mode, b, tq, tk, h):
    """Each no-max form launches once through its own C entry (counted in
    its kernel's launches and in nomax_launches) and equals its twin."""
    q = _randn(b, tq, h, 64, seed=300, dtype=dtype)
    k, v = (_randn(b, tk, h, 64, seed=s, dtype=dtype) for s in (301, 302))
    counter = fa.flash_attention_int8 if mode else fa.flash_attention_fwd
    before = (counter.launches, counter.nomax_launches)
    o, lse = fa.flash_attention_fwd(q, k, v, int8_mode=mode, no_max=True)
    torch.cuda.synchronize()
    assert (counter.launches, counter.nomax_launches) == (before[0] + 1, before[1] + 1)
    _assert_form(o, lse, *_no_max_twin(q, k, v, mode))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
@pytest.mark.parametrize("mode", ["", "qk", "qkpv"], ids=["K1", "K8qk", "K8qkpv"])
def test_no_max_forms_on_the_underflow_witness(dtype, mode):
    """On `no_max_witness` (odd rows >= 110 past their max, even rows at
    it): the odd rows are exactly 0 in the kernel and the twin, every row
    within the bar of the twin, the LSE within 1e-5 relative (bf16 1e-4),
    and the max-based twin >= 0.5 away from both."""
    q, k, v = (x.to("cuda", dtype) for x in fa.no_max_witness(2, 1500, 4, seed=5))
    slack = fa.no_max_slack(q, k)
    assert float(slack[..., 1::2].min()) >= 110 and float(slack[..., 0::2].max()) <= 60
    o, lse = fa.flash_attention_fwd(q, k, v, int8_mode=mode, no_max=True)
    ro, rlse = _no_max_twin(q, k, v, mode)
    mo = fa.flash_attention_fwd(q, k, v, int8_mode=mode, no_max=False)[0]
    torch.cuda.synchronize()
    assert torch.all(o[:, 1::2] == 0) and torch.all(ro[:, 1::2] == 0)
    if dtype == torch.float32:
        _assert_fp32(o, ro)
    else:
        _assert_near(o, ro, atol=5e-3)
    torch.testing.assert_close(lse, rlse, atol=0, rtol=1e-5 if dtype == torch.float32 else 1e-4)
    for x in (o, ro):
        assert float((mo.float() - x.float()).norm() / x.float().norm()) >= 0.5


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
def test_no_max_prepass_of_k8(dtype):
    """K8's pre-pass with no_max also writes each key's ks ||k8|| and their
    max per (batch, head), bit for bit as the twin (codes squared and summed
    exactly, one correctly rounded sqrt and product), from fused strides."""
    b, t, h = 2, 300, 4
    q, k, v = (x.reshape(b, t, h, 64)
               for x in _randn(b, t, 3 * h * 64, seed=303, dtype=dtype).chunk(3, -1))
    for mode in ("qk", "qkpv"):
        got = fa.int8_prepass(q, k, v, mode=mode, no_max=True)
        torch.cuda.synchronize()
        want = fa.int8_prepass_reference(k, v, mode == "qkpv", no_max=True)
        assert len(got) == len(want) == 6
        for name, g, w in zip(("k8", "ks", "v8t", "vs", "kn", "kmax"), got, want):
            assert (g is None) == (w is None), name
            assert w is None or torch.equal(g, w), (mode, name)


@pytest.mark.parametrize("form", ["K1", "K1fp32", "K8qk", "K8qkpv", "K8qkfp32", "K8qkpvfp32"])
def test_no_max_forms_replay_in_a_cuda_graph(form):
    """Each no-max form allocates only its outputs and scratch and launches
    its pre-pass and kernel on the current stream: a CUDA graph of the call
    at the encoder's shape replays to the eager result, bit for bit, on new
    keys too (the key bound is recomputed)."""
    dtype = torch.float32 if form.endswith("fp32") else torch.bfloat16
    mode = form[2:].replace("fp32", "")
    q, k, v = (_randn(2, 1500, 20, 64, seed=s, dtype=dtype) for s in (304, 305, 306))

    def call():
        return fa.flash_attention_fwd(q, k, v, int8_mode=mode, no_max=True)

    call()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = call()
    for fresh in (False, True):
        if fresh:
            k.copy_(_randn(2, 1500, 20, 64, seed=307, dtype=dtype) * 3)
        graph.replay()
        torch.cuda.synchronize()
        want = call()
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(out, want)), fresh


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
def test_exp2_runs_k1_as_it_is(dtype):
    """KWT_FA_EXP2: the card's K1 already takes its exponentials as ex2
    after one FFMA, the arithmetic of the JAX package's exp2 branch, so
    exp2 launches K1's own entry: the same bits as without it, within the
    bar of the exp2 twin; under no_max the no-max form's."""
    q, k, v = (_randn(2, 1500, 20, 64, seed=s, dtype=dtype) for s in (308, 309, 310))
    for no_max in (False, True):
        base = fa.flash_attention_fwd(q, k, v, no_max=no_max, exp2=False)
        got = fa.flash_attention_fwd(q, k, v, no_max=no_max, exp2=True)
        torch.cuda.synchronize()
        assert torch.equal(got[0], base[0]) and torch.equal(got[1], base[1])
        _assert_form(*got, *fa.flash_attention_reference(q, k, v, no_max=no_max, exp2=True))


def test_switches_leave_k4_and_long_calls():
    """Causal (K4) and longer-than-4096-key calls take the default forms
    under no_max and exp2, as the JAX package's online-softmax kernel."""
    q, k, v = (_randn(8, 128, 20, 64, seed=s) for s in (311, 312, 313))
    before = fa.flash_attention_fwd.nomax_launches
    a = fa.flash_attention_fwd(q, k, v, causal=True, no_max=True, exp2=True)
    b_ = fa.flash_attention_fwd(q, k, v, causal=True)
    ql, kl, vl = (_randn(1, t, 2, 64, seed=314) for t in (64, 4100, 4100))
    c = fa.flash_attention_fwd(ql, kl, vl, no_max=True, exp2=True)
    d = fa.flash_attention_fwd(ql, kl, vl)
    torch.cuda.synchronize()
    assert fa.flash_attention_fwd.nomax_launches == before
    assert all(torch.equal(x, y) for x, y in zip((*a, *c), (*b_, *d)))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
def test_no_max_autograd_cross_on_card(monkeypatch, dtype):
    """Under KWT_FA_NOMAX, FlashAttention's gradients through K1's no-max
    forward (its LSE) and K5 at the training cross-attention shape against
    autograd of the plain path."""
    monkeypatch.setenv("KWT_FA_NOMAX", "1")
    q = _randn(2, 128, 4, 64, seed=315, dtype=dtype).requires_grad_()
    k, v = (_randn(2, 1500, 4, 64, seed=s, dtype=dtype).requires_grad_() for s in (316, 317))
    do = _randn(2, 128, 4, 64, seed=318, dtype=dtype)
    before = fa.flash_attention_fwd.nomax_launches
    fa.flash_attention(q, k, v).backward(do)
    assert fa.flash_attention_fwd.nomax_launches == before + 1
    got = [t.grad for t in (q, k, v)]
    q2, k2, v2 = (t.detach().clone().requires_grad_() for t in (q, k, v))
    fa.flash_attention_reference(q2, k2, v2)[0].backward(do)
    for name, g, t in zip(("dq", "dk", "dv"), got, (q2, k2, v2)):
        if dtype == torch.float32:
            _assert_fp32_grad(g, t.grad, name)
        else:
            _assert_grad_near(g, t.grad, name)
