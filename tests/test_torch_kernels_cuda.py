"""The port's CUDA kernels (K1-K9) vs their plain twins, on the card.

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
order; K8 qkpv may round a p8 the other way); K9's fp32 sums to 1e-4
relative. The w8a8 product (torch._int_mm) must be exact at the decode
step's row counts.
"""
import threading

import numpy as np
import pytest
import torch

from kotoba_whisper_tpu_torch.core.config import FeatureConfig
from kotoba_whisper_tpu_torch.models.quantized import dense_int8, int8_matmul, quantize_dense_int8
from kotoba_whisper_tpu_torch.models.whisper import quantize_kv_rows
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
    """K2 at cache lengths around its split plan (one CTA up to 64 rows,
    then clusters of up to 8); per-row valid lengths of 1 and 2 leave whole
    CTAs of a cluster empty, which the combine must skip."""
    b, h = 4, 20
    q, k, v, ks, vs = _decode_inputs(b, t, h, int8, seed=61)
    valid = (torch.tensor([t, 1, min(t, 2), (t + 1) // 2], dtype=torch.int32, device="cuda")
             if per_row else t)
    before = da.decode_attention.launches
    got = da.decode_attention(q, k, v, valid, n_heads=h, k_scale=ks, v_scale=vs)
    torch.cuda.synchronize()
    assert da.decode_attention.launches == before + 1
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


@pytest.mark.parametrize("mode", ["qk", "qkpv"])
@pytest.mark.parametrize("b, t, h", [(2, 300, 4), (2, 1500, 20), (1, 70, 3)])
def test_int8_attention_kernel(mode, b, t, h):
    q, k, v = (_randn(b, t, h, 64, seed=s) for s in (40, 41, 42))
    before = fa.flash_attention_int8.launches
    o, lse = fa.flash_attention_fwd(q, k, v, int8_mode=mode)
    torch.cuda.synchronize()
    assert fa.flash_attention_int8.launches == before + 1
    k8, ks = fa.quantize_k_rows(k)
    v_in, vs = fa.quantize_v_cols(v) if mode == "qkpv" else (v, None)
    ro, rlse = fa.flash_attention_int8_reference(q, k8, ks, v_in, vs, mode == "qkpv")
    _assert_near(o, ro, atol=5e-3)
    torch.testing.assert_close(lse, rlse, atol=1e-3, rtol=1e-4)


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
