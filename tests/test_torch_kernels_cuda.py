"""The port's CUDA kernels (K1-K5) vs their plain twins, on the card.

Marked `cuda`: skipped where no card is present. Run on a machine with an
H100:  python -m pytest tests/test_torch_kernels_cuda.py -q
Shapes cover the ragged edges (T not a multiple of the tiles, short and
per-row valid lengths, batch tails). bf16 kernels are held to their twins
elementwise (atol set from the card's readings, rtol 1e-2 for bf16 rounding
of large values) and by relative L2 <= 1e-2, about 10x bf16 rounding, which a
dropped or mis-weighted key tile exceeds; the fp32 mel kernel to 1e-4. K5's
gradients, whose scale follows the inputs, are held elementwise to 1e-2 of
their largest magnitude (rtol 1e-2) and by the same relative L2.
"""
import numpy as np
import pytest
import torch

from kotoba_whisper_tpu_torch.core.config import FeatureConfig
from kotoba_whisper_tpu_torch.models.whisper import quantize_kv_rows
from kotoba_whisper_tpu_torch.ops import decode_attention as da
from kotoba_whisper_tpu_torch.ops import flash_attention as fa
from kotoba_whisper_tpu_torch.ops import mel

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


@pytest.mark.parametrize("b, t, h", [(2, 130, 3), (8, 128, 20), (3, 64, 2), (1, 1, 1)])
def test_causal_flash_attention_kernel(b, t, h):
    """K4: causal T not a multiple of the 64-row tile, the training shape,
    one exact tile, and a single row."""
    q, k, v = (_randn(b, t, h, 64, seed=s) for s in (7, 8, 9))
    before = fa.flash_attention_fwd.causal_launches
    o, lse = fa.flash_attention_fwd(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert fa.flash_attention_fwd.causal_launches == before + 1
    ro, rlse = fa.flash_attention_reference(q, k, v, causal=True)
    _assert_near(o, ro, atol=5e-3)
    torch.testing.assert_close(lse, rlse, atol=1e-3, rtol=1e-4)


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


@pytest.mark.parametrize("n_mels", [80, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.int16])
def test_log_mel_kernel(n_mels, dtype):
    cfg = FeatureConfig(n_mels=n_mels)
    rng = np.random.default_rng(n_mels)
    audio = rng.standard_normal((3, cfg.n_samples)) * 0.1
    if dtype == torch.int16:
        audio = np.clip(np.round(audio * 32768), -32768, 32767).astype(np.int16)
    x = torch.from_numpy(np.asarray(audio, dtype=np.float32 if dtype == torch.float32 else np.int16)).cuda()
    got = mel.finish_log_mel(mel.log_mel_frames(x, cfg))
    ref = mel.finish_log_mel(mel.log_mel_frames_reference(x, cfg))
    torch.testing.assert_close(got, ref, atol=1e-4, rtol=0)


def test_log_mel_kernel_short_clip():
    """A clip whose frame count is not a multiple of the block's 32."""
    cfg = FeatureConfig(n_mels=128)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((2, 16000 + 37)).astype(np.float32)).cuda()
    torch.testing.assert_close(
        mel.log_mel_frames(x, cfg), mel.log_mel_frames_reference(x, cfg), atol=1e-4, rtol=0
    )
