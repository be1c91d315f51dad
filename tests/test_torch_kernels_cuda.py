"""The port's CUDA kernels (K1-K3) vs their plain twins, on the card.

Marked `cuda`: skipped where no card is present. Run on a machine with an
H100:  python -m pytest tests/test_torch_kernels_cuda.py -q
Shapes cover the ragged edges (T not a multiple of the tiles, short and
per-row valid lengths, batch tails). bf16 kernels are held to their twins
elementwise (atol set from the card's readings, rtol 1e-2 for bf16 rounding
of large values) and by relative L2 <= 1e-2, about 10x bf16 rounding, which a
dropped or mis-weighted key tile exceeds; the fp32 mel kernel to 1e-4.
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
