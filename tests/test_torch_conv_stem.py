"""K7's plain twin (the port's ops/conv_stem.py on CPU tensors) vs the JAX
package's Pallas stem kernel in interpret mode, and the port's
encode(stem_impl="pallas") vs the JAX package's.

Both sides sum fp32 products and add the bias before rounding; the twin
takes torch's exact erf where the Pallas kernel takes a rational erf
(|err| <= 1.5e-7), so fp32 outputs agree within 1e-6 (the
tests/test_conv_stem.py cases) and the whole encoder within 2e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kotoba_whisper_tpu.core.config import PRESETS as JAX_PRESETS
from kotoba_whisper_tpu.models import whisper as jw
from kotoba_whisper_tpu.ops.conv_stem import conv_stem_pallas
from kotoba_whisper_tpu_torch.core.config import PRESETS
from kotoba_whisper_tpu_torch.models import whisper as tw
from kotoba_whisper_tpu_torch.models.convert import params_from_jax
from kotoba_whisper_tpu_torch.ops.conv_stem import conv_stem, conv_stem_reference


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny CPU tensors: one intra-op thread, so torch's thread pool does
    not spin-wait on cores the parallel test workers oversubscribe."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(seed):
    params = jw.init_params(jax.random.key(seed), JAX_PRESETS["test-tiny"])
    model = params_from_jax(jax.tree.map(np.asarray, params), PRESETS["test-tiny"])
    return params, model


@pytest.mark.parametrize("b, t", [(2, 3000), (1, 256)])
def test_stem_twin_matches_pallas(b, t):
    params, model = _pair(0)
    enc = params["encoder"]
    x = (np.random.default_rng(0).standard_normal((b, 80, t)) * 0.3).astype(np.float32)
    ref = np.asarray(conv_stem_pallas(enc["conv1"], enc["conv2"], jnp.asarray(x),
                                      interpret=True))
    tenc = model.model.encoder
    got = conv_stem(tenc.conv1, tenc.conv2, torch.from_numpy(x)).detach().numpy()
    assert got.shape == ref.shape == (b, t // 2, 64)
    np.testing.assert_allclose(got, ref, atol=1e-6, rtol=1e-6)


def test_stem_twin_bf16_rounds_like_the_kernel():
    """bf16: the bias joins the fp32 sum before the rounding; the stock
    stem (models/whisper.py conv1d) rounds first. The twin and the Pallas
    kernel agree to bf16 resolution."""
    params, model = _pair(1)
    enc = jax.tree.map(lambda v: v.astype(jnp.bfloat16), params["encoder"])
    x = (np.random.default_rng(1).standard_normal((1, 80, 600)) * 0.3).astype(np.float32)
    jx = jnp.asarray(x, jnp.bfloat16)
    ref = np.asarray(conv_stem_pallas(enc["conv1"], enc["conv2"], jx, interpret=True),
                     np.float32)
    tenc = model.model.encoder
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(torch.bfloat16)
    got = conv_stem_reference(tenc.conv1.weight, tenc.conv1.bias, tenc.conv2.weight,
                              tenc.conv2.bias, tx)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.detach().float().numpy(), ref, atol=1e-2, rtol=1e-2)


def test_encode_stem_pallas_matches_jax():
    params, model = _pair(2)
    x = (np.random.default_rng(2).standard_normal((2, 80, 3000)) * 0.3).astype(np.float32)
    ref = np.asarray(jw.encode(params, JAX_PRESETS["test-tiny"], jnp.asarray(x),
                               stem_impl="pallas"))
    got = tw.encode(model, torch.from_numpy(x), device="cpu", stem_impl="pallas").numpy()
    np.testing.assert_allclose(got, ref, atol=2e-5, rtol=2e-5)
    # and the opt-in stem stays a drop-in for the default one
    base = tw.encode(model, torch.from_numpy(x), device="cpu").numpy()
    np.testing.assert_allclose(got, base, atol=2e-5, rtol=1e-5)


def test_stem_rejects_odd_lengths():
    _, model = _pair(0)
    enc = model.model.encoder
    with pytest.raises(ValueError, match="T even"):
        conv_stem(enc.conv1, enc.conv2, torch.zeros(1, 80, 255))
