"""K1's plain twin (O, LSE) vs the JAX flash attention (Pallas, interpret
mode on the CPU) and its forward LSE, fp32, T not a multiple of 128.
Tolerances: O atol 2e-5 / rtol 1e-4, LSE atol 1e-5."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kotoba_whisper_tpu.ops import flash_attention as jfa
from kotoba_whisper_tpu_torch.ops import flash_attention as tfa
from kotoba_whisper_tpu_torch.ops.attention import attention


def _qkv(seed, b, tq, tk, h=2, d=64):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, tq, h, d)).astype(np.float32)
    k = rng.standard_normal((b, tk, h, d)).astype(np.float32)
    v = rng.standard_normal((b, tk, h, d)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("tq, tk", [(150, 150), (37, 200)])
def test_output_matches_jax_flash(tq, tk):
    q, k, v = _qkv(tq + tk, 2, tq, tk)
    ref = np.asarray(jfa.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)))
    o, _ = tfa.flash_attention_fwd(*map(torch.from_numpy, (q, k, v)))
    np.testing.assert_allclose(o.numpy(), ref, atol=2e-5, rtol=1e-4)


def test_lse_matches_jax_flash_fwd():
    b, t, h, d = 1, 150, 2, 64
    q, k, v = _qkv(11, b, t, t, h, d)
    to_bh = lambda x: jnp.asarray(x).transpose(0, 2, 1, 3).reshape(b * h, t, d)
    _, ref_lse = jfa._flash_fwd(
        to_bh(q), to_bh(k), to_bh(v), causal=False, block_q=128,
        block_k=256, interpret=True,
    )
    _, lse = tfa.flash_attention_fwd(*map(torch.from_numpy, (q, k, v)))
    np.testing.assert_allclose(
        lse.numpy().reshape(b * h, t), np.asarray(ref_lse)[..., 0], atol=1e-5
    )


def test_twin_matches_plain_attention():
    """The encoder's flash path and the plain attention agree (fp32)."""
    q, k, v = map(torch.from_numpy, _qkv(5, 2, 70, 70, h=3))
    torch.testing.assert_close(
        tfa.flash_attention(q, k, v), attention(q, k, v), atol=2e-5, rtol=1e-4
    )


def test_wrapper_takes_plain_twin_on_cpu():
    q, k, v = map(torch.from_numpy, _qkv(6, 1, 20, 20))
    before = tfa.flash_attention_fwd.launches
    o, lse = tfa.flash_attention_fwd(q, k, v)
    ro, rlse = tfa.flash_attention_reference(q, k, v)
    torch.testing.assert_close(o, ro)
    torch.testing.assert_close(lse, rlse)
    assert tfa.flash_attention_fwd.launches == before
