"""K8's plain twin (the port's int8 attention core on CPU tensors) vs the
JAX package's `_fwd_kernel_single_int8` in interpret mode, reached as the
JAX package reaches it: `flash_attention` under KWT_FA_INT8.

fp32 at (2, 300, 4, 64): O and LSE within 1e-4 (the integer products are
exact on both sides; exp and the sums differ in the last bits). Against
float attention each row keeps cosine > 0.999, the JAX package's own bar
(tests/test_flash_attention.py). The mode applies only to non-causal
attention over at most 4096 keys, and the backward pass stays K5's on the
int8 forward's O and LSE, as the JAX custom_vjp.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kotoba_whisper_tpu.ops import flash_attention as jfa
from kotoba_whisper_tpu_torch.ops import flash_attention as tfa

SHAPE = (2, 300, 4, 64)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny CPU tensors: one intra-op thread, so torch's thread pool does
    not spin-wait on cores the parallel test workers oversubscribe."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _qkv(seed, shape=SHAPE, tk=None):
    rng = np.random.default_rng(seed)
    b, t, h, d = shape
    tk = tk or t
    return (rng.standard_normal((b, t, h, d)).astype(np.float32),
            rng.standard_normal((b, tk, h, d)).astype(np.float32),
            rng.standard_normal((b, tk, h, d)).astype(np.float32))


def _t(*xs):
    return [torch.from_numpy(x) for x in xs]


@pytest.mark.parametrize("mode", ["qk", "qkpv"])
def test_int8_twin_matches_pallas(monkeypatch, mode):
    q, k, v = _qkv(1234)
    monkeypatch.setenv("KWT_FA_INT8", mode)
    ref_o, ref_lse = jfa._fwd_call(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), False)
    got_o, got_lse = tfa.flash_attention_fwd(*_t(q, k, v))
    np.testing.assert_allclose(got_o.numpy(), np.asarray(ref_o), atol=1e-4, rtol=1e-4)
    # JAX LSE (B*H, Tq, 1) -> (B, H, Tq)
    ref_lse = np.asarray(ref_lse)[..., 0].reshape(q.shape[0], q.shape[2], -1)
    np.testing.assert_allclose(got_lse.numpy(), ref_lse, atol=1e-4, rtol=1e-4)
    # the public path of both packages
    np.testing.assert_allclose(
        tfa.flash_attention(*_t(q, k, v)).detach().numpy(),
        np.asarray(jfa.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))),
        atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("mode", ["qk", "qkpv"])
def test_int8_core_close_to_float_attention(mode):
    """The explicit `int8_mode` argument, against float attention."""
    q, k, v = _t(*_qkv(1234))
    got, _ = tfa.flash_attention_fwd(q, k, v, int8_mode=mode)
    ref, _ = tfa.flash_attention_reference(q, k, v)
    cos = torch.nn.functional.cosine_similarity(got, ref, dim=-1)
    assert float(cos.min()) > 0.999, float(cos.min())
    assert not torch.equal(got, ref)


@pytest.mark.parametrize("causal, tk", [(True, 64), (False, 4100)])
def test_int8_mode_applies_only_to_short_non_causal(monkeypatch, causal, tk):
    q, k, v = _t(*_qkv(7, (1, tk, 1, 64) if causal else (1, 8, 1, 64), tk=tk))
    monkeypatch.setenv("KWT_FA_INT8", "qkpv")
    got, lse = tfa.flash_attention_fwd(q, k, v, causal=causal)
    ref, ref_lse = tfa.flash_attention_reference(q, k, v, causal)
    assert torch.equal(got, ref) and torch.equal(lse, ref_lse)


def test_int8_mode_rejects_unknown_values(monkeypatch):
    q, k, v = _t(*_qkv(3, (1, 8, 1, 64)))
    monkeypatch.setenv("KWT_FA_INT8", "int4")
    with pytest.raises(ValueError, match="int8 attention mode"):
        tfa.flash_attention_fwd(q, k, v)


def test_int8_forward_gradient_matches_jax(monkeypatch):
    """KWT_FA_INT8=qk: gradients through the int8 forward's O and LSE and
    the float backward, port (K5 twin) vs JAX (Pallas backward)."""
    q, k, v = _qkv(11, (1, 130, 2, 64))
    g = np.random.default_rng(12).standard_normal(q.shape).astype(np.float32)
    monkeypatch.setenv("KWT_FA_INT8", "qk")
    ref = jax.grad(lambda q, k, v: jnp.vdot(jfa.flash_attention(q, k, v), g),
                   argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (x.requires_grad_() for x in _t(q, k, v))
    tfa.flash_attention(tq, tk, tv).backward(torch.from_numpy(g))
    for name, got, r in zip("qkv", (tq.grad, tk.grad, tv.grad), ref):
        np.testing.assert_allclose(got.numpy(), np.asarray(r), atol=2e-4, rtol=1e-3,
                                   err_msg=f"d{name}")
