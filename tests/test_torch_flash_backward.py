"""K4's and K5's plain twins vs the JAX flash attention, fp32 on the CPU.

- K4 twin (causal forward, O and LSE) vs `_flash_fwd(causal=True)` run in
  Pallas interpret mode, T not a multiple of the TPU's 256-row block.
- K5 twin (dQ, dK, dV from the saved LSE) vs `_flash_bwd` in interpret mode
  and vs jax.grad of the XLA attention, causal and cross shapes.
- `FlashAttention`'s gradients vs autograd of the port's plain attention.
Tolerances: forward O atol 2e-5 / rtol 1e-4 and LSE atol 1e-5 (as
tests/test_torch_flash_attention.py); gradients atol 2e-4 / rtol 1e-3, the
JAX package's own bound for its backward kernels (tests/test_flash_attention.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kotoba_whisper_tpu.ops import flash_attention as jfa
from kotoba_whisper_tpu.ops.attention import attention_xla
from kotoba_whisper_tpu_torch.ops import flash_attention as tfa
from kotoba_whisper_tpu_torch.ops.attention import attention

GRAD_TOL = dict(atol=2e-4, rtol=1e-3)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny CPU tensors: one intra-op thread, so torch's thread pool does
    not spin-wait on cores the parallel test workers oversubscribe."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(seed, b, tq, tk, h=2, d=64):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, tq, h, d)).astype(np.float32)
    k = rng.standard_normal((b, tk, h, d)).astype(np.float32)
    v = rng.standard_normal((b, tk, h, d)).astype(np.float32)
    g = rng.standard_normal((b, tq, h, d)).astype(np.float32)
    return q, k, v, g


def _to_bh(x):
    b, t, h, d = x.shape
    return jnp.asarray(x).transpose(0, 2, 1, 3).reshape(b * h, t, d)


def _from_bh(x, b, h):
    bh, t, d = x.shape
    return np.asarray(x).reshape(b, h, t, d).transpose(0, 2, 1, 3)


@pytest.mark.parametrize("t", [130, 256])
def test_causal_forward_matches_jax_kernel(t):
    b, h = 2, 2
    q, k, v, _ = _inputs(t, b, t, t, h)
    bq, bk = jfa._blocks(t, t)
    ref_o, ref_lse = jfa._flash_fwd(_to_bh(q), _to_bh(k), _to_bh(v), causal=True,
                                    block_q=bq, block_k=bk, interpret=True)
    o, lse = tfa.flash_attention_fwd(*map(torch.from_numpy, (q, k, v)), causal=True)
    np.testing.assert_allclose(o.numpy(), _from_bh(ref_o, b, h), atol=2e-5, rtol=1e-4)
    np.testing.assert_allclose(lse.numpy().reshape(b * h, t), np.asarray(ref_lse)[..., 0],
                               atol=1e-5)


@pytest.mark.parametrize("tq, tk, causal", [(130, 130, True), (130, 300, False)])
def test_backward_twin_matches_jax_kernels(tq, tk, causal):
    """Same (q, k, v, O, LSE, dO) into the twin and into the JAX package's
    Pallas backward kernels."""
    b, h = 2, 2
    q, k, v, g = _inputs(tq * 7 + tk, b, tq, tk, h)
    o, lse = tfa.flash_attention_fwd(*map(torch.from_numpy, (q, k, v)), causal=causal)
    got = tfa.flash_attention_bwd(*map(torch.from_numpy, (q, k, v)), o, lse,
                                  torch.from_numpy(g), causal=causal)
    bq, bk = jfa._blocks(tq, tk)
    ref = jfa._flash_bwd(
        _to_bh(q), _to_bh(k), _to_bh(v), _to_bh(o.numpy()),
        jnp.asarray(lse.numpy()).reshape(b * h, tq, 1), _to_bh(g),
        causal=causal, block_q=bq, block_k=bk, interpret=True,
    )
    for name, a, r in zip(("dq", "dk", "dv"), got, ref):
        np.testing.assert_allclose(a.numpy(), _from_bh(r, b, h), **GRAD_TOL, err_msg=name)


@pytest.mark.parametrize("tq, tk, causal", [(130, 130, True), (130, 300, False)])
def test_backward_twin_matches_jax_autodiff(tq, tk, causal):
    b, h = 2, 2
    q, k, v, g = _inputs(tq + 3 * tk, b, tq, tk, h)

    def f(q, k, v):
        return jnp.vdot(attention_xla(q, k, v, causal=causal), jnp.asarray(g))

    ref = jax.grad(f, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    qt, kt, vt = map(torch.from_numpy, (q, k, v))
    o, lse = tfa.flash_attention_fwd(qt, kt, vt, causal=causal)
    got = tfa.flash_attention_bwd(qt, kt, vt, o, lse, torch.from_numpy(g), causal=causal)
    for name, a, r in zip(("dq", "dk", "dv"), got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(r), **GRAD_TOL, err_msg=name)


@pytest.mark.parametrize("tq, tk, causal", [(70, 70, True), (40, 150, False)])
def test_flash_attention_function_gradients(tq, tk, causal):
    """FlashAttention (forward and backward twins on the CPU) vs autograd of
    the port's plain attention."""
    q, k, v, g = map(torch.from_numpy, _inputs(tq + tk, 2, tq, tk, 3))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    tfa.flash_attention(*leaves, causal=causal).backward(g)
    plain = [t.clone().requires_grad_() for t in (q, k, v)]
    attention(*plain, causal=causal).backward(g)
    for name, a, r in zip(("dq", "dk", "dv"), leaves, plain):
        torch.testing.assert_close(a.grad, r.grad, **GRAD_TOL, msg=name)


def test_causal_requires_equal_lengths():
    q, k, v, _ = map(torch.from_numpy, _inputs(0, 1, 5, 9))
    with pytest.raises(ValueError, match="Tq == Tk"):
        tfa.flash_attention(q, k, v, causal=True)


def test_backward_wrapper_takes_plain_twin_on_cpu():
    q, k, v, g = map(torch.from_numpy, _inputs(1, 1, 20, 20))
    o, lse = tfa.flash_attention_fwd(q, k, v, causal=True)
    before = (tfa.flash_attention_fwd.causal_launches, tfa.flash_attention_bwd.launches)
    got = tfa.flash_attention_bwd(q, k, v, o, lse, g, causal=True)
    ref = tfa.flash_attention_bwd_reference(q, k, v, o, lse, g, causal=True)
    for a, r in zip(got, ref):
        torch.testing.assert_close(a, r)
    assert (tfa.flash_attention_fwd.causal_launches, tfa.flash_attention_bwd.launches) == before
