"""K6's plain twin (the port's ops/layer_norm.py on CPU tensors) vs the JAX
package's Pallas LayerNorm kernels in interpret mode.

fp32: within 1e-6 (the same fp32 steps, sums in another order). bf16: the
fused add's sum bit-exact (both round x + y to bf16 once), the LayerNorm
within one bf16 ulp of the Pallas output (fp32 statistics that differ in
the last bits can move a rounding).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kotoba_whisper_tpu.ops import layer_norm as jln
from kotoba_whisper_tpu_torch.ops import layer_norm as tln


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny CPU tensors: one intra-op thread, so torch's thread pool does
    not spin-wait on cores the parallel test workers oversubscribe."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _inputs(seed, shape, dtype):
    rng = np.random.default_rng(seed)
    d = shape[-1]
    x = (rng.standard_normal(shape) * 3 + 1).astype(np.float32)
    y = rng.standard_normal(shape).astype(np.float32)
    w = rng.standard_normal(d).astype(np.float32)
    b = rng.standard_normal(d).astype(np.float32)
    jdt, tdt = DTYPES[dtype]
    jx, jy = jnp.asarray(x, jdt), jnp.asarray(y, jdt)
    # the same rounded values on both sides
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(tdt)
    ty = torch.from_numpy(np.array(jy.astype(jnp.float32))).to(tdt)
    return (jx, jy, jnp.asarray(w), jnp.asarray(b)), (tx, ty, torch.from_numpy(w),
                                                      torch.from_numpy(b))


def _f32(a):
    return a.float().numpy() if isinstance(a, torch.Tensor) else np.asarray(a, np.float32)


def _assert_ln_close(got, ref, dtype):
    got, ref = _f32(got), _f32(ref)
    if dtype == "float32":
        np.testing.assert_allclose(got, ref, atol=1e-6, rtol=1e-6)
    else:  # one bf16 ulp of the reference: 2^(exponent - 7)
        ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(ref), 1e-30))) - 7)
        assert np.all(np.abs(got - ref) <= ulp), float(np.max(np.abs(got - ref) / ulp))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(4, 37, 128), (640, 256), (7, 130, 128)])
def test_layer_norm_twin_matches_pallas(dtype, shape):
    (jx, _, jw, jb), (tx, _, tw, tb) = _inputs(0, shape, dtype)
    ref = jln.layer_norm(jx, jw, jb, block_rows=64, interpret=True)
    got = tln.layer_norm(tx, tw, tb)
    assert got.dtype == tx.dtype and got.shape == tx.shape
    _assert_ln_close(got, ref, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(3, 96, 128), (50, 64)])
def test_add_layer_norm_twin_matches_pallas(dtype, shape):
    (jx, jy, jw, jb), (tx, ty, tw, tb) = _inputs(1, shape, dtype)
    ref_sum, ref_ln = jln.add_layer_norm(jx, jy, jw, jb, block_rows=32, interpret=True)
    got_sum, got_ln = tln.add_layer_norm(tx, ty, tw, tb)
    np.testing.assert_array_equal(_f32(got_sum), _f32(ref_sum))
    # the sum equals torch's own x + y in the storage dtype, bit for bit
    assert torch.equal(got_sum, tx + ty)
    _assert_ln_close(got_ln, ref_ln, dtype)


def test_add_layer_norm_is_the_unfused_sequence():
    """Fused add + LayerNorm == layer_norm(x + y) on the rounded sum."""
    _, (tx, ty, tw, tb) = _inputs(2, (5, 40, 96), "bfloat16")
    s, out = tln.add_layer_norm(tx, ty, tw, tb, eps=1e-6)
    assert torch.equal(out, tln.layer_norm(tx + ty, tw, tb, eps=1e-6))
    assert torch.equal(s, tx + ty)
