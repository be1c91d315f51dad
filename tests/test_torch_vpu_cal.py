"""K9's plain twin (the port's tools/vpu_cal.py on CPU tensors) vs the JAX
tool's calibration kernel `_kernel` in Pallas interpret mode, at (8, 128)
x 4 iterations, both ops. The twin takes torch's exp where the kernel on
the card takes exp2f on log2(e)-scaled scores; here both sides are fp32
exp, so they agree within 1e-6 relative (sums in another order)."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from kotoba_whisper_tpu_torch.tools import vpu_cal as tcal
from tools import vpu_cal as jcal


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny CPU tensors: one intra-op thread, so torch's thread pool does
    not spin-wait on cores the parallel test workers oversubscribe."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("op", ["softmax", "exp"])
def test_calibration_twin_matches_pallas(op):
    x = np.random.default_rng(0).standard_normal((8, 128)).astype(np.float32)
    ref = pl.pallas_call(
        functools.partial(jcal._kernel, iters=4, op=op),
        out_shape=jax.ShapeDtypeStruct((8, 1), jnp.float32),
        interpret=True,
    )(jnp.asarray(x))
    got = tcal.vpu_cal(torch.from_numpy(x), 4, op)
    assert got.shape == (8, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6, atol=0)


def test_projection_counts_large_v3_encoder_scores():
    """The JAX tool's projected volume: 32 layers x B*20 heads x 1500^2."""
    assert tcal.encoder_score_elements(32) == 32 * 32 * 20 * 1500 * 1500
    assert tcal.encoder_score_elements(16) * 2 == tcal.encoder_score_elements(32)


def test_measurement_needs_the_card():
    with pytest.raises(RuntimeError, match="needs device cuda"):
        tcal.measure(rows=8, cols=128, iters=2, trials=1, device="cpu")
