"""K8's fp32-q form on s8 and 3xTF32 wgmma, on the CPU (csrc/flash_attention_int8.cu
`flash_int8_f32_kernel`).

The walk of the kernel's order (`k8_f32_walk` of
tests/test_torch_flash_int8_plan.py: 128-row work items, 64-key tiles, S
from integer products, qk's P V in 3xTF32 a tile, qkpv's p = exp(s - m)
and integer P8 V8) in each form, held to the plain twin on the twin
quantizers' codes (rel-L2 and max |err| 1e-5) and to the JAX package's
`_fwd_kernel_single_int8` in Pallas interpret mode on fp32 inputs (1e-4):
- the no-max forms of qk and qkpv (the bound in place of the max, one
  pass), with Tq != Tk, a ragged last key tile and Tq not a multiple of
  the 128-row work item;
- the no-max forms on `no_max_witness`: the rows whose bound passes their
  max by more than ~110 read exactly 0 in the walk, the twin and JAX;
- qk's P V with TF32 high parts alone (the control) reads more than 1e-5
  from the twin where 3xTF32 stays within it.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kotoba_whisper_tpu.ops import flash_attention as jfa
from kotoba_whisper_tpu_torch.ops import flash_attention as fa
from tests.test_torch_flash_int8_plan import k8_f32_walk

CASES = {"cross": (1, 37, 200), "self-ragged": (2, 150, 150), "long-rows": (1, 300, 70)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny CPU tensors: one intra-op thread, so torch's thread pool does
    not spin-wait on cores the parallel test workers oversubscribe."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _qkv(seed, b, tq, tk, h=2):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, t, h, 64)).astype(np.float32) for t in (tq, tk, tk)]


def _to_bh(x):
    b, t, h, d = x.shape
    return jnp.asarray(x).transpose(0, 2, 1, 3).reshape(b * h, t, d)


def _twin(q, k, v, pv8, no_max):
    k8, ks = fa.quantize_k_rows(k)
    v_in, vs = fa.quantize_v_cols(v) if pv8 else (v, None)
    return fa.flash_attention_int8_reference(q, k8, ks, v_in, vs, pv8, no_max)


def _jax(q, k, v, mode, no_max):
    """JAX's `_flash_fwd` in interpret mode, int8 mode `mode` -> (O (B, Tq,
    H, 64), LSE (B, H, Tq)) as numpy fp32."""
    b, tq, h, _ = q.shape
    bq, bk = jfa._blocks(tq, k.shape[1])
    o, lse = jfa._flash_fwd(_to_bh(q), _to_bh(k), _to_bh(v), causal=False, block_q=bq,
                            block_k=bk, interpret=True, int8_mode=mode, no_max=no_max)
    return (np.asarray(o).reshape(b, h, tq, 64).transpose(0, 2, 1, 3),
            np.asarray(lse)[..., 0].reshape(b, h, tq))


def _rel(a, ref):
    a, ref = (torch.as_tensor(np.array(x)).double() for x in (a, ref))
    return float((a - ref).norm() / ref.norm())


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("mode", ["qk", "qkpv"])
def test_nomax_walk_matches_twin_and_jax(mode, case):
    b, tq, tk = CASES[case]
    pv8 = mode == "qkpv"
    q, k, v = _qkv(tq * 5 + tk + len(mode), b, tq, tk)
    qt, kt, vt = map(torch.from_numpy, (q, k, v))
    got_o, got_lse = k8_f32_walk(qt, kt, vt, pv8, no_max=True)
    ref_o, ref_lse = _twin(qt, kt, vt, pv8, True)
    assert _rel(got_o, ref_o) <= 1e-5
    torch.testing.assert_close(got_o, ref_o, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(got_lse, ref_lse, atol=1e-5, rtol=1e-5)
    jo, jlse = _jax(q, k, v, mode, True)
    np.testing.assert_allclose(got_o.numpy(), jo, atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(got_lse.numpy(), jlse, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("mode", ["qk", "qkpv"])
def test_nomax_walk_on_the_underflow_witness(mode):
    """On `no_max_witness` the odd rows' bound passes their max by > 110:
    every p underflows and those rows read exactly 0 in the walk, the twin
    and JAX; the even rows (the bound tight) agree within the bars above."""
    pv8 = mode == "qkpv"
    qt, kt, vt = fa.no_max_witness(1, 200, 2, seed=5)
    got_o, got_lse = k8_f32_walk(qt, kt, vt, pv8, no_max=True)
    ref_o, ref_lse = _twin(qt, kt, vt, pv8, True)
    jo, _ = _jax(*(x.numpy() for x in (qt, kt, vt)), mode, True)
    assert torch.all(got_o[:, 1::2] == 0) and torch.all(ref_o[:, 1::2] == 0)
    assert np.all(jo[:, 1::2] == 0)
    assert _rel(got_o[:, 0::2], ref_o[:, 0::2]) <= 1e-5
    torch.testing.assert_close(got_lse, ref_lse, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(got_o[:, 0::2].numpy(), jo[:, 0::2], atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("no_max", [False, True], ids=["max", "no-max"])
@pytest.mark.parametrize("case", list(CASES))
def test_tf32_only_control_misses_the_twin(case, no_max):
    """qk's P V in 3xTF32 holds the twin to rel-L2 1e-5; on TF32 high
    parts alone the same walk reads more than 1e-5 away."""
    b, tq, tk = CASES[case]
    q, k, v = (torch.from_numpy(x) for x in _qkv(tq + 7 * tk, b, tq, tk))
    ref_o, _ = _twin(q, k, v, False, no_max)
    three, _ = k8_f32_walk(q, k, v, False, no_max=no_max)
    one, _ = k8_f32_walk(q, k, v, False, no_max=no_max, three=False)
    assert _rel(three, ref_o) <= 1e-5 < _rel(one, ref_o)
