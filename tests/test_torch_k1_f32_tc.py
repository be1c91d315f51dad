"""K1's fp32 form on the tensor cores, on the CPU (csrc/flash_attention_f32.cu).

The non-causal kernel runs each product in 3xTF32: every fp32 operand is
its TF32 high part (rounded to nearest) and its residual, which the tensor
core reads truncated to TF32, and a b = a_hi b_hi + a_hi b_lo + a_lo b_hi.
A walk of its arithmetic in its order (64-key tiles; S as Q_hi K_hi^T +
Q_lo K_hi^T, then + Q_hi K_lo^T; the online softmax in log2 units; each
tile's P V from a fresh sum, P_lo V_hi + P_hi V_lo + P_hi V_hi, added to O
after its rescale; the no-max form's fixed shift and max(l, 1e-30)) is
held to the JAX package's `_flash_fwd` in Pallas interpret mode in fp32:
O within relative L2 1e-6 and the LSE within 1e-5, non-causal, Tq != Tk,
Tq not a multiple of the 128-row work item, and the no-max form on
`no_max_witness` (its underflowing rows exactly 0 in both). TF32 products
alone, the control, read more than 1e-5 away.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kotoba_whisper_tpu.ops import flash_attention as jfa
from kotoba_whisper_tpu_torch.ops import flash_attention as fa
from tests.test_torch_flash_bwd_plan import _tf32

LOG2E = 1.4426950408889634
LN2 = 0.6931471805599453


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny CPU tensors: one intra-op thread, so torch's thread pool does
    not spin-wait on cores the parallel test workers oversubscribe."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _split(x):
    hi = _tf32(x)
    return hi, _tf32(x - hi, False)


def k1_f32_tc_walk(q, k, v, *, no_max=False, three=True):
    """K1 fp32's non-causal kernel in its order, (B, T, H, 64) fp32 ->
    (O (B, Tq, H, 64), LSE (B, H, Tq)); three=False takes TF32 high parts
    alone (the control)."""
    qh, kh, vh = (x.transpose(1, 2) for x in (q, k, v))  # (B, H, T, 64)
    b, h, tq, _ = qh.shape
    tk = kh.shape[2]
    scale_log2 = 0.125 * LOG2E
    q_hi, q_lo = _split(qh)
    if no_max:  # the fixed shift: ||q|| max_j ||k_j|| / 8, log2 units
        kmax = kh.norm(dim=-1).amax(-1, keepdim=True)
        m = qh.norm(dim=-1) * (kmax * scale_log2)
    else:
        m = torch.full((b, h, tq), float("-inf"))
    l = torch.zeros(b, h, tq)
    o = torch.zeros(b, h, tq, 64)
    for k0 in range(0, tk, fa.F32_TC_KEYS):
        kt, vt = kh[:, :, k0:k0 + fa.F32_TC_KEYS], vh[:, :, k0:k0 + fa.F32_TC_KEYS]
        k_hi, k_lo = _split(kt)
        v_hi, v_lo = _split(vt)
        s = q_hi @ k_hi.transpose(-1, -2)
        if three:
            s = (s + q_lo @ k_hi.transpose(-1, -2)) + q_hi @ k_lo.transpose(-1, -2)
        corr = torch.ones(b, h, tq)
        if not no_max:
            m_new = torch.maximum(m, s.amax(-1) * scale_log2)
            corr = torch.exp2(m - m_new)
            m = m_new
        p = torch.exp2(s * scale_log2 - m[..., None])
        l = l * corr + p.sum(-1)
        p_hi, p_lo = _split(p)
        tile = p_hi @ v_hi
        if three:
            tile = (p_lo @ v_hi + p_hi @ v_lo) + tile
        o = o * corr[..., None] + tile
    if no_max:
        l = torch.clamp(l, min=1e-30)
    out = torch.where(l[..., None] > 0, o / l[..., None], torch.zeros_like(o))
    return out.transpose(1, 2), (m + torch.log2(l)) * LN2


def _qkv(seed, b, tq, tk, h=2):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, tq, h, 64)).astype(np.float32),
            rng.standard_normal((b, tk, h, 64)).astype(np.float32),
            rng.standard_normal((b, tk, h, 64)).astype(np.float32))


def _to_bh(x):
    b, t, h, d = x.shape
    return jnp.asarray(x).transpose(0, 2, 1, 3).reshape(b * h, t, d)


def _jax_fwd(q, k, v, no_max):
    """JAX's `_flash_fwd` in interpret mode at the blocks its `_fwd_call`
    picks -> (O (B, Tq, H, D), LSE (B, H, Tq)) as numpy fp32."""
    b, tq, h, d = q.shape
    block_q, block_k = jfa._blocks(tq, k.shape[1])
    o, lse = jfa._flash_fwd(*(_to_bh(x) for x in (q, k, v)), causal=False, block_q=block_q,
                            block_k=block_k, interpret=True, no_max=no_max)
    o = np.asarray(o).reshape(b, h, tq, d).transpose(0, 2, 1, 3)
    return o, np.asarray(lse)[..., 0].reshape(b, h, tq)


def _rel(a, ref):
    a, ref = (torch.as_tensor(np.array(x)).double() for x in (a, ref))
    return float((a - ref).norm() / ref.norm())


CASES = {"self": (2, 150, 150), "cross": (1, 37, 200), "long-rows": (1, 300, 70)}


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("no_max", [False, True], ids=["max", "no-max"])
def test_walk_matches_jax(case, no_max):
    """3xTF32 in the kernel's order holds JAX's fp32 kernel to rel-L2 1e-6
    (O) and 1e-5 (LSE), where one TF32 product alone reads > 1e-5 away."""
    b, tq, tk = CASES[case]
    q, k, v = _qkv(tq + 3 * tk + int(no_max), b, tq, tk)
    ref_o, ref_lse = _jax_fwd(q, k, v, no_max)
    o, lse = k1_f32_tc_walk(*map(torch.from_numpy, (q, k, v)), no_max=no_max)
    assert _rel(o, ref_o) <= 1e-6
    np.testing.assert_allclose(lse.numpy(), ref_lse, atol=1e-5, rtol=1e-6)
    one, _ = k1_f32_tc_walk(*map(torch.from_numpy, (q, k, v)), no_max=no_max, three=False)
    assert _rel(one, ref_o) > 1e-5


def test_walk_on_the_underflow_witness_matches_jax():
    """The no-max form on `no_max_witness`: rows whose bound exceeds their
    max by >= 110 read exactly 0 in the walk as in JAX, their LSE the bound
    + ln 1e-30; the other rows within rel-L2 1e-6."""
    q, k, v = (x.numpy() for x in fa.no_max_witness(1, 200, 2, seed=3))
    ref_o, ref_lse = _jax_fwd(q, k, v, True)
    o, lse = k1_f32_tc_walk(*map(torch.from_numpy, (q, k, v)), no_max=True)
    assert np.all(ref_o[:, 1::2] == 0) and torch.all(o[:, 1::2] == 0)
    assert _rel(o[:, 0::2], ref_o[:, 0::2]) <= 1e-6
    np.testing.assert_allclose(lse.numpy(), ref_lse, rtol=1e-6, atol=1e-5)
