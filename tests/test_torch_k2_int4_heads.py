"""K2's int4 head kernel, on the CPU (csrc/decode_attention.cu `head_kernel`).

Packed int4 K/V take their own kernel: one CTA per (share of the cache
rows, group of heads, batch row) of `head_plan`'s grid, the shares of a
(row, group) one thread-block cluster that combines them. Held here:
- `head_walk`, the kernel's arithmetic in its order (the share's exact
  max, p = 2^(s - m), the weights p * v_scale, the cluster's combine), on
  packed int4 with per-head bf16 scales against the JAX package's
  `decode_attention_reference`, at 20 heads (D=1280) and 10 (D=640), a
  scalar valid length and per-row ones on and beside every share
  boundary, a row with one valid slot, bf16 and fp32 q;
- `head_plan`: the heads of a CTA divide H, the shares cover each row's
  valid span once and form a portable cluster (at most 8), the grid holds
  at most HEAD_CTAS_PER_SM CTAs an SM where the span allows, and a CTA's
  shared memory (`head_smem_bytes`) fits the 227 KB a block may use, three
  CTAs an SM at the cross call.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kotoba_whisper_tpu.models import whisper as jw
from kotoba_whisper_tpu.ops import decode_attention as jda
from kotoba_whisper_tpu_torch.models import whisper as tw
from kotoba_whisper_tpu_torch.ops import decode_attention as tda

T = 1500  # the cross call's rows (the encoder's positions)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny CPU tensors: one intra-op thread, so torch's thread pool does
    not spin-wait on cores the parallel test workers oversubscribe."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _kv(seed, b, h):
    """q, and K/V quantized to int4 per head by JAX: the port's packed
    storage with its bf16 scales, and JAX's int4 codes and scales."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, h, 64)).astype(np.float32)
    out = [q]
    for _ in range(2):
        x = rng.standard_normal((b, T, h * 64)).astype(np.float32)
        codes, s = jw.quantize_kv_heads(jnp.asarray(x), h, jnp.int4)
        codes = np.asarray(codes).astype(np.int8)
        out.append((tw.pack_int4(torch.from_numpy(codes)),
                    torch.from_numpy(np.asarray(s, np.float32)).bfloat16(),
                    jnp.asarray(codes, jnp.int4), jnp.asarray(s, jnp.bfloat16)))
    return out


def _boundary_lengths(b, h):
    """Per-row valid lengths on and beside the shares' boundaries of the
    plan a (b, T) cache takes, and one valid slot."""
    plan = tda.head_plan(b, T, h)
    edges = [plan.rows * x + d for x in range(1, plan.shares) for d in (-1, 0, 1)]
    lengths = [T, 1, *edges]
    return np.array([lengths[i % len(lengths)] for i in range(b)], np.int32)


@pytest.mark.parametrize("q_dtype", [torch.bfloat16, torch.float32], ids=["bf16-q", "fp32-q"])
@pytest.mark.parametrize("valid", ["scalar", "rows"])
@pytest.mark.parametrize("h", [20, 10], ids=["D1280", "D640"])
def test_walk_matches_jax(h, valid, q_dtype):
    b = 6 if valid == "scalar" else 16
    q, (k, ks, jk, jks), (v, vs, jv, jvs) = _kv(h + b, b, h)
    q = torch.from_numpy(q).to(q_dtype)
    lengths = 1200 if valid == "scalar" else _boundary_lengths(b, h)
    ref = jda.decode_attention_reference(
        jnp.asarray(q.float().numpy()), jk, jv, jnp.asarray(lengths), n_heads=h, k_scale=jks,
        v_scale=jvs)
    got = tda.head_walk(q, k, v, lengths if valid == "scalar" else torch.from_numpy(lengths),
                        n_heads=h, k_scale=ks, v_scale=vs, out_dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5, rtol=1e-4)
    if q_dtype == torch.bfloat16:  # the wrapper's CPU twin, in q's dtype, within a bf16 ulp
        twin = tda.decode_attention(q, k, v, lengths if valid == "scalar"
                                    else torch.from_numpy(lengths), n_heads=h, k_scale=ks,
                                    v_scale=vs)
        torch.testing.assert_close(got.to(q_dtype), twin, atol=2e-3, rtol=0)


def test_boundary_lengths_fall_on_every_share_edge():
    """The per-row case above (16 rows) puts a row's last valid slot at,
    before and after each share boundary of its plan, and one row at one
    slot."""
    for h in (20, 10):
        plan = tda.head_plan(16, T, h)
        lengths = set(_boundary_lengths(16, h).tolist())
        assert {1, T} <= lengths and plan.shares > 1
        for x in range(1, plan.shares):
            assert {plan.rows * x - 1, plan.rows * x, plan.rows * x + 1} <= lengths


@pytest.mark.parametrize("b, t, h", [(16, 1500, 20), (16, 1500, 10), (4, 1500, 20),
                                     (1, 1500, 20), (6, 1500, 20), (2, 1500, 10),
                                     (4, 51, 20), (3, 1, 3), (16, 3000, 20), (64, 1500, 20)])
def test_int4_plan_grid(b, t, h):
    plan = tda.head_plan(b, t, h)
    n_ctas = plan.shares * (h // plan.heads) * b
    assert h % plan.heads == 0 and plan.heads in tda.HEAD_HEADS
    assert plan.grid == (plan.shares, h // plan.heads, b)
    assert 1 <= plan.shares <= tda.MAX_CLUSTER  # a portable cluster
    assert plan.shares * plan.rows >= t > (plan.shares - 1) * plan.rows  # no empty share
    assert plan.rows >= min(t, tda.MIN_CTA_ROWS)
    assert n_ctas <= tda.HEAD_CTAS_PER_SM * tda.N_SMS or plan.shares == 1
    assert plan.smem == tda.head_smem_bytes(plan.rows, plan.heads) <= tda.SMEM_LIMIT


def test_int4_plan_at_the_cross_call():
    """B=16 rows over T=1500 at 20 heads: 4 heads a CTA (128-byte boxes), 4
    shares of 375 rows, 320 CTAs, three an SM fitting its shared memory;
    a TP=2 rank's 10 heads: 2 heads a CTA, the same grid; one row (serving)
    spreads over its heads one a CTA."""
    p = tda.head_plan(16, T, 20)
    assert (p.heads, p.shares, p.rows, p.grid) == (4, 4, 375, (4, 5, 16))
    assert p.smem == 49184 and 3 * (p.smem + 1024) <= tda.SM_SMEM
    assert tda.head_plan(16, T, 10)[:4] == (2, 4, 375, (4, 5, 16))
    assert tda.head_plan(1, T, 20)[:4] == (1, 8, 188, (8, 20, 1))


@pytest.mark.parametrize("span", [1, 63, 64, 65, 188, 375, 376, 1499, 1500])
def test_int4_shares_cover_each_valid_row_once(span):
    """Share x reads rows [x * rows, min((x + 1) * rows, valid)): over the
    shares every valid row once, nothing past valid."""
    for valid in sorted({1, span // 2 + 1, span}):
        plan = tda.head_plan(16, span, 20)
        seen = np.zeros(span, int)
        for x in range(plan.shares):
            seen[x * plan.rows:max(min((x + 1) * plan.rows, valid), x * plan.rows)] += 1
        assert (seen[:valid] == 1).all() and (seen[valid:] == 0).all()


def test_int4_smem_counts_its_parts():
    """The ring (32 KB), raw scores a (row, head), heads // 2 + 1 scale
    words a row and tensor, the per-head max and sum, the cluster's
    slices, maxima and sums, two barriers a stage and the scales'."""
    for rows, heads in ((375, 4), (188, 2), (1, 1)):
        words, stages = heads // 2 + 1, tda.HEAD_INT4_RING // (tda.HEAD_BOX * heads * 32)
        parts = (tda.HEAD_INT4_RING + 4 * rows * heads + 8 * words * rows + 8 * heads
                 + 4 * (heads * 64 + tda.MAX_CLUSTER) + 8 * tda.MAX_CLUSTER * heads)
        assert tda.head_smem_bytes(rows, heads) == ((parts + 7) & ~7) + 8 * (2 * stages + 1)
