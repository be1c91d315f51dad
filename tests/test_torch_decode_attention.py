"""K2's plain twins vs the JAX `decode_attention_reference` (compute-dtype
and int8 K/V with per-row scales; scalar and (B,) valid_len; the ring mask
of `ring_pos`) and `decode_attention_reference_beam`, and vs the JAX
Pallas `decode_attention_flat` in interpret mode. fp32 on the CPU;
atol 2e-5 / rtol 1e-4."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kotoba_whisper_tpu.models import whisper as jw
from kotoba_whisper_tpu.ops import decode_attention as jda
from kotoba_whisper_tpu_torch.ops import decode_attention as tda

TOL = dict(atol=2e-5, rtol=1e-4)
B, T, H, HD = 3, 70, 4, 64


def _inputs(seed, int8):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, HD)).astype(np.float32)
    k = rng.standard_normal((B, T, H * HD)).astype(np.float32)
    v = rng.standard_normal((B, T, H * HD)).astype(np.float32)
    if not int8:
        return q, k, v, None, None
    kq, ks = jw.quantize_kv_rows(jnp.asarray(k))
    vq, vs = jw.quantize_kv_rows(jnp.asarray(v))
    return q, np.array(kq), np.array(vq), np.array(ks), np.array(vs)


@pytest.mark.parametrize("int8", [False, True], ids=["compute", "int8"])
@pytest.mark.parametrize("per_row", [False, True], ids=["scalar", "rows"])
def test_reference_matches_jax(int8, per_row):
    q, k, v, ks, vs = _inputs(int(int8) * 2 + int(per_row), int8)
    valid = np.array([T, 17, 1], np.int32) if per_row else 41
    ref = jda.decode_attention_reference(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(valid),
        n_heads=H,
        k_scale=None if ks is None else jnp.asarray(ks),
        v_scale=None if vs is None else jnp.asarray(vs),
    )
    got = tda.decode_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(valid) if per_row else valid, n_heads=H,
        k_scale=None if ks is None else torch.from_numpy(ks),
        v_scale=None if vs is None else torch.from_numpy(vs),
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("per_row", [False, True], ids=["scalar", "rows"])
def test_reference_matches_pallas_flat_interpret(per_row):
    q, k, v, _, _ = _inputs(9, False)
    valid = np.array([5, T, 33], np.int32) if per_row else np.int32(T)
    ref = jda.decode_attention_flat(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(valid),
        n_heads=H, interpret=True,
    )
    got = tda.decode_attention_reference(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(valid) if per_row else int(valid), n_heads=H,
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def test_wrapper_takes_plain_twin_on_cpu():
    q, k, v, ks, vs = map(
        lambda x: None if x is None else torch.from_numpy(x), _inputs(4, True)
    )
    before = tda.decode_attention.launches
    got = tda.decode_attention(q, k, v, 9, n_heads=H, k_scale=ks, v_scale=vs)
    ref = tda.decode_attention_reference(q, k, v, 9, n_heads=H, k_scale=ks, v_scale=vs)
    torch.testing.assert_close(got, ref)
    assert tda.decode_attention.launches == before


@pytest.mark.parametrize("int8", [False, True], ids=["compute", "int8"])
@pytest.mark.parametrize("ring_pos", [0, 9, T - 1])
def test_ring_reference_matches_jax(int8, ring_pos):
    """The ring mask: row b's keys are its valid[b] most recent slots ending
    at ring_pos (valid = T takes every slot; rows longer than ring_pos + 1
    wrap past slot T - 1)."""
    q, k, v, ks, vs = _inputs(20 + ring_pos + int(int8), int8)
    valid = np.array([T, 17, 1], np.int32)
    ref = jda.decode_attention_reference(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(valid), n_heads=H,
        k_scale=None if ks is None else jnp.asarray(ks),
        v_scale=None if vs is None else jnp.asarray(vs), ring_pos=jnp.int32(ring_pos),
    )
    got = tda.decode_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), torch.from_numpy(valid),
        n_heads=H, k_scale=None if ks is None else torch.from_numpy(ks),
        v_scale=None if vs is None else torch.from_numpy(vs),
        ring_pos=torch.tensor(ring_pos, dtype=torch.int32),
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def test_ring_equals_the_prefix_of_rolled_rows():
    """Attention does not depend on key order: each row's ring equals the
    prefix form on the row rolled so that its keys are slots [0, valid)."""
    q, k, v, _, _ = map(lambda x: None if x is None else torch.from_numpy(x), _inputs(30, False))
    valid, ring_pos = torch.tensor([T, 40, 3], dtype=torch.int32), 5
    got = tda.decode_attention_reference(q, k, v, valid, n_heads=H, ring_pos=ring_pos)
    for b in range(B):
        shift = -(ring_pos + 1 - int(valid[b]))
        kr, vr = (torch.roll(x[b:b + 1], shift, dims=1) for x in (k, v))
        want = tda.decode_attention_reference(q[b:b + 1], kr, vr, int(valid[b]), n_heads=H)
        torch.testing.assert_close(got[b:b + 1], want, **TOL)


@pytest.mark.parametrize("beams", [1, 3, 5])
@pytest.mark.parametrize("int8", [False, True], ids=["compute", "int8"])
def test_beam_reference_matches_jax(beams, int8):
    rng = np.random.default_rng(40 + beams)
    q = rng.standard_normal((B, beams, H, HD)).astype(np.float32)
    _, k, v, ks, vs = _inputs(41 + beams, int8)
    ref = jda.decode_attention_reference_beam(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), n_heads=H,
        k_scale=None if ks is None else jnp.asarray(ks),
        v_scale=None if vs is None else jnp.asarray(vs),
    )
    got = tda.decode_attention_beam(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), n_heads=H,
        k_scale=None if ks is None else torch.from_numpy(ks),
        v_scale=None if vs is None else torch.from_numpy(vs),
    )
    assert got.shape == (B, beams, H, HD)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def test_beam_wrapper_takes_plain_twin_on_cpu():
    rng = np.random.default_rng(50)
    q = torch.from_numpy(rng.standard_normal((B, 2, H, HD)).astype(np.float32))
    _, k, v, ks, vs = map(lambda x: None if x is None else torch.from_numpy(x), _inputs(51, True))
    before = tda.decode_attention_beam.launches
    got = tda.decode_attention_beam(q, k, v, n_heads=H, k_scale=ks, v_scale=vs)
    for j in range(2):  # each beam is the one-query form over the group's row
        want = tda.decode_attention_reference(q[:, j], k, v, T, n_heads=H, k_scale=ks, v_scale=vs)
        torch.testing.assert_close(got[:, j], want, **TOL)
    assert tda.decode_attention_beam.launches == before


def _bf16_values(x):
    """x rounded to bfloat16, kept in float32 (what the kernels read)."""
    return torch.from_numpy(x).to(torch.bfloat16).float().numpy()


@pytest.mark.parametrize("n_sms", [1, 132], ids=["one-share", "key-shares"])
@pytest.mark.parametrize("beams", [1, 5, 17])
@pytest.mark.parametrize("int8", [False, True], ids=["compute", "int8"])
def test_beam_walk_matches_jax(int8, beams, n_sms):
    """The beam kernel's order (`beam_walk`: 16-beam tiles, key shares of a
    cluster, 64-key tiles taken by four warps in turn, the online softmax in
    log2 units, the warps' and shares' states merged) equals the JAX
    reference in fp32 to 1e-5 with P kept in fp32: only the order of fp32
    sums and exp2 of log2-scaled scores in place of exp differ. With P *
    v_scale rounded to bf16 before P V and a bf16 output, as the kernel
    does, it stays within the card test's bounds of the reference (atol
    2e-3 + rtol 1e-2 elementwise, relative L2 <= 1e-2: bf16 rounding)."""
    g, t = 3, 600  # 10 key tiles: 5 shares of two on a full card, one share of ten
    rng = np.random.default_rng(60 + beams + 100 * int8)
    q = _bf16_values(rng.standard_normal((g, beams, H, HD)).astype(np.float32))
    k = rng.standard_normal((g, t, H * HD)).astype(np.float32)
    v = rng.standard_normal((g, t, H * HD)).astype(np.float32)
    ks = vs = None
    if int8:
        k, ks = (np.array(x) for x in jw.quantize_kv_rows(jnp.asarray(k)))
        v, vs = (np.array(x) for x in jw.quantize_kv_rows(jnp.asarray(v)))
    else:
        k, v = _bf16_values(k), _bf16_values(v)
    ref = np.asarray(jda.decode_attention_reference_beam(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), n_heads=H,
        k_scale=None if ks is None else jnp.asarray(ks),
        v_scale=None if vs is None else jnp.asarray(vs),
    ))
    kt = torch.from_numpy(k) if int8 else torch.from_numpy(k).to(torch.bfloat16)
    vt = torch.from_numpy(v) if int8 else torch.from_numpy(v).to(torch.bfloat16)
    args = dict(n_heads=H, k_scale=None if ks is None else torch.from_numpy(ks),
                v_scale=None if vs is None else torch.from_numpy(vs), n_sms=n_sms)
    qt = torch.from_numpy(q).to(torch.bfloat16)
    exact = tda.beam_walk(qt, kt, vt, p_dtype=None, out_dtype=torch.float32, **args)
    np.testing.assert_allclose(exact.numpy(), ref, atol=1e-5, rtol=1e-4)
    got = tda.beam_walk(qt, kt, vt, **args).float().numpy()
    np.testing.assert_allclose(got, ref, atol=2e-3, rtol=1e-2)
    assert np.linalg.norm(got - ref) <= 1e-2 * np.linalg.norm(ref)


@pytest.mark.parametrize("int8", [False, True], ids=["compute", "int8"])
@pytest.mark.parametrize("ring_pos", [0, 9, T - 1])
def test_ring_walk_matches_jax(int8, ring_pos):
    """The ring kernel's order (`ring_walk`: per `ring_plan` CTA, the keys
    at `ring_slot`'s slots, fp32 scores q / 8 times K times k_scale, the
    exact max, exp, p * v_scale, P V / l) equals the JAX ring reference in
    fp32 to 2e-5 (fp32 sums in another order, the division by the sum after
    P V); rows of every slot, one slot, and a wrap past slot T - 1."""
    q, k, v, ks, vs = _inputs(80 + ring_pos + int(int8), int8)
    q = _bf16_values(q)
    valid = np.array([T, 1, 33], np.int32)
    ref = jda.decode_attention_reference(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(valid), n_heads=H,
        k_scale=None if ks is None else jnp.asarray(ks),
        v_scale=None if vs is None else jnp.asarray(vs), ring_pos=jnp.int32(ring_pos),
    )
    got = tda.ring_walk(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), torch.from_numpy(valid),
        ring_pos, n_heads=H, k_scale=None if ks is None else torch.from_numpy(ks),
        v_scale=None if vs is None else torch.from_numpy(vs), out_dtype=torch.float32,
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
