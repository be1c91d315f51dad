"""Port model vs JAX model on identical weights (fp32, CPU, tiny config).

The JAX params come from `init_params` with a fixed key; the port gets the
same numbers through models/convert.params_from_jax. Inputs are seeded
numpy. Tolerances: atol/rtol 1e-4 (fp32 sums in different orders).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kotoba_whisper_tpu.core.config import WhisperConfig as JaxConfig
from kotoba_whisper_tpu.models import whisper as jw
from kotoba_whisper_tpu_torch.core.config import WhisperConfig
from kotoba_whisper_tpu_torch.models import whisper as tw
from kotoba_whisper_tpu_torch.models.convert import params_from_jax

TINY = dict(
    vocab_size=1017, num_mel_bins=80, d_model=64, encoder_layers=2,
    encoder_attention_heads=4, decoder_layers=3, decoder_attention_heads=4,
    encoder_ffn_dim=96, decoder_ffn_dim=96, max_source_positions=64,
    max_target_positions=32, pad_token_id=0, bos_token_id=1, eos_token_id=1,
    decoder_start_token_id=2,
)
TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny CPU tensors: one intra-op thread, so torch's thread pool does
    not spin-wait on cores the parallel test workers oversubscribe."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pair():
    jcfg, tcfg = JaxConfig(**TINY), WhisperConfig(**TINY)
    params = jw.init_params(jax.random.key(0), jcfg)
    # non-trivial biases and LayerNorm affine terms, so the bridge's
    # handling of every leaf shows in the outputs
    leaves, treedef = jax.tree.flatten(params)
    rng = np.random.default_rng(1)
    leaves = [np.asarray(x) + rng.standard_normal(x.shape).astype(np.float32) * 0.02
              for x in leaves]
    params = jax.tree.unflatten(treedef, [jnp.asarray(x) for x in leaves])
    model = params_from_jax(jax.tree.map(np.asarray, params), tcfg)
    return jcfg, params, model


def _mel(rng, cfg, b=2):
    return rng.standard_normal((b, cfg.num_mel_bins, 2 * cfg.max_source_positions)).astype(np.float32)


def test_encode_matches_jax(pair):
    jcfg, params, model = pair
    mel = _mel(np.random.default_rng(2), jcfg)
    ref = np.asarray(jw.encode(params, jcfg, jnp.asarray(mel)))
    got = tw.encode(model, torch.from_numpy(mel), device="cpu").numpy()
    assert got.shape == ref.shape == (2, jcfg.max_source_positions, jcfg.d_model)
    np.testing.assert_allclose(got, ref, **TOL)


def test_full_decode_logits_match_jax(pair):
    jcfg, params, model = pair
    rng = np.random.default_rng(3)
    mel = _mel(rng, jcfg)
    ids = rng.integers(0, jcfg.vocab_size, (2, 11)).astype(np.int32)
    enc = jw.encode(params, jcfg, jnp.asarray(mel))
    ref = np.asarray(jw.decode(params, jcfg, jnp.asarray(ids), enc))
    got = tw.decode(
        model, torch.from_numpy(ids).long(), torch.from_numpy(np.array(enc)),
        device="cpu",
    ).numpy()
    np.testing.assert_allclose(got, ref, **TOL)


@pytest.mark.parametrize("kv_dtype", ["compute", "int8"])
def test_incremental_decode_matches_jax_and_full(pair, kv_dtype):
    """Prefill of 3 tokens then single-token steps through the cache: the
    port's step logits equal the JAX cache path's; with compute-dtype KV
    they also equal the port's own full-sequence decode."""
    jcfg, params, model = pair
    rng = np.random.default_rng(4)
    mel = _mel(rng, jcfg)
    ids = rng.integers(0, jcfg.vocab_size, (2, 9)).astype(np.int32)
    enc = jw.encode(params, jcfg, jnp.asarray(mel))
    enc_t = torch.from_numpy(np.array(enc))

    jcache = jw.init_cache(params, jcfg, enc, capacity=16, kv_dtype=kv_dtype)
    tcache = tw.init_cache(model, enc_t, 16, kv_dtype=kv_dtype, device="cpu")
    j_lg, jcache = jw.decode(params, jcfg, jnp.asarray(ids[:, :3]), cache=jcache)
    t_lg, tcache = tw.decode(model, torch.from_numpy(ids[:, :3]).long(), cache=tcache, device="cpu")
    ref_steps, got_steps = [np.asarray(j_lg)], [t_lg.numpy()]
    for i in range(3, ids.shape[1]):
        j_lg, jcache = jw.decode(params, jcfg, jnp.asarray(ids[:, i : i + 1]), cache=jcache)
        t_lg, tcache = tw.decode(
            model, torch.from_numpy(ids[:, i : i + 1]).long(), cache=tcache, device="cpu"
        )
        ref_steps.append(np.asarray(j_lg))
        got_steps.append(t_lg.numpy())
    assert tcache.length == ids.shape[1]
    ref, got = np.concatenate(ref_steps, 1), np.concatenate(got_steps, 1)
    np.testing.assert_allclose(got, ref, **TOL)
    if kv_dtype == "compute":
        full = tw.decode(model, torch.from_numpy(ids).long(), enc_t, device="cpu").numpy()
        np.testing.assert_allclose(got, full, **TOL)


def test_quantize_kv_rows_matches_jax():
    x = np.random.default_rng(5).standard_normal((3, 7, 64)).astype(np.float32)
    jq, js = jw.quantize_kv_rows(jnp.asarray(x))
    tq, ts = tw.quantize_kv_rows(torch.from_numpy(x))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def test_sinusoidal_positions_match_jax():
    np.testing.assert_array_equal(
        tw.sinusoidal_positions(1500, 64), jw.sinusoidal_positions(1500, 64)
    )


def test_init_params_layout():
    """Random init draws the JAX distribution per leaf kind, on the HF
    module tree, from an explicit generator."""
    cfg = WhisperConfig(**TINY)
    m1 = tw.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    m2 = tw.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    sd = m1.state_dict()
    assert "model.encoder.layers.1.self_attn.q_proj.weight" in sd
    assert "model.encoder.layers.0.self_attn.k_proj.bias" not in sd
    torch.testing.assert_close(sd["model.decoder.layers.2.fc1.weight"],
                               m2.state_dict()["model.decoder.layers.2.fc1.weight"])
    assert float(sd["model.decoder.layers.0.final_layer_norm.weight"].min()) == 1.0
    assert float(sd["model.decoder.layers.0.fc1.bias"].abs().max()) == 0.0
    std = float(sd["model.decoder.embed_tokens.weight"].std())
    assert 0.018 < std < 0.022


def test_state_dict_names_match_hf_export(pair):
    """The port's parameter names are exactly the HF export's (minus the
    tied proj_out), so an HF checkpoint loads with load_state_dict."""
    from kotoba_whisper_tpu.models.hf_import import hf_state_dict_from_params

    jcfg, params, model = pair
    hf = hf_state_dict_from_params(params, jcfg)
    assert set(model.state_dict()) == set(hf) - {"proj_out.weight"}
    for k, v in model.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), hf[k], err_msg=k)


def test_cpu_entry_points_need_explicit_device(pair, monkeypatch):
    _, _, model = pair
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tw.encode(model, torch.zeros(1, 80, 128))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tw.init_params(WhisperConfig(**TINY), torch.Generator())


STEP_TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("kv_dtype", ["compute", "int8"])
def test_ring_decode_matches_jax(pair, kv_dtype):
    """Single-token steps at per-row lengths (3 rows at counts 0, 2, 1)
    with a shared ring slot that wraps past the capacity: every row writes
    slot ring, its keys its count + 1 most recent slots. Logits, counts and
    the self cache equal JAX's."""
    jcfg, params, model = pair
    rng = np.random.default_rng(6)
    enc = jw.encode(params, jcfg, jnp.asarray(_mel(rng, jcfg, b=3)))
    ids = rng.integers(0, jcfg.vocab_size, (3, 5)).astype(np.int32)
    lengths = np.array([0, 2, 1], np.int32)
    jcache = jw.init_cache(params, jcfg, enc, capacity=8, kv_dtype=kv_dtype)
    jcache = jcache._replace(length=jnp.asarray(lengths))
    tcache = tw.init_cache(model, torch.from_numpy(np.array(enc)), 8, kv_dtype=kv_dtype,
                           device="cpu")
    tcache.length = torch.from_numpy(lengths)
    for step in range(ids.shape[1]):
        pos = (6 + step) % 8
        j_lg, jcache = jw.decode(params, jcfg, jnp.asarray(ids[:, step:step + 1]), cache=jcache,
                                 ring_pos=jnp.int32(pos))
        t_lg, tcache = tw.decode(
            model, torch.from_numpy(ids[:, step:step + 1]).long(), cache=tcache, device="cpu",
            ring_pos=torch.tensor(pos, dtype=torch.int32))
        np.testing.assert_allclose(t_lg.numpy(), np.asarray(j_lg), **STEP_TOL)
    np.testing.assert_array_equal(tcache.length.numpy(), np.asarray(jcache.length))
    np.testing.assert_allclose(tcache.self_k.float().numpy(),
                               np.asarray(jcache.self_k, np.float32), **STEP_TOL)
    if kv_dtype == "int8":
        np.testing.assert_allclose(tcache.self_v_scale.numpy(),
                                   np.asarray(jcache.self_v_scale), **STEP_TOL)


@pytest.mark.parametrize("kv_dtype", ["compute", "int8"])
@pytest.mark.parametrize("layout", ["ring", "scatter"])
def test_ring_beam_decode_matches_jax(pair, kv_dtype, layout):
    """A beam stream's step: 2 groups of 3 beams at per-group counts 2 and
    0, the cross K/V one row a group (init_cache(beam_size=3)), the self
    rows written at a shared ring slot that wraps past the capacity
    ("ring", K2's ring form beside its beam form in one step) or each at
    its own count ("scatter"). Logits, counts and the self cache equal
    JAX's decode(ring_pos=, beam_size=)."""
    jcfg, params, model = pair
    rng = np.random.default_rng(8)
    enc = jw.encode(params, jcfg, jnp.asarray(_mel(rng, jcfg, b=2)))
    ids = rng.integers(0, jcfg.vocab_size, (6, 4)).astype(np.int32)
    lengths = np.array([2, 2, 2, 0, 0, 0], np.int32)
    jcache = jw.init_cache(params, jcfg, enc, capacity=8, kv_dtype=kv_dtype, beam_size=3)
    jcache = jcache._replace(length=jnp.asarray(lengths))
    tcache = tw.init_cache(model, torch.from_numpy(np.array(enc)), 8, kv_dtype=kv_dtype,
                           beam_size=3, device="cpu")
    tcache.length = torch.from_numpy(lengths)
    for step in range(ids.shape[1]):
        pos = (6 + step) % 8
        j_ring = jnp.int32(pos) if layout == "ring" else None
        t_ring = torch.tensor(pos, dtype=torch.int32) if layout == "ring" else None
        j_lg, jcache = jw.decode(params, jcfg, jnp.asarray(ids[:, step:step + 1]), cache=jcache,
                                 ring_pos=j_ring, beam_size=3)
        t_lg, tcache = tw.decode(
            model, torch.from_numpy(ids[:, step:step + 1]).long(), cache=tcache, device="cpu",
            ring_pos=t_ring, beam_size=3)
        np.testing.assert_allclose(t_lg.numpy(), np.asarray(j_lg), **STEP_TOL)
    np.testing.assert_array_equal(tcache.length.numpy(), np.asarray(jcache.length))
    np.testing.assert_allclose(tcache.self_k.float().numpy(),
                               np.asarray(jcache.self_k, np.float32), **STEP_TOL)
    if kv_dtype == "int8":
        np.testing.assert_allclose(tcache.self_k_scale.numpy(),
                                   np.asarray(jcache.self_k_scale), **STEP_TOL)


@pytest.mark.parametrize("kv_dtype", ["compute", "int8"])
def test_beam_cache_and_decode_match_jax(pair, kv_dtype):
    """init_cache(beam_size=3) stores the cross K/V once per group of 2 and
    the self buffers for 6 hypotheses; a 3-token prefill (beams and
    positions fanned into one cross query axis) and 3 single-token steps
    (the beam form of K2's twin) give JAX's logits."""
    jcfg, params, model = pair
    rng = np.random.default_rng(7)
    enc = jw.encode(params, jcfg, jnp.asarray(_mel(rng, jcfg, b=2)))
    ids = rng.integers(0, jcfg.vocab_size, (6, 6)).astype(np.int32)
    jcache = jw.init_cache(params, jcfg, enc, capacity=8, kv_dtype=kv_dtype, beam_size=3)
    tcache = tw.init_cache(model, torch.from_numpy(np.array(enc)), 8, kv_dtype=kv_dtype,
                           beam_size=3, device="cpu")
    assert tcache.cross_k.shape[1] == 2 and tcache.self_k.shape[1] == 6
    np.testing.assert_allclose(tcache.cross_k.float().numpy(),
                               np.asarray(jcache.cross_k, np.float32), **STEP_TOL)
    for lo, hi in ((0, 3), (3, 4), (4, 5), (5, 6)):
        j_lg, jcache = jw.decode(params, jcfg, jnp.asarray(ids[:, lo:hi]), cache=jcache,
                                 beam_size=3)
        t_lg, tcache = tw.decode(model, torch.from_numpy(ids[:, lo:hi]).long(), cache=tcache,
                                 beam_size=3, device="cpu")
        np.testing.assert_allclose(t_lg.numpy(), np.asarray(j_lg), **STEP_TOL)
    assert tcache.length == 6
