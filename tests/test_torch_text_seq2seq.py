"""The port's M2M100/NLLB model against the JAX package's and HF's, on the CPU.

- The sinusoidal position table equals the JAX package's bit for bit.
- Through `params_from_jax`, the port's encoder states and decoder logits
  match the JAX package's in fp32 within 1e-5, on source rows with and
  without right padding; greedy tokens are equal, padded rows included.
- Through `params_from_hf_state_dict`, the port's logits match
  transformers' M2M100ForConditionalGeneration within 1e-4 and its greedy
  tokens equal generate()'s; `load_hf_checkpoint` reads model.safetensors
  and pytorch_model.bin to the same model.
- The cached greedy path agrees with the full decoder on its own output.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kotoba_whisper_tpu.models import text_seq2seq as jts
from kotoba_whisper_tpu_torch.models import text_seq2seq as ts

TINY = dict(vocab_size=120, d_model=32, encoder_layers=2, decoder_layers=2,
            encoder_attention_heads=4, decoder_attention_heads=4, encoder_ffn_dim=64,
            decoder_ffn_dim=64, max_position_embeddings=64)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny CPU tensors: one intra-op thread, so torch's thread pool does
    not spin-wait on cores the parallel test workers oversubscribe."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_pair():
    """The JAX package's random tiny model (numpy leaves) and the port's
    model built from it."""
    cfg = jts.TextSeq2SeqConfig(**TINY)
    params = jax.tree.map(np.asarray, jts.init_params(jax.random.key(0), cfg))
    # non-trivial biases and LayerNorms, so a transposed or misplaced one shows
    rng = np.random.default_rng(5)
    params = jax.tree.map(
        lambda a: a + rng.standard_normal(a.shape).astype(np.float32) * 0.05
        if a.ndim <= 2 and a is not params["pos_table"] and a.shape[0] != cfg.vocab_size
        else a, params)
    return params, cfg, ts.params_from_jax(params, ts.TextSeq2SeqConfig(**TINY))


def _source(rng, b, s, cfg, pad_from=()):
    src = rng.integers(4, 100, size=(b, s)).astype(np.int64)
    for row, start in pad_from:
        src[row, start:] = cfg.pad_token_id
    return src


def test_sinusoidal_table_matches_jax():
    for n, d, pad in ((64, 32, 1), (1024, 1024, 1), (10, 7, None)):
        np.testing.assert_array_equal(ts.sinusoidal_table(n, d, pad),
                                      jts.sinusoidal_table(n, d, pad))


@pytest.mark.parametrize("padded", [False, True], ids=["full", "padded"])
def test_encoder_and_logits_match_jax(jax_pair, padded):
    params, cfg, model = jax_pair
    rng = np.random.default_rng(0)
    src = _source(rng, 3, 11, cfg, ((0, 8), (2, 5)) if padded else ())
    dec = rng.integers(4, 100, size=(3, 7)).astype(np.int64)
    dec[:, 0] = cfg.decoder_start_token_id

    enc_j = jts.encode(params, cfg, jnp.asarray(src))
    logits_j = np.asarray(jts.decode(params, cfg, jnp.asarray(dec), enc_j, jnp.asarray(src)))
    enc = ts.encode(model, src, device="cpu")
    logits = ts.decode(model, dec, enc, src, device="cpu").numpy()
    valid = src != cfg.pad_token_id
    np.testing.assert_allclose(enc.numpy()[valid], np.asarray(enc_j)[valid], atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(logits, logits_j, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("padded", [False, True], ids=["full", "padded"])
def test_greedy_tokens_match_jax(jax_pair, padded):
    params, cfg, model = jax_pair
    rng = np.random.default_rng(1)
    src = _source(rng, 3, 9, cfg, ((1, 6), (2, 3)) if padded else ())
    want = np.asarray(jts.generate_greedy_text(params, cfg, jnp.asarray(src), forced_bos=5,
                                               max_length=14))
    got = ts.generate_greedy_text(model, src, forced_bos=5, max_length=14, device="cpu")
    assert got.dtype == torch.int32 and got.shape == (3, 14)
    np.testing.assert_array_equal(got.numpy(), want)


def test_greedy_stops_at_eos_like_jax(jax_pair):
    """Rows that emit eos write pad after it and the loop ends when every
    row has: the model's eos is remapped to the token greedy picks first."""
    params, cfg, model = jax_pair
    rng = np.random.default_rng(2)
    src = _source(rng, 2, 6, cfg)
    first = ts.generate_greedy_text(model, src, forced_bos=5, max_length=8, device="cpu")
    eos = int(first[0, 2])
    cfg_e = jts.TextSeq2SeqConfig(**TINY, eos_token_id=eos)
    model.cfg = ts.TextSeq2SeqConfig(**TINY, eos_token_id=eos)
    try:
        want = np.asarray(jts.generate_greedy_text(params, cfg_e, jnp.asarray(src),
                                                   forced_bos=5, max_length=12))
        got = ts.generate_greedy_text(model, src, forced_bos=5, max_length=12, device="cpu")
    finally:
        model.cfg = ts.TextSeq2SeqConfig(**TINY)
    np.testing.assert_array_equal(got.numpy(), want)
    assert got[0, 2] == eos and (got[0, 3:] == cfg.pad_token_id).all()


@pytest.fixture(scope="module")
def hf_pair():
    transformers = pytest.importorskip("transformers")
    hf_cfg = transformers.M2M100Config(
        **TINY, pad_token_id=1, eos_token_id=2, bos_token_id=0, decoder_start_token_id=2,
        scale_embedding=True, dropout=0.0, attention_dropout=0.0, activation_dropout=0.0,
        activation_function="relu")
    torch.manual_seed(0)
    hf = transformers.M2M100ForConditionalGeneration(hf_cfg).eval()
    cfg = ts.config_from_hf_dict(hf_cfg.to_dict())
    return hf, cfg, ts.params_from_hf_state_dict(hf.state_dict(), cfg)


def test_logits_and_greedy_match_transformers(hf_pair):
    hf, cfg, model = hf_pair
    rng = np.random.default_rng(0)
    src = _source(rng, 3, 11, cfg, ((0, 8), (2, 5)))
    dec = rng.integers(4, 100, size=(3, 7)).astype(np.int64)
    dec[:, 0] = cfg.decoder_start_token_id
    mask = torch.tensor((src != cfg.pad_token_id).astype(np.int64))
    with torch.no_grad():
        want = hf(input_ids=torch.tensor(src), attention_mask=mask,
                  decoder_input_ids=torch.tensor(dec)).logits.numpy()
        want_tokens = hf.generate(input_ids=torch.tensor(src), attention_mask=mask,
                                  forced_bos_token_id=5, num_beams=1, do_sample=False,
                                  max_length=14).numpy()
    enc = ts.encode(model, src, device="cpu")
    got = ts.decode(model, dec, enc, src, device="cpu").numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)
    tokens = ts.generate_greedy_text(model, src, forced_bos=5, max_length=14,
                                     device="cpu").numpy()
    # HF trims to the longest finished row; the port's width is fixed
    np.testing.assert_array_equal(tokens[:, : want_tokens.shape[1]], want_tokens)
    assert np.all(tokens[:, want_tokens.shape[1]:] == cfg.pad_token_id)


@pytest.mark.parametrize("layout", ["safetensors", "bin"])
def test_load_hf_checkpoint(hf_pair, tmp_path, layout):
    hf, cfg, model = hf_pair
    hf.save_pretrained(str(tmp_path), safe_serialization=layout == "safetensors")
    assert (tmp_path / ("model.safetensors" if layout == "safetensors"
                        else "pytorch_model.bin")).exists()
    loaded, cfg2 = ts.load_hf_checkpoint(str(tmp_path))
    assert cfg2 == cfg
    want = model.state_dict()
    for k, v in loaded.state_dict().items():
        torch.testing.assert_close(v, want[k], rtol=0, atol=0)


def test_incremental_decode_matches_full(jax_pair):
    """The cached greedy path gives the argmax the full decoder gives on
    its own output prefix."""
    _, cfg, model = jax_pair
    src = _source(np.random.default_rng(3), 2, 6, cfg)
    out = ts.generate_greedy_text(model, src, forced_bos=5, max_length=10, device="cpu")
    enc = ts.encode(model, src, device="cpu")
    nxt = ts.decode(model, out[:, :-1], enc, src, device="cpu").argmax(-1)
    for b in range(out.shape[0]):
        for i in range(1, out.shape[1] - 1):
            if out[b, i + 1] == cfg.pad_token_id:
                break
            assert nxt[b, i] == out[b, i + 1], (b, i)


def test_entry_points_raise_without_a_card(jax_pair, monkeypatch):
    _, _, model = jax_pair
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ts.generate_greedy_text(model, np.ones((1, 4), np.int64), forced_bos=5)
