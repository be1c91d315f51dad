"""Port's continuous-batching greedy decode vs the JAX package's.

The cases of the JAX package's tests/test_streaming_decode.py, on the
test-byte model with identical weights (models/convert.params_from_jax;
scaled x4 as in test_torch_greedy.py, so logits sit far from ties): the
port's generate_greedy_streaming must give the JAX stream's tokens
exactly, with compute and int8 KV caches, with per-utterance stops, a
stream whose length is not a multiple of the refill batch, a window larger
than the stream and a numpy source uploaded in slabs. With compute KV it
must also equal the port's own lockstep generate_greedy up to each row's
stop. fp32 on the CPU. The JAX streams are decoded once per module.
"""
import jax
import numpy as np
import pytest
import torch

from kotoba_whisper_tpu.core.config import PRESETS as JAX_PRESETS
from kotoba_whisper_tpu.core.config import SpecialTokens as JaxSpecialTokens
from kotoba_whisper_tpu.decode import greedy as jg
from kotoba_whisper_tpu.decode import streaming as js
from kotoba_whisper_tpu.models import whisper as jw
from kotoba_whisper_tpu_torch.core.config import PRESETS, SpecialTokens
from kotoba_whisper_tpu_torch.decode import greedy as tg
from kotoba_whisper_tpu_torch.decode import streaming as ts
from kotoba_whisper_tpu_torch.models.convert import params_from_jax

ST = SpecialTokens.layout(n_text=256, n_langs=99)
JST = JaxSpecialTokens.layout(n_text=256, n_langs=99)
MAX_LEN = 24

# name -> (utterances, kv_dtype, (batch, encode_batch, steps_per_round,
# source_windows), per-utterance stops)
CASES = {
    "stops-compute": (10, "compute", (4, 2, 3, 256), True),
    "stops-int8": (10, "int8", (4, 2, 3, 256), True),
    "slabbed-ragged": (9, "compute", (4, 2, 3, 4), False),
    "window-over-stream": (3, "int8", (8, 4, 5, 256), False),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny CPU tensors: one intra-op thread, so torch's thread pool does
    not spin-wait on cores the parallel test workers oversubscribe."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setup():
    jcfg = JAX_PRESETS["test-byte"]
    params = jax.tree.map(lambda x: x * 4.0, jw.init_params(jax.random.key(0), jcfg))
    model = params_from_jax(jax.tree.map(np.asarray, params), PRESETS["test-byte"])
    rng = np.random.default_rng(1)
    mels = (rng.standard_normal((10, jcfg.num_mel_bins, 3000)) * 0.2).astype(np.float32)
    stops = np.random.default_rng(2).integers(8, MAX_LEN + 1, size=10)
    prompt = tg.transcribe_prompt(ST, ST.lang_begin + 6)
    refs = {}
    for name, (n, kv, (w, e, spr, src), with_stops) in CASES.items():
        refs[name] = js.generate_greedy_streaming(
            params, jcfg, mels[:n], jg.GenerateOptions(prompt_ids=prompt, max_length=MAX_LEN),
            JST, kv_dtype=kv,
            stream=js.StreamConfig(batch=w, encode_batch=e, steps_per_round=spr,
                                   source_windows=src),
            stop_at=stops[:n] if with_stops else None,
        )
    return model, mels, stops, tg.GenerateOptions(prompt_ids=prompt, max_length=MAX_LEN), refs


def _port_stream(setup, name, source=np.asarray):
    model, mels, stops, opts, _ = setup
    n, kv, (w, e, spr, src), with_stops = CASES[name]
    return ts.generate_greedy_streaming(
        model, source(mels[:n]), opts, ST, kv_dtype=kv,
        stream=ts.StreamConfig(batch=w, encode_batch=e, steps_per_round=spr, source_windows=src),
        stop_at=stops[:n] if with_stops else None, device="cpu",
    )


@pytest.mark.parametrize("name", list(CASES))
def test_streaming_tokens_equal_jax(setup, name):
    got = _port_stream(setup, name)
    ref = np.asarray(setup[4][name])
    assert got.dtype == np.int32 and got.shape == ref.shape == (CASES[name][0], MAX_LEN)
    np.testing.assert_array_equal(got, ref)


def test_tensor_source_equals_numpy_source(setup):
    """A tensor source is used whole; a numpy one in slabs: same tokens."""
    np.testing.assert_array_equal(_port_stream(setup, "slabbed-ragged", torch.from_numpy),
                                  np.asarray(setup[4]["slabbed-ragged"]))


def test_streaming_equals_lockstep_greedy(setup):
    """Each row equals the port's lockstep decode up to its stop, and is
    pad past it unless the row ended at eot. Compute-dtype KV only: with
    int8 KV the refill runs the prompt prefix over its full-precision K/V
    and the lockstep prefill over the int8 cache (both as the JAX package
    does), which moves a later token of one row here."""
    model, mels, stops, opts, _ = setup
    full = tg.generate_greedy(model, torch.from_numpy(mels), opts, ST, device="cpu").numpy()
    out = _port_stream(setup, "stops-compute")
    for i, stop in enumerate(stops):
        np.testing.assert_array_equal(out[i][:stop], full[i][:stop], err_msg=f"row {i}")
        assert (out[i][stop:] == model.cfg.pad_token_id).all() or full[i][stop - 1] == ST.eot


def test_streaming_raises_on_what_is_not_ported(setup):
    model, mels, _, opts, _ = setup
    with pytest.raises(ValueError, match="prefetch"):
        ts.generate_greedy_streaming(model, mels[:2], opts, ST,
                                     stream=ts.StreamConfig(prefetch=True), device="cpu")
    with pytest.raises(ValueError, match="at least one sampled token"):
        ts.generate_greedy_streaming(model, mels[:2], opts, ST, stop_at=np.array([3, 9]),
                                     device="cpu")
