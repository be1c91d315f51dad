"""StreamConfig.prefetch / BeamStreamConfig.prefetch: the next pool slice's
encode queued behind a round that ended on its refill test
(decode/streaming.py, decode/streaming_beam.py).

On the CPU, fp32, compute KV, the test-byte model with identical weights
in both packages (models/convert.params_from_jax; x4 for the greedy
stream, as tests/test_torch_streaming.py scales it): the port's stream
with prefetch on gives the same tokens (and beam scores) as with it off,
and the JAX package's stream with prefetch=True gives the same tokens
(scores within 1e-5), with per-utterance stops, a stream whose length is
not a multiple of the refill batch, and a numpy source uploaded in slabs
of 4 windows, so that refills cross a slab boundary. The stream takes
each prefetched encode for the refill at its slice, encodes no slice
twice, and its KWT_STREAM_TRACE line counts the prefetched refills.
tests/test_torch_tools_cuda.py holds prefetch on the card.
"""
import json

import jax
import numpy as np
import pytest
import torch

from kotoba_whisper_tpu.core.config import PRESETS as JAX_PRESETS
from kotoba_whisper_tpu.core.config import SpecialTokens as JaxSpecialTokens
from kotoba_whisper_tpu.decode import greedy as jg
from kotoba_whisper_tpu.decode import streaming as js
from kotoba_whisper_tpu.decode import streaming_beam as jsb
from kotoba_whisper_tpu.models import whisper as jw
from kotoba_whisper_tpu_torch.core.config import PRESETS, SpecialTokens
from kotoba_whisper_tpu_torch.decode import greedy as tg
from kotoba_whisper_tpu_torch.decode import streaming as ts
from kotoba_whisper_tpu_torch.decode import streaming_beam as tsb
from kotoba_whisper_tpu_torch.models.convert import params_from_jax

ST = SpecialTokens.layout(n_text=256, n_langs=99)
JST = JaxSpecialTokens.layout(n_text=256, n_langs=99)
MAX_LEN = 20
N = 10

# name -> (utterances, StreamConfig fields, per-utterance stops)
GREEDY = {
    "stops": (10, dict(batch=4, encode_batch=2, steps_per_round=3), True),
    "slabbed-ragged": (9, dict(batch=4, encode_batch=2, steps_per_round=3, source_windows=4),
                       False),
}
# name -> (utterances, BeamStreamConfig fields, per-utterance stops)
BEAM = {
    "ring-stops": (6, dict(groups=3, num_beams=2, encode_batch=1, steps_per_round=3), True),
    "slabbed-ragged": (7, dict(groups=3, num_beams=2, encode_batch=2, steps_per_round=4,
                               source_windows=4), False),
    "scatter": (6, dict(groups=2, num_beams=3, encode_batch=2, steps_per_round=4,
                        layout="scatter"), False),
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
    params = jw.init_params(jax.random.key(0), jcfg)
    params4 = jax.tree.map(lambda x: x * 4.0, params)

    def to_port(p):
        return params_from_jax(jax.tree.map(np.asarray, p), PRESETS["test-byte"])

    rng = np.random.default_rng(1)
    mels = (rng.standard_normal((N, jcfg.num_mel_bins, 3000)) * 0.2).astype(np.float32)
    stops = np.random.default_rng(2).integers(8, MAX_LEN + 1, size=N)
    prompt = tg.transcribe_prompt(ST, ST.lang_begin + 6)
    jopts = jg.GenerateOptions(prompt_ids=prompt, max_length=MAX_LEN)
    refs = {}
    for name, (n, fields, with_stops) in GREEDY.items():
        refs["greedy", name] = np.asarray(js.generate_greedy_streaming(
            params4, jcfg, mels[:n], jopts, JST,
            stream=js.StreamConfig(prefetch=True, **fields),
            stop_at=stops[:n] if with_stops else None))
    for name, (n, fields, with_stops) in BEAM.items():
        toks, scores = jsb.generate_beam_streaming(
            params, jcfg, mels[:n], jopts, JST,
            stream=jsb.BeamStreamConfig(prefetch=True, **fields),
            stop_at=stops[:n] if with_stops else None)
        refs["beam", name] = np.asarray(toks), np.asarray(scores)
    opts = tg.GenerateOptions(prompt_ids=prompt, max_length=MAX_LEN)
    return {"greedy": to_port(params4), "beam": to_port(params)}, mels, stops, opts, refs


def _greedy(setup, name, prefetch):
    models, mels, stops, opts, _ = setup
    n, fields, with_stops = GREEDY[name]
    return ts.generate_greedy_streaming(
        models["greedy"], mels[:n], opts, ST, stream=ts.StreamConfig(prefetch=prefetch, **fields),
        stop_at=stops[:n] if with_stops else None, device="cpu")


def _beam(setup, name, prefetch):
    models, mels, stops, opts, _ = setup
    n, fields, with_stops = BEAM[name]
    return tsb.generate_beam_streaming(
        models["beam"], mels[:n], opts, ST,
        stream=tsb.BeamStreamConfig(prefetch=prefetch, **fields),
        stop_at=stops[:n] if with_stops else None, device="cpu")


@pytest.mark.parametrize("name", list(GREEDY))
def test_greedy_prefetch_equals_off_and_jax(setup, name):
    on, off = _greedy(setup, name, True), _greedy(setup, name, False)
    assert on.shape == (GREEDY[name][0], MAX_LEN)
    np.testing.assert_array_equal(on, off)
    np.testing.assert_array_equal(on, setup[4]["greedy", name])


@pytest.mark.parametrize("name", list(BEAM))
def test_beam_prefetch_equals_off_and_jax(setup, name):
    (on_t, on_s), (off_t, off_s) = _beam(setup, name, True), _beam(setup, name, False)
    ref_t, ref_s = setup[4]["beam", name]
    np.testing.assert_array_equal(on_t, off_t)
    np.testing.assert_array_equal(on_s, off_s)
    np.testing.assert_array_equal(on_t, ref_t)
    np.testing.assert_allclose(on_s, ref_s, rtol=0, atol=1e-5)


@pytest.mark.parametrize("stream", ["greedy", "beam"])
def test_prefetch_encodes_each_slice_once(setup, stream, monkeypatch, capsys):
    """Every slice is encoded once (`_encode_only`) and moved into the
    window once (`_refill_from_enc`), with prefetch on or off; with it on
    some refills take their slice prefetched, and the trace line counts
    them (none with it off)."""
    mod = ts if stream == "greedy" else tsb
    calls = {"encode": 0, "from_enc": 0}

    def counting(name, fn):
        def run(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return run

    monkeypatch.setattr(ts, "_encode_only", counting("encode", ts._encode_only))
    monkeypatch.setattr(mod, "_refill_from_enc", counting("from_enc", mod._refill_from_enc))
    monkeypatch.setenv("KWT_STREAM_TRACE", "1")
    run, name = (_greedy, "stops") if stream == "greedy" else (_beam, "ring-stops")
    cases = GREEDY if stream == "greedy" else BEAM
    n, fields = cases[name][:2]
    slices = -(-n // fields["encode_batch"])
    prefetched = {}
    for prefetch in (False, True):
        calls.update(encode=0, from_enc=0)
        capsys.readouterr()
        run(setup, name, prefetch)
        lines = [line for line in capsys.readouterr().err.splitlines()
                 if line.startswith("KWT_STREAM_TRACE ")]
        assert len(lines) == 1
        trace = json.loads(lines[0].split(" ", 1)[1])
        assert calls == {"encode": slices, "from_enc": slices}
        assert trace["refills"] == slices and trace["rounds"] > 0
        prefetched[prefetch] = trace["prefetched"]
    assert prefetched[False] == 0 and 0 < prefetched[True] < slices
