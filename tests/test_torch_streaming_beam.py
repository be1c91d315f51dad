"""Port's continuous-batching beam search vs the JAX package's.

The setup of the JAX package's tests/test_streaming_beam.py (the test-byte
model from init_params with key 0, six 30 s windows of seeded noise at
std 0.2, the transcribe prompt, max_length 20), with identical weights in
the port (models/convert.params_from_jax): the port's
generate_beam_streaming must give the JAX stream's tokens exactly and its
scores within 1e-5, in the "scatter" and "ring" layouts with compute and
int8 KV, with per-utterance stops, a length penalty of 0.6, a stream whose
length is not a multiple of the refill batch, a window with more rows than
the stream has utterances, a numpy source uploaded in slabs, and eot
remapped to a token the model emits early, so hypotheses finish and groups
end at different steps. In the "scatter" layout (the lockstep slot order)
with compute KV the port's stream must also equal its own generate_beam
per utterance. fp32 on the CPU. The JAX streams run once per module.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kotoba_whisper_tpu.core.config import PRESETS as JAX_PRESETS
from kotoba_whisper_tpu.core.config import SpecialTokens as JaxSpecialTokens
from kotoba_whisper_tpu.decode import greedy as jg
from kotoba_whisper_tpu.decode import streaming_beam as jsb
from kotoba_whisper_tpu.models import whisper as jw
from kotoba_whisper_tpu_torch.core.config import PRESETS, SpecialTokens
from kotoba_whisper_tpu_torch.decode import beam as tb
from kotoba_whisper_tpu_torch.decode import greedy as tg
from kotoba_whisper_tpu_torch.decode import streaming_beam as tsb
from kotoba_whisper_tpu_torch.models.convert import params_from_jax

ST = SpecialTokens.layout(n_text=256, n_langs=99)
JST = JaxSpecialTokens.layout(n_text=256, n_langs=99)
MAX_LEN = 20
N = 6

# name -> (utterances, kv_dtype, BeamStreamConfig fields, per-utterance
# stops, eot remapped to an early token)
CASES = {
    "scatter-compute": (6, "compute", dict(groups=3, num_beams=3, encode_batch=2,
                                           steps_per_round=4, layout="scatter"), False, False),
    "scatter-int8": (6, "int8", dict(groups=3, num_beams=3, encode_batch=2,
                                     steps_per_round=4, layout="scatter"), False, False),
    "ring-compute": (6, "compute", dict(groups=3, num_beams=3, encode_batch=2,
                                        steps_per_round=4), False, False),
    "ring-int8": (6, "int8", dict(groups=3, num_beams=3, encode_batch=2,
                                  steps_per_round=4), False, False),
    "stops": (6, "compute", dict(groups=2, num_beams=2, encode_batch=1, steps_per_round=5,
                                 layout="scatter"), True, False),
    "lp0.6": (4, "compute", dict(groups=2, num_beams=2, encode_batch=2, length_penalty=0.6,
                                 layout="scatter"), False, False),
    "ragged-int8": (5, "int8", dict(groups=3, num_beams=3, encode_batch=2,
                                    steps_per_round=4), False, False),
    "window-over-stream": (2, "compute", dict(groups=4, num_beams=2, encode_batch=2,
                                              steps_per_round=3), False, False),
    "slabbed": (6, "compute", dict(groups=3, num_beams=2, encode_batch=2, steps_per_round=4,
                                   source_windows=2), False, False),
    "finishing-stops": (6, "int8", dict(groups=2, num_beams=3, encode_batch=1,
                                        steps_per_round=3), True, True),
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
    model = params_from_jax(jax.tree.map(np.asarray, params), PRESETS["test-byte"])
    rng = np.random.default_rng(1)
    mels = (rng.standard_normal((N, jcfg.num_mel_bins, 3000)) * 0.2).astype(np.float32)
    stops = np.random.default_rng(3).integers(10, MAX_LEN + 1, size=N)
    prompt = tg.transcribe_prompt(ST, ST.lang_begin + 6)
    opts = tg.GenerateOptions(prompt_ids=prompt, max_length=MAX_LEN)
    # the token greedy emits second on utterance 0: as eot it ends
    # hypotheses early
    early = int(tg.generate_greedy(model, torch.from_numpy(mels[:1]), opts, ST,
                                   device="cpu").numpy()[0, len(prompt) + 1])
    refs = {}
    for name, (n, kv, fields, with_stops, finishing) in CASES.items():
        jst = dataclasses.replace(JST, eot=early) if finishing else JST
        refs[name] = jsb.generate_beam_streaming(
            params, jcfg, mels[:n], jg.GenerateOptions(prompt_ids=prompt, max_length=MAX_LEN),
            jst, kv_dtype=kv, stream=jsb.BeamStreamConfig(**fields),
            stop_at=stops[:n] if with_stops else None,
        )
    return model, mels, stops, opts, early, refs


def _port_stream(setup, name, source=np.asarray):
    model, mels, stops, opts, early, _ = setup
    n, kv, fields, with_stops, finishing = CASES[name]
    st = dataclasses.replace(ST, eot=early) if finishing else ST
    return tsb.generate_beam_streaming(
        model, source(mels[:n]), opts, st, kv_dtype=kv, stream=tsb.BeamStreamConfig(**fields),
        stop_at=stops[:n] if with_stops else None, device="cpu",
    )


@pytest.mark.parametrize("name", list(CASES))
def test_beam_stream_equals_jax(setup, name):
    toks, scores = _port_stream(setup, name)
    ref_toks, ref_scores = setup[-1][name]
    n = CASES[name][0]
    assert toks.dtype == np.int32 and toks.shape == (n, MAX_LEN)
    assert scores.dtype == np.float32 and scores.shape == (n,)
    np.testing.assert_array_equal(toks, np.asarray(ref_toks))
    np.testing.assert_allclose(scores, np.asarray(ref_scores), rtol=0, atol=1e-5)
    if name.startswith("finishing"):  # some hypotheses ended before their stop
        assert (toks == setup[4]).any()


def test_tensor_source_equals_numpy_source(setup):
    toks, scores = _port_stream(setup, "ring-compute", source=torch.from_numpy)
    ref_toks, ref_scores = setup[-1]["ring-compute"]
    np.testing.assert_array_equal(toks, np.asarray(ref_toks))
    np.testing.assert_allclose(scores, np.asarray(ref_scores), rtol=0, atol=1e-5)


@pytest.mark.parametrize("name", ["scatter-compute", "stops"])
def test_scatter_stream_equals_lockstep_beam(setup, name):
    """The lockstep slot order: each utterance's tokens are the port's own
    generate_beam at its stop length."""
    model, mels, stops, opts, _, _ = setup
    n, _, fields, with_stops, _ = CASES[name]
    toks, scores = _port_stream(setup, name)
    for i in range(n):
        length = int(stops[i]) if with_stops else MAX_LEN
        ref_toks, ref_scores = tb.generate_beam(
            model, torch.from_numpy(mels[i : i + 1]), dataclasses.replace(opts, max_length=length),
            ST, num_beams=fields["num_beams"], length_penalty=fields.get("length_penalty", 1.0),
            device="cpu")
        np.testing.assert_array_equal(toks[i, :length], ref_toks.numpy()[0], err_msg=f"row {i}")
        np.testing.assert_allclose(scores[i], ref_scores.numpy()[0], rtol=0, atol=1e-5)


def test_unported_options_raise(setup):
    model, mels, _, opts, _, _ = setup
    with pytest.raises(ValueError, match="prefetch is not ported"):
        tsb.generate_beam_streaming(model, mels[:2], opts, ST,
                                    stream=tsb.BeamStreamConfig(prefetch=True), device="cpu")
    with pytest.raises(ValueError, match="layout"):
        tsb.generate_beam_streaming(model, mels[:2], opts, ST,
                                    stream=tsb.BeamStreamConfig(layout="rows"), device="cpu")
