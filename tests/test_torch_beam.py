"""Port's lockstep beam search vs the JAX package's generate_beam.

A tiny fp32 test-byte model (max_source_positions 64) with identical
weights (models/convert.params_from_jax; scaled x4 as in
test_torch_greedy.py, so logits sit far from ties), three utterances:
tokens must be exact and scores within 1e-5 in three cases, (3 beams,
compute KV, length penalty 1.0), (5, int8, 1.0) and (3, int8, 0.6), the
last with eot remapped to a token the model emits early, so hypotheses
finish, the finished set fills and the early-stop heuristic ends rows.
num_beams=1 must give the port's greedy tokens up to eot. The JAX
references are decoded once per module.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kotoba_whisper_tpu.core.config import PRESETS as JAX_PRESETS
from kotoba_whisper_tpu.core.config import SpecialTokens as JaxSpecialTokens
from kotoba_whisper_tpu.decode import beam as jb
from kotoba_whisper_tpu.decode import greedy as jg
from kotoba_whisper_tpu.models import whisper as jw
from kotoba_whisper_tpu_torch.core.config import PRESETS, SpecialTokens
from kotoba_whisper_tpu_torch.decode import beam as tb
from kotoba_whisper_tpu_torch.decode import greedy as tg
from kotoba_whisper_tpu_torch.models.convert import params_from_jax

ST = SpecialTokens.layout(256, 99)
JST = JaxSpecialTokens.layout(256, 99)
MAX_LEN = 20
# name -> (num_beams, kv_dtype, length_penalty, eot remapped)
CASES = {
    "k3-compute": (3, "compute", 1.0, False),
    "k5-int8": (5, "int8", 1.0, False),
    "k3-int8-lp0.6-finishing": (3, "int8", 0.6, True),
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
    jcfg = JAX_PRESETS["test-byte"].replace(max_source_positions=64)
    params = jax.tree.map(lambda x: x * 4.0, jw.init_params(jax.random.key(3), jcfg))
    model = params_from_jax(jax.tree.map(np.asarray, params),
                            PRESETS["test-byte"].replace(max_source_positions=64))
    mel = np.random.default_rng(0).standard_normal((3, 80, 128)).astype(np.float32)
    prompt = tg.transcribe_prompt(ST, ST.lang_begin + 7)
    opts = tg.GenerateOptions(prompt_ids=prompt, max_length=MAX_LEN)
    # the token greedy emits second on row 0: as eot it ends hypotheses early
    early = int(tg.generate_greedy(model, torch.from_numpy(mel), opts, ST,
                                   device="cpu").numpy()[0, len(prompt) + 1])
    refs = {}
    for name, (k, kv, lp, finishing) in CASES.items():
        jst = dataclasses.replace(JST, eot=early) if finishing else JST
        toks, scores = jb.generate_beam(
            params, jcfg, jnp.asarray(mel), jg.GenerateOptions(prompt_ids=prompt,
                                                               max_length=MAX_LEN),
            jst, num_beams=k, length_penalty=lp, kv_dtype=kv)
        refs[name] = (np.asarray(toks), np.asarray(scores))
    return model, mel, opts, early, refs


@pytest.mark.parametrize("name", list(CASES))
def test_beam_tokens_and_scores_equal_jax(setup, name):
    model, mel, opts, early, refs = setup
    k, kv, lp, finishing = CASES[name]
    st = dataclasses.replace(ST, eot=early) if finishing else ST
    toks, scores = tb.generate_beam(model, torch.from_numpy(mel), opts, st, num_beams=k,
                                    length_penalty=lp, kv_dtype=kv, device="cpu")
    ref_toks, ref_scores = refs[name]
    assert toks.dtype == torch.int32 and toks.shape == (3, MAX_LEN)
    np.testing.assert_array_equal(toks.numpy(), ref_toks)
    np.testing.assert_allclose(scores.numpy(), ref_scores, rtol=1e-5, atol=1e-5)
    if finishing:  # hypotheses finished before max_length
        assert (toks.numpy() == early).any(axis=1).all()


def test_one_beam_is_greedy(setup):
    model, mel, opts, _, _ = setup
    greedy = tg.generate_greedy(model, torch.from_numpy(mel), opts, ST, device="cpu").numpy()
    toks, _ = tb.generate_beam(model, torch.from_numpy(mel), opts, ST, num_beams=1,
                               device="cpu")
    for g, b in zip(greedy.tolist(), toks.numpy().tolist()):
        g_end = g.index(ST.eot) + 1 if ST.eot in g else len(g)
        b_end = b.index(ST.eot) + 1 if ST.eot in b else len(b)
        assert g[:g_end] == b[:b_end]
