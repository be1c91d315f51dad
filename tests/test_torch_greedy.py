"""Port's logits rules and greedy generation vs the JAX package.

apply_rules on crafted token histories must produce the same -inf mask
and values; generate_greedy must be token-exact on a tiny fp32 model with
identical weights (models/convert.params_from_jax), for compute and int8
KV caches, with timestamps on and off.
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
from kotoba_whisper_tpu.decode import logits_rules as jr
from kotoba_whisper_tpu.models import whisper as jw
from kotoba_whisper_tpu_torch.core.config import PRESETS, SpecialTokens
from kotoba_whisper_tpu_torch.decode import greedy as tg
from kotoba_whisper_tpu_torch.decode import logits_rules as tr
from kotoba_whisper_tpu_torch.models.convert import params_from_jax

ST = SpecialTokens.layout(256, 99)
JST = JaxSpecialTokens.layout(256, 99)
TB = ST.timestamp_begin


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny CPU tensors: one intra-op thread, so torch's thread pool does
    not spin-wait on cores the parallel test workers oversubscribe."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rule_cases():
    """(name, tokens row list, cur_len, rule kwargs)."""
    p = [ST.sot, ST.lang_begin + 7, ST.transcribe]
    L = 12

    def row(ids):
        return ids + [0] * (L - len(ids))

    return [
        ("first-token", [row(p), row(p)], 3, {}),
        ("after-one-ts", [row(p + [TB + 5]), row(p + [TB + 9])], 4, {}),
        ("ts-pair-closed", [row(p + [TB + 5, 65, TB + 8, TB + 8]),
                            row(p + [TB + 2, TB + 2, 66, 67])], 7, {}),
        ("monotonic", [row(p + [TB + 5, 65, 66, TB + 30, 70]),
                       row(p + [TB + 1, 65, TB + 3, TB + 3, 71])], 8, {}),
        ("no-logprob-rule", [row(p), row(p + [TB])], 3,
         dict(detect_timestamp_from_logprob=False)),
        ("suppress", [row(p + [TB + 1]), row(p + [65])], 4,
         dict(suppress_tokens=(65, 66, 300), begin_suppress_tokens=(ST.eot,))),
        ("per-row-len", [row(p + [TB + 4, 65]), row(p)], np.array([5, 3]), {}),
        ("no-timestamps", [row(p + [65]), row(p + [66, 67])], 5,
         dict(return_timestamps=False, suppress_tokens=(70,))),
    ]


@pytest.mark.parametrize("case", _rule_cases(), ids=lambda c: c[0])
def test_apply_rules_matches_jax(case):
    _, toks, cur, kw = case
    rng = np.random.default_rng(len(toks[0]) + int(np.sum(cur)))
    logits = (rng.standard_normal((2, ST.vocab_size)) * 3).astype(np.float32)
    # make the timestamp-probability rule bite on one row
    logits[1, TB:] += 4.0
    toks = np.asarray(toks, np.int32)
    ref = np.asarray(jr.apply_rules(
        jnp.asarray(logits), jnp.asarray(toks), jnp.asarray(cur),
        jr.RuleConfig(special=JST, begin_index=3, **kw),
    ))
    got = tr.apply_rules(
        torch.from_numpy(logits), torch.from_numpy(toks).long(),
        torch.from_numpy(cur) if isinstance(cur, np.ndarray) else cur,
        tr.RuleConfig(special=ST, begin_index=3, **kw),
    ).numpy()
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(ref))
    np.testing.assert_allclose(got[np.isfinite(got)], ref[np.isfinite(ref)], rtol=1e-6)


@pytest.fixture(scope="module")
def tiny():
    jcfg = JAX_PRESETS["test-byte"].replace(max_source_positions=64)
    tcfg = PRESETS["test-byte"].replace(max_source_positions=64)
    params = jw.init_params(jax.random.key(3), jcfg)
    # larger weights than the N(0, 0.02) init so the logits are far from
    # ties and the decoded sequences vary across rows
    params = jax.tree.map(lambda x: x * 4.0, params)
    model = params_from_jax(jax.tree.map(np.asarray, params), tcfg)
    mel = np.random.default_rng(0).standard_normal((3, 80, 128)).astype(np.float32)
    return jcfg, params, model, mel


@pytest.mark.parametrize("kv_dtype", ["compute", "int8"])
@pytest.mark.parametrize("timestamps", [True, False], ids=["ts", "nots"])
def test_generate_greedy_token_exact(tiny, kv_dtype, timestamps):
    jcfg, params, model, mel = tiny
    prompt = tg.transcribe_prompt(ST, ST.lang_begin + 7, timestamps=timestamps)
    ref = np.asarray(jg.generate_greedy(
        params, jcfg, jnp.asarray(mel),
        jg.GenerateOptions(prompt_ids=prompt, max_length=24, return_timestamps=timestamps),
        JST, kv_dtype=kv_dtype,
    ))
    got = tg.generate_greedy(
        model, torch.from_numpy(mel),
        tg.GenerateOptions(prompt_ids=prompt, max_length=24, return_timestamps=timestamps),
        ST, kv_dtype=kv_dtype, device="cpu",
    ).numpy()
    assert got.dtype == np.int32 and got.shape == (3, 24)
    np.testing.assert_array_equal(got, ref)


def test_generate_greedy_early_exit_and_stop_at(tiny):
    """eot ends rows (pad after it) and stop_at caps row lengths, exactly as
    the JAX while-loop does: here eot is remapped to the token the model
    emits first, so rows finish early."""
    jcfg, params, model, mel = tiny
    prompt = tg.transcribe_prompt(ST, ST.lang_begin + 7)
    opts = dict(prompt_ids=prompt, max_length=20)
    first = tg.generate_greedy(
        model, torch.from_numpy(mel), tg.GenerateOptions(**opts), ST, device="cpu"
    ).numpy()[0, len(prompt) + 1]
    st = dataclasses.replace(ST, eot=int(first))
    jst = dataclasses.replace(JST, eot=int(first))
    stop = np.array([20, 9, 14], np.int32)
    ref = np.asarray(jg.generate_greedy(
        params, jcfg, jnp.asarray(mel), jg.GenerateOptions(**opts), jst,
        stop_at=jnp.asarray(stop),
    ))
    got = tg.generate_greedy(
        model, torch.from_numpy(mel), tg.GenerateOptions(**opts), st,
        stop_at=torch.from_numpy(stop), device="cpu",
    ).numpy()
    np.testing.assert_array_equal(got, ref)
    assert (got == jcfg.pad_token_id).any()
