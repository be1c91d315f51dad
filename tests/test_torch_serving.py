"""Port's AsrPipeline vs the JAX package's, on the CPU in fp32.

One tiny model at test-tiny's widths (the test-byte preset: its vocab is
the byte tokenizer's id layout, so every sampled timestamp is one the
long-form merge reads; JAX params carried across by
models/convert.params_from_jax) and one seeded 40 s PCM-sourced input
rising in loudness, which the long-form chunker cuts into 4 chunks of 15 s
at a 10 s step: the text and the timestamped chunks must be identical for
greedy decode, beam search (3 beams), the int8 KV cache, the int4 KV cache
(greedy and 3 beams) and the int16 wire
(where on PCM-sourced audio the fp32 and int16 wires also agree with each
other in both packages), on the weights scaled x4 so that the tokens
follow the audio; and for w8a8 projections (fused + quantized on both
sides, the JAX reference op by op under jax.disable_jit(), the w8a8
yardstick of tests/test_torch_inference_transforms.py) on the weights as
initialised. At T=1500 an fp32 ulp between the two packages' sums ahead of
an activation quantize moves an int8 level, and the attention spreads it to
every row: as initialised the encoders part by less than a token's margin,
with the weights x4 one chunk's tokens part (ROADMAP.md, Queue 3).
`test_w8a8_parts_only_at_a_half_level_tie` holds that cause on the weights
x4: the fp32 encoders agree, and the first int8 codes that differ are ties.
"""
import contextlib
import copy

import jax
import numpy as np
import pytest
import torch

from kotoba_whisper_tpu.core.config import PRESETS as JAX_PRESETS
from kotoba_whisper_tpu.decode.pipeline import AsrPipeline as JaxAsrPipeline
from kotoba_whisper_tpu.models import optimized as jopt
from kotoba_whisper_tpu.models import quantized as jq
from kotoba_whisper_tpu.models import whisper as jw
from kotoba_whisper_tpu.tokenizer.whisper_tokenizer import WhisperTokenizer as JaxTokenizer
from kotoba_whisper_tpu_torch.core.config import PRESETS
from kotoba_whisper_tpu_torch.data.collator import CollatorConfig, collate_audio
from kotoba_whisper_tpu_torch.decode.longform import ChunkingConfig, chunk_audio
from kotoba_whisper_tpu_torch.decode.pipeline import AsrPipeline
from kotoba_whisper_tpu_torch.models import whisper as tw
from kotoba_whisper_tpu_torch.models.convert import params_from_jax
from kotoba_whisper_tpu_torch.models.optimized import fuse_for_inference
from kotoba_whisper_tpu_torch.models.quantized import quantize_for_inference
from kotoba_whisper_tpu_torch.ops.mel import log_mel_spectrogram
from kotoba_whisper_tpu_torch.tokenizer.whisper_tokenizer import WhisperTokenizer

MAX_LENGTH = 24


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny CPU tensors: one intra-op thread, so torch's thread pool does
    not spin-wait on cores the parallel test workers oversubscribe."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tiny():
    """JAX params and the port's model from them, x4 (`scaled`) and as
    initialised (`w8a8` takes these: see the module docstring), and the
    input."""
    params = jw.init_params(jax.random.key(0), JAX_PRESETS["test-byte"])
    models = {}
    for name, p in (("scaled", jax.tree.map(lambda x: x * 4.0, params)), ("w8a8", params)):
        models[name] = p, params_from_jax(jax.tree.map(np.asarray, p), PRESETS["test-byte"])
    # PCM-sourced: every sample is pcm / 32768, as native/audio.cpp emits it
    n = 40 * 16000
    noise = np.random.default_rng(7).uniform(-12000, 12000, n) * np.linspace(0.05, 1.0, n)
    return models, np.round(noise).astype(np.int16).astype(np.float32) / 32768.0


def _pipelines(params, model, **kw):
    cfg = JAX_PRESETS["test-byte"]
    jax_pipe = JaxAsrPipeline(params=params, cfg=cfg, tok=JaxTokenizer.byte_vocab(),
                              max_length=MAX_LENGTH, **kw)
    port_pipe = AsrPipeline(model=model, tok=WhisperTokenizer.byte_vocab(),
                            max_length=MAX_LENGTH, device="cpu", **kw)
    return jax_pipe, port_pipe


@pytest.mark.parametrize("case", ["greedy", "beam3", "int8-kv", "w8a8", "int16-wire", "int4-kv",
                                  "beam3-int4-kv"])
def test_pipeline_matches_jax(tiny, case):
    models, audio = tiny
    params, model = models["w8a8" if case == "w8a8" else "scaled"]
    kw = {"beam3": dict(num_beams=3), "int8-kv": dict(kv_dtype="int8"),
          "int4-kv": dict(kv_dtype="int4"), "beam3-int4-kv": dict(num_beams=3, kv_dtype="int4"),
          "w8a8": dict(kv_dtype="int8"), "int16-wire": dict(wire_dtype="int16")}.get(case, {})
    reference = contextlib.nullcontext()
    if case == "w8a8":
        params = jq.quantize_for_inference(jopt.fuse_for_inference(params))
        model = quantize_for_inference(fuse_for_inference(copy.deepcopy(model)))
        reference = jax.disable_jit()
    jax_pipe, port_pipe = _pipelines(params, model, **kw)
    with reference:
        ref = jax_pipe(audio)
    got = port_pipe(audio)
    assert got == ref
    assert got["chunks"] and all(isinstance(c["text"], str) for c in got["chunks"])
    if case != "w8a8":  # the unscaled model's tokens do not follow the audio
        assert len({c["text"] for c in got["chunks"]}) > 1, got["chunks"]
    if case == "int16-wire":
        fp32_jax, fp32_port = _pipelines(params, model)
        assert fp32_jax(audio) == ref
        assert fp32_port(audio) == got


def _int8_codes(x):
    """dense_int8's activation quantize in both packages, in numpy fp32:
    the codes and x / scale."""
    s_x = np.maximum(np.abs(x).max(-1, keepdims=True), np.float32(1e-8)) * np.float32(1 / 127)
    y = x * (np.float32(1) / s_x)
    return np.clip(np.round(y), -127, 127), y


def test_w8a8_parts_only_at_a_half_level_tie(tiny, monkeypatch):
    """The cause of the w8a8 divergence on the weights x4, on the 40 s
    input's 4 chunks and one log-mel for both: the fused fp32 encoders
    agree within 1e-4, and where the w8a8 encoders' int8 activation codes
    first differ, the inputs agree within 1e-5 and every code that differs
    has x / scale within 1e-5 of a .5 tie (round half to even sends the two
    packages' values to neighbouring levels). Every later quantize carries
    that level on."""
    models, audio = tiny
    params, model = models["scaled"]
    batch = collate_audio([c.audio for c in chunk_audio(audio, ChunkingConfig())],
                          CollatorConfig(n_samples=30 * 16000))
    feats = log_mel_spectrogram(batch, device="cpu")
    cfg = JAX_PRESETS["test-byte"]
    params, model = jopt.fuse_for_inference(params), fuse_for_inference(copy.deepcopy(model))
    with jax.disable_jit():
        enc_jax = np.asarray(jw.encode(params, cfg, feats.numpy()))
    enc_port = tw.encode(model, feats, device="cpu").numpy()
    assert np.abs(enc_jax - enc_port).max() <= 1e-4

    seen = {"jax": [], "port": []}
    jax_dense, port_dense = jq.dense_int8, tw.dense_int8
    monkeypatch.setattr(jq, "dense_int8", lambda p, x: seen["jax"].append(
        np.asarray(x, np.float32)) or jax_dense(p, x))
    monkeypatch.setattr(tw, "dense_int8", lambda q, x: seen["port"].append(
        x.float().numpy().copy()) or port_dense(q, x))
    params, model = jq.quantize_for_inference(params), quantize_for_inference(model)
    with jax.disable_jit():
        jw.encode(params, cfg, feats.numpy())
    tw.encode(model, feats, device="cpu")
    assert len(seen["jax"]) == len(seen["port"]) == 4 * cfg.encoder_layers
    for i, (x_jax, x_port) in enumerate(zip(seen["jax"], seen["port"])):
        (q_jax, y_jax), (q_port, _) = _int8_codes(x_jax), _int8_codes(x_port)
        parted = q_jax != q_port
        if parted.any():
            break
    else:
        raise AssertionError("the w8a8 encoders agree on every code: hold w8a8 at x4")
    tie = np.abs(np.abs(y_jax - np.trunc(y_jax)) - 0.5)
    assert np.abs(x_jax - x_port).max() <= 1e-5, i
    assert tie[parted].max() <= 1e-5, (i, int(parted.sum()), tie[parted])


def test_pipeline_batches_every_chunk_of_an_input(tiny):
    """One generate call a transcription, with all 4 chunks of the 40 s
    input collated to the 30 s context."""
    models, audio = tiny
    pipe = AsrPipeline(model=models["scaled"][1], tok=WhisperTokenizer.byte_vocab(), max_length=6,
                       device="cpu")
    shapes = []
    real = pipe._generate
    pipe._generate = lambda batch: shapes.append(batch.shape) or real(batch)
    pipe(audio)
    assert shapes == [(4, 15 * 16000)]
    assert real(np.zeros((4, 15 * 16000), np.float32)).shape == (4, 6)


def test_pipeline_refuses_an_unknown_wire(tiny):
    model = tiny[0]["scaled"][1]
    with pytest.raises(ValueError, match="wire_dtype"):
        AsrPipeline(model=model, tok=WhisperTokenizer.byte_vocab(), wire_dtype="int8",
                    device="cpu")
