"""The port's inference transforms vs the JAX package's: projection fusion
(models/optimized.py) and w8a8 projections (models/quantized.py).

fp32 on the CPU, tiny models with the same weights on both sides
(models/convert.params_from_jax):
  - fusion is lossless: fused and unfused port models give the same
    encoder states and logits within 1e-5;
  - quantization gives the JAX package's int8 weights exactly and its
    scales within 1e-7; `dense_int8` matches within 1e-6;
  - greedy tokens equal the JAX package's with fusion and with fusion +
    w8a8, compute and int8 KV;
  - converting a transformed JAX tree equals transforming the converted
    model.

The w8a8 cases hold the port to the JAX functions run op by op
(`jax.disable_jit()`): jitted on the CPU, XLA fuses the fp32 steps ahead of
the per-row activation quantization in a way that depends on the host CPU,
moves a value by about one ulp, and one int8 level flipped that way moves
the encoder's output by about one activation scale (0.084 jitted against
5.7e-6 op by op). The unquantized cases keep the jitted reference.
"""
import contextlib
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kotoba_whisper_tpu.core.config import PRESETS as JAX_PRESETS
from kotoba_whisper_tpu.core.config import SpecialTokens as JaxSpecialTokens
from kotoba_whisper_tpu.decode import greedy as jg
from kotoba_whisper_tpu.models import optimized as jopt
from kotoba_whisper_tpu.models import quantized as jq
from kotoba_whisper_tpu.models import whisper as jw
from kotoba_whisper_tpu_torch.core.config import PRESETS, SpecialTokens
from kotoba_whisper_tpu_torch.decode import greedy as tg
from kotoba_whisper_tpu_torch.models import whisper as tw
from kotoba_whisper_tpu_torch.models.convert import params_from_jax
from kotoba_whisper_tpu_torch.models.optimized import fuse_for_inference
from kotoba_whisper_tpu_torch.models.quantized import (
    QuantizedLinear, dense_int8, int8_matmul, quantize_dense_int8, quantize_for_inference,
)

ST = SpecialTokens.layout(256, 99)
JST = JaxSpecialTokens.layout(256, 99)
JCFG = JAX_PRESETS["test-byte"].replace(max_source_positions=64)
TCFG = PRESETS["test-byte"].replace(max_source_positions=64)


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
    params = jw.init_params(jax.random.key(3), JCFG)
    # larger weights than the N(0, 0.02) init, and nonzero biases, so the
    # logits are far from ties and every bias slot of the fusion shows
    leaves, treedef = jax.tree.flatten(jax.tree.map(lambda x: x * 4.0, params))
    rng = np.random.default_rng(1)
    leaves = [np.asarray(x) + rng.standard_normal(x.shape).astype(np.float32) * 0.02
              for x in leaves]
    params = jax.tree.unflatten(treedef, [jnp.asarray(x) for x in leaves])
    mel = np.random.default_rng(0).standard_normal((3, 80, 128)).astype(np.float32)
    return params, mel


def _jax_reference(w8a8):
    """The context the JAX reference runs in: op by op under w8a8, jitted
    otherwise (see the module docstring)."""
    return jax.disable_jit() if w8a8 else contextlib.nullcontext()


def _port(params):
    return params_from_jax(jax.tree.map(np.asarray, params), TCFG)


def _encode_and_logits(model, mel):
    enc = tw.encode(model, torch.from_numpy(mel), device="cpu")
    ids = torch.tensor([[ST.sot, ST.lang_begin + 7, ST.transcribe, 70, 71]] * 3)
    cache = tw.init_cache(model, enc, 8, device="cpu")
    _, cache = tw.decode(model, ids[:, :-1], cache=cache, device="cpu")
    step, _ = tw.decode(model, ids[:, -1:], cache=cache, device="cpu")
    full = tw.decode(model, ids, enc, device="cpu")
    return enc, step, full


def test_fusion_is_lossless(pair):
    params, mel = pair
    plain = _port(params)
    fused = fuse_for_inference(copy.deepcopy(plain))
    sa = fused.model.decoder.layers[0].self_attn
    assert hasattr(sa, "qkv_proj") and not hasattr(sa, "q_proj")
    assert sa.qkv_proj.weight.shape == (3 * TCFG.d_model, TCFG.d_model)
    ea = fused.model.decoder.layers[0].encoder_attn
    assert hasattr(ea, "kv_proj") and hasattr(ea, "q_proj") and not hasattr(ea, "k_proj")
    # k_proj has no bias: its slot of the fused bias is zero
    d = TCFG.d_model
    assert torch.equal(sa.qkv_proj.bias[d:2 * d], torch.zeros(d))
    for a, b in zip(_encode_and_logits(plain, mel), _encode_and_logits(fused, mel)):
        np.testing.assert_allclose(b.numpy(), a.numpy(), atol=1e-5, rtol=1e-5)


def test_quantized_weights_match_jax(pair):
    params, _ = pair
    jtree = jq.quantize_for_inference(jopt.fuse_for_inference(params))
    model = quantize_for_inference(fuse_for_inference(_port(params)))
    for side, n in (("encoder", JCFG.encoder_layers), ("decoder", JCFG.decoder_layers)):
        for i in range(n):
            layer = getattr(model.model, side).layers[i]
            for path in ("self_attn.qkv_proj", "self_attn.out_proj", "fc1", "fc2",
                         *(("encoder_attn.q_proj", "encoder_attn.kv_proj",
                            "encoder_attn.out_proj") if side == "decoder" else ())):
                mod = layer.get_submodule(path)
                assert isinstance(mod, QuantizedLinear) and mod.weight_q.dtype == torch.int8
                p = jtree[side]["layers"]
                for key in path.split("."):
                    p = p[key]
                np.testing.assert_array_equal(mod.weight_q.numpy(), np.asarray(p["kernel_q"][i]).T)
                np.testing.assert_allclose(mod.weight_scale.numpy(),
                                           np.asarray(p["kernel_scale"][i]), rtol=0, atol=1e-7)


def test_dense_int8_matches_jax():
    rng = np.random.default_rng(4)
    w = (rng.standard_normal((96, 40)) * 0.3).astype(np.float32)     # (in, out)
    bias = rng.standard_normal(40).astype(np.float32)
    x = rng.standard_normal((3, 7, 96)).astype(np.float32)
    jp = jq.quantize_dense_int8({"kernel": jnp.asarray(w), "bias": jnp.asarray(bias)})
    lin = torch.nn.Linear(96, 40)
    with torch.no_grad():
        lin.weight.copy_(torch.from_numpy(w.T))
        lin.bias.copy_(torch.from_numpy(bias))
    q = quantize_dense_int8(lin)
    got = dense_int8(q, torch.from_numpy(x)).numpy()
    ref = np.asarray(jq.dense_int8(jp, jnp.asarray(x)))
    np.testing.assert_allclose(got, ref, atol=1e-6, rtol=1e-6)
    # exact on representable values, as tests/test_quantized.py holds it
    w_int = rng.integers(-127, 128, size=(16, 8)).astype(np.float32)
    w_int[0] = 127.0
    kernel = w_int * rng.uniform(0.5, 2.0, size=(1, 8)).astype(np.float32)
    x_int = rng.integers(-127, 128, size=(4, 16)).astype(np.float32)
    x_int[:, 0] = 127.0
    lin = torch.nn.Linear(16, 8, bias=False)
    with torch.no_grad():
        lin.weight.copy_(torch.from_numpy(kernel.T))
    got = dense_int8(quantize_dense_int8(lin), torch.from_numpy(x_int * 0.03125)).numpy()
    np.testing.assert_allclose(got, (x_int * 0.03125) @ kernel, rtol=1e-6, atol=1e-4)


def test_int8_matmul_is_exact():
    rng = np.random.default_rng(5)
    a = torch.from_numpy(rng.integers(-127, 128, (5, 64)).astype(np.int8))
    w = torch.from_numpy(rng.integers(-127, 128, (24, 64)).astype(np.int8))
    got = int8_matmul(a, w)
    assert got.dtype == torch.int32
    assert torch.equal(got.long(), a.long() @ w.long().T)


@pytest.mark.parametrize("w8a8", [False, True], ids=["fused", "fused-w8a8"])
@pytest.mark.parametrize("kv_dtype", ["compute", "int8"])
def test_greedy_tokens_match_jax(pair, w8a8, kv_dtype):
    params, mel = pair
    jparams = jopt.fuse_for_inference(params)
    model = fuse_for_inference(_port(params))
    if w8a8:
        jparams = jq.quantize_for_inference(jparams)
        model = quantize_for_inference(model)
    prompt = tg.transcribe_prompt(ST, ST.lang_begin + 7)
    with _jax_reference(w8a8):
        ref = np.asarray(jg.generate_greedy(
            jparams, JCFG, jnp.asarray(mel), jg.GenerateOptions(prompt_ids=prompt, max_length=24),
            JST, kv_dtype=kv_dtype))
    got = tg.generate_greedy(
        model, torch.from_numpy(mel), tg.GenerateOptions(prompt_ids=prompt, max_length=24),
        ST, kv_dtype=kv_dtype, device="cpu").numpy()
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("transform", ["fused", "w8a8", "fused-w8a8", "w8a8-encoder"])
def test_converting_a_transformed_tree(pair, transform):
    """params_from_jax(transform(tree)) == transform(params_from_jax(tree)),
    and the converted model computes what the transformed JAX tree does."""
    params, mel = pair
    jtree, model = params, _port(params)
    if "fused" in transform:
        jtree, model = jopt.fuse_for_inference(jtree), fuse_for_inference(model)
    if "w8a8" in transform:
        parts = ("encoder",) if transform == "w8a8-encoder" else ("encoder", "decoder")
        jtree = jq.quantize_for_inference(jtree, parts=parts)
        model = quantize_for_inference(model, parts=parts)
    converted = _port(jtree)
    want, got = model.state_dict(), converted.state_dict()
    assert want.keys() == got.keys()
    for k in want:
        assert want[k].dtype == got[k].dtype, k
        if want[k].dtype == torch.int8:
            assert torch.equal(want[k], got[k]), k
        else:
            torch.testing.assert_close(got[k], want[k], atol=1e-7, rtol=0, msg=k)
    enc = tw.encode(converted, torch.from_numpy(mel), device="cpu").numpy()
    with _jax_reference("w8a8" in transform):
        ref = np.asarray(jw.encode(jtree, JCFG, jnp.asarray(mel)))
    np.testing.assert_allclose(enc, ref, atol=1e-4, rtol=1e-4)
