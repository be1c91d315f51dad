"""The port's int4 KV cache vs the JAX package's (fp32, CPU, tiny models).

int4 mode stores the cross K/V as int4 codes, packed two a byte in the
port (models/whisper.pack_int4), with bf16 scales per (row, head), and the
self K/V as int8 with scales of the same per-head form. Held here, on
inputs made from numpy seeds:
- `quantize_kv_heads` codes and bf16 scales bit-exact to JAX's, .5 ties
  included; `pack_int4` / `unpack_int4` round trips;
- `init_cache(kv_dtype="int4")` buffers equal to JAX's (its int4 codes
  read as int8), lockstep and beam;
- K2's twins and the ring and beam kernels' CPU walks against JAX's
  `decode_attention_reference` and `_beam` with per-head scales, and the
  K/V modes the wrappers accept and refuse (`_kv_args`);
- decode-step logits (prefill, single-token steps, a beam step) within
  1e-5 of JAX's;
- greedy tokens exact; beam tokens exact with scores within 1e-5; the
  greedy stream and the ring and scatter beam streams exact against the
  JAX streams and against the port's own lockstep int4 decode.
The drivers' and the pipeline's int4 runs are cases of
tests/test_torch_pseudo_label.py, test_torch_serving.py and
test_torch_eval_cli.py; TP=2 int4 is a case of test_torch_parallel.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kotoba_whisper_tpu.core.config import PRESETS as JAX_PRESETS
from kotoba_whisper_tpu.core.config import SpecialTokens as JaxSpecialTokens
from kotoba_whisper_tpu.decode import beam as jb
from kotoba_whisper_tpu.decode import greedy as jg
from kotoba_whisper_tpu.decode import streaming as js
from kotoba_whisper_tpu.decode import streaming_beam as jsb
from kotoba_whisper_tpu.models import whisper as jw
from kotoba_whisper_tpu.ops import decode_attention as jda
from kotoba_whisper_tpu_torch.core.config import PRESETS, SpecialTokens
from kotoba_whisper_tpu_torch.decode import beam as tb
from kotoba_whisper_tpu_torch.decode import greedy as tg
from kotoba_whisper_tpu_torch.decode import streaming as ts
from kotoba_whisper_tpu_torch.decode import streaming_beam as tsb
from kotoba_whisper_tpu_torch.models import whisper as tw
from kotoba_whisper_tpu_torch.models.convert import params_from_jax
from kotoba_whisper_tpu_torch.ops import decode_attention as tda

ST = SpecialTokens.layout(n_text=256, n_langs=99)
JST = JaxSpecialTokens.layout(n_text=256, n_langs=99)
MAX_LEN = 24   # the greedy modes' budget
BEAM_LEN = 20  # the beam modes'
N = 6          # utterances of the beam modes
TOL = dict(atol=2e-5, rtol=1e-4)  # the twins' fp32 sums in another order
B, T, H, HD = 3, 70, 4, 64


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny CPU tensors: one intra-op thread, so torch's thread pool does
    not spin-wait on cores the parallel test workers oversubscribe."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_heads(x, bits):
    """JAX's quantize_kv_heads -> (int8 codes, bf16 scales as a torch tensor)."""
    q, s = jw.quantize_kv_heads(jnp.asarray(x), H, jnp.int4 if bits == 4 else jnp.int8)
    return np.asarray(q).astype(np.int8), torch.from_numpy(np.asarray(s, np.float32)).bfloat16()


# ---------------------------------------------------------------------------
# Cache format
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bits", [4, 8])
def test_quantize_kv_heads_matches_jax(bits):
    """Codes and bf16 scales bit-exact, on random rows and on a row whose
    every head has absmax qmax (scale 1) and values on .5 ties, which round
    half to even."""
    qmax = 7 if bits == 4 else 127
    x = np.random.default_rng(bits).standard_normal((2, 5, H * HD)).astype(np.float32) * 3
    ties = np.tile(np.array([qmax, -2.5, -1.5, -0.5, 0.5, 1.5, 2.5, 3.5], np.float32),
                   H * HD // 8)
    x[1, 2] = ties
    codes, scales = tw.quantize_kv_heads(torch.from_numpy(x), H, bits)
    ref_codes, ref_scales = _jax_heads(x, bits)
    assert codes.dtype == torch.int8 and scales.dtype == torch.bfloat16
    assert scales.shape == (2, 5, H)
    np.testing.assert_array_equal(codes.numpy(), ref_codes)
    assert torch.equal(scales, ref_scales)
    assert codes[1, 2, 1:8].tolist() == [-2, -2, 0, 0, 2, 2, 4]
    assert int(codes.abs().max()) <= qmax


def test_pack_int4_round_trips():
    """Every byte unpacks and packs back; every code pair packs and unpacks
    back; column 2j is byte j's low nibble, 2j + 1 its high nibble."""
    every_byte = torch.arange(256, dtype=torch.uint8).reshape(4, 64)
    assert torch.equal(tw.pack_int4(tda.unpack_int4(every_byte)), every_byte)
    codes = torch.from_numpy(np.random.default_rng(0).integers(-8, 8, (3, 7, 32)).astype(np.int8))
    packed = tw.pack_int4(codes)
    assert packed.dtype == torch.uint8 and packed.shape == (3, 7, 16)
    assert torch.equal(tda.unpack_int4(packed), codes)
    assert tw.pack_int4(torch.tensor([-1, 3], dtype=torch.int8)).item() == 0x3F
    assert tda.unpack_int4(torch.tensor([0x8F], dtype=torch.uint8)).tolist() == [-1, -8]


@pytest.fixture(scope="module")
def setup():
    """The JAX package's int4 stream tests' setups (tests/
    test_streaming_decode.py, test_streaming_beam.py): test-byte at key 0,
    10 mel windows, per-utterance stops, a 24-token greedy and a 20-token
    beam budget; and JAX's int4 decodes of them."""
    jcfg = JAX_PRESETS["test-byte"]
    params = jw.init_params(jax.random.key(0), jcfg)
    model = params_from_jax(jax.tree.map(np.asarray, params), PRESETS["test-byte"])
    mels = (np.random.default_rng(1).standard_normal((10, jcfg.num_mel_bins, 3000))
            * 0.2).astype(np.float32)
    stops = np.random.default_rng(2).integers(8, MAX_LEN + 1, size=10)
    prompt = tg.transcribe_prompt(ST, ST.lang_begin + 6)
    opts = {n: tg.GenerateOptions(prompt_ids=prompt, max_length=n) for n in (MAX_LEN, BEAM_LEN)}
    jopts = {n: jg.GenerateOptions(prompt_ids=prompt, max_length=n) for n in (MAX_LEN, BEAM_LEN)}
    refs = {
        "greedy": np.asarray(jg.generate_greedy(params, jcfg, jnp.asarray(mels), jopts[MAX_LEN],
                                                JST, kv_dtype="int4")),
        "beam": tuple(np.asarray(a) for a in jb.generate_beam(
            params, jcfg, jnp.asarray(mels[:N]), jopts[BEAM_LEN], JST, num_beams=3,
            kv_dtype="int4")),
        "stream": js.generate_greedy_streaming(
            params, jcfg, mels, jopts[MAX_LEN], JST, kv_dtype="int4",
            stream=js.StreamConfig(batch=4, encode_batch=2, steps_per_round=3),
            stop_at=stops),
    }
    for layout in ("ring", "scatter"):
        refs[layout] = jsb.generate_beam_streaming(
            params, jcfg, mels[:N], jopts[BEAM_LEN], JST, kv_dtype="int4",
            stream=jsb.BeamStreamConfig(groups=3, num_beams=3, encode_batch=2,
                                        steps_per_round=4, layout=layout))
    return jcfg, params, model, mels, stops, opts, refs


@pytest.mark.parametrize("beam_size", [1, 2])
def test_init_cache_matches_jax(setup, beam_size):
    jcfg, params, model, mels, _, _, _ = setup
    enc = jw.encode(params, jcfg, jnp.asarray(mels[:2]))
    ref = jw.init_cache(params, jcfg, enc, 9, kv_dtype="int4", beam_size=beam_size)
    got = tw.init_cache(model, torch.from_numpy(np.array(enc)), 9, kv_dtype="int4",
                        beam_size=beam_size, device="cpu")
    assert got.per_head_scales and got.kv_dtype == "int4" and ref.per_head_scales
    layers, heads, d = jcfg.decoder_layers, jcfg.decoder_attention_heads, jcfg.d_model
    assert got.cross_k.dtype == torch.uint8 and got.cross_k.shape == (layers, 2, 1500, d // 2)
    for name in ("cross_k", "cross_v"):
        ref_codes = np.asarray(getattr(ref, name)).astype(np.int8)
        np.testing.assert_array_equal(tda.unpack_int4(getattr(got, name)).numpy(), ref_codes)
    for name in ("cross_k_scale", "cross_v_scale", "self_k_scale", "self_v_scale"):
        r = getattr(ref, name)
        assert r.dtype == jnp.bfloat16
        assert torch.equal(getattr(got, name),
                           torch.from_numpy(np.asarray(r, np.float32)).bfloat16()), name
    assert got.self_k_scale.shape == (layers, 2 * beam_size, 9, heads)
    for name in ("self_k", "self_v"):
        assert getattr(got, name).dtype == torch.int8
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(ref, name)))


# ---------------------------------------------------------------------------
# K2: twins, walks, modes
# ---------------------------------------------------------------------------

def _kv(seed, bits, t=T, b=B):
    """q, and K/V quantized per head by JAX: the port's storage (packed for
    4 bits) and the JAX arrays."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, H, HD)).astype(np.float32)
    k, v = (rng.standard_normal((b, t, H * HD)).astype(np.float32) for _ in range(2))
    out = [q]
    for x in (k, v):
        codes, s = _jax_heads(x, bits)
        store = torch.from_numpy(codes)
        out.append((tw.pack_int4(store) if bits == 4 else store, s,
                    jnp.asarray(codes, jnp.int4 if bits == 4 else jnp.int8),
                    jnp.asarray(s.float().numpy(), jnp.bfloat16)))
    return out


@pytest.mark.parametrize("form", ["int4-scalar", "int4-rows", "int8-heads-ring"])
def test_twin_matches_jax(form):
    bits = 8 if form.startswith("int8") else 4
    q, (k, ks, jk, jks), (v, vs, jv, jvs) = _kv(len(form), bits)
    valid = np.array([T, 17, 1], np.int32) if form != "int4-scalar" else 41
    ring = 33 if "ring" in form else None
    ref = jda.decode_attention_reference(
        jnp.asarray(q), jk, jv, jnp.asarray(valid), n_heads=H, k_scale=jks, v_scale=jvs,
        ring_pos=ring)
    got = tda.decode_attention(
        torch.from_numpy(q), k, v, torch.from_numpy(valid) if form != "int4-scalar" else valid,
        n_heads=H, k_scale=ks, v_scale=vs,
        ring_pos=None if ring is None else torch.tensor(ring, dtype=torch.int32))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def test_beam_twin_takes_per_head_scales_on_the_head_axis():
    """(G, T, H) scales against scores (G, T, K, H): the head axis, not the
    beam axis (3 beams, 4 heads, so a wrong broadcast cannot pass)."""
    _, (k, ks, jk, jks), (v, vs, jv, jvs) = _kv(5, 4, b=2)
    q = np.random.default_rng(6).standard_normal((2, 3, H, HD)).astype(np.float32)
    ref = jda.decode_attention_reference_beam(jnp.asarray(q), jk, jv, n_heads=H,
                                              k_scale=jks, v_scale=jvs)
    got = tda.decode_attention_beam(torch.from_numpy(q), k, v, n_heads=H, k_scale=ks,
                                    v_scale=vs)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("form", ["ring-int8-heads", "beam-int4", "beam-int4-8-shares",
                                  "beam-int4-one-share", "beam-int4-K1", "beam-int4-K8",
                                  "beam-int4-K9", "beam-int4-K17"])
def test_kernel_walks_match_jax(form):
    """The ring and beam kernels' arithmetic in their order with per-head
    scales (fp32 P and output) against JAX's reference: the ring walk on
    the per-head form's grid (the per-row form's at even H) with a
    ring_pos; the beam
    walk on `beam_plan`'s key shares of packed int4 (8-beam tiles): 3 (2
    groups over T=150), a full cluster of 8 (one group over T=1500) and one
    (a card of one SM) at 5 beams, and 1, 8, 9 and 17 beams (one to three
    tiles), also with P * v_scale rounded to bf16 as the kernel does,
    within the card's max |err| 2e-3."""
    if form == "ring-int8-heads":
        q, (k, ks, jk, jks), (v, vs, jv, jvs) = _kv(8, 8)
        q = torch.from_numpy(q).bfloat16().float().numpy()  # the walks take q as bf16
        valid = np.array([T, 40, 1], np.int32)
        plan = tda.ring_plan(B, T, H, torch.int8, per_head=True)
        assert plan[:3] == tda.ring_plan(B, T, H, torch.int8)[:3]
        ref = jda.decode_attention_reference(jnp.asarray(q), jk, jv, jnp.asarray(valid),
                                             n_heads=H, k_scale=jks, v_scale=jvs, ring_pos=12)
        got = tda.ring_walk(torch.from_numpy(q), k, v, torch.from_numpy(valid), 12, n_heads=H,
                            k_scale=ks, v_scale=vs, out_dtype=torch.float32)
    else:
        g, t, n_sms, splits, beams = {"beam-int4": (2, 150, tda.N_SMS, 3, 5),
                                      "beam-int4-8-shares": (1, 1500, tda.N_SMS, 8, 5),
                                      "beam-int4-one-share": (2, 150, 1, 1, 5),
                                      "beam-int4-K1": (2, 150, tda.N_SMS, 3, 1),
                                      "beam-int4-K8": (2, 150, tda.N_SMS, 3, 8),
                                      "beam-int4-K9": (2, 150, tda.N_SMS, 3, 9),
                                      "beam-int4-K17": (2, 150, tda.N_SMS, 3, 17)}[form]
        _, (k, ks, jk, jks), (v, vs, jv, jvs) = _kv(9, 4, t=t, b=g)
        q = torch.from_numpy(np.random.default_rng(10).standard_normal((g, beams, H, HD))
                             ).bfloat16().float()
        plan = tda.beam_plan(g, t, H, beams, torch.uint8, n_sms)
        assert plan.splits == splits and plan.m_tiles == -(-beams // tda.BEAM_INT4_BEAMS)
        ref = jda.decode_attention_reference_beam(jnp.asarray(q.numpy()), jk, jv, n_heads=H,
                                                  k_scale=jks, v_scale=jvs)
        got = tda.beam_walk(q, k, v, n_heads=H, k_scale=ks, v_scale=vs, p_dtype=None,
                            out_dtype=torch.float32, n_sms=n_sms)
        rounded = tda.beam_walk(q, k, v, n_heads=H, k_scale=ks, v_scale=vs,
                                out_dtype=torch.float32, n_sms=n_sms)
        np.testing.assert_allclose(rounded.numpy(), np.asarray(ref), atol=2e-3, rtol=0)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5, rtol=1e-4)


def _mode_inputs(b=2, t=5, h=2):
    d = h * 64
    int8 = torch.zeros(b, t, d, dtype=torch.int8)
    int4 = torch.zeros(b, t, d // 2, dtype=torch.uint8)
    return dict(
        bf16=(torch.zeros(b, t, d, dtype=torch.bfloat16), None),
        int8=(int8, torch.ones(b, t, 1)),
        int8_heads=(int8, torch.ones(b, t, h, dtype=torch.bfloat16)),
        int4=(int4, torch.ones(b, t, h, dtype=torch.bfloat16)),
    )


def test_kv_args_names_each_mode():
    modes = {"bf16": tda.KV_BF16, "int8": tda.KV_INT8, "int8_heads": tda.KV_INT8_HEADS,
             "int4": tda.KV_INT4}
    for name, (kv, s) in _mode_inputs().items():
        assert tda._kv_args(-1, kv, kv.clone(), s, s, 2)[0] == modes[name], name


@pytest.mark.parametrize("bad", [
    "int4-fp32-scales", "int4-row-scales", "int4-no-scales", "int8-heads-shape",
    "int8-fp32-head-shape", "int8-fp16-scales", "bf16-with-scales", "int4-columns",
    "int4-mixed-scales",
])
def test_kv_args_rejects_mismatched_scales(bad):
    m = _mode_inputs()
    int8, int4 = m["int8"][0], m["int4"][0]
    bf = torch.ones(2, 5, 2, dtype=torch.bfloat16)
    kv, ks, vs = {
        "int4-fp32-scales": (int4, torch.ones(2, 5, 2), torch.ones(2, 5, 2)),
        "int4-row-scales": (int4, torch.ones(2, 5, 1, dtype=torch.bfloat16),
                            torch.ones(2, 5, 1, dtype=torch.bfloat16)),
        "int4-no-scales": (int4, None, None),
        "int8-heads-shape": (int8, torch.ones(2, 5, 3, dtype=torch.bfloat16),
                             torch.ones(2, 5, 3, dtype=torch.bfloat16)),
        "int8-fp32-head-shape": (int8, torch.ones(2, 5, 2), torch.ones(2, 5, 2)),
        "int8-fp16-scales": (int8, torch.ones(2, 5, 1, dtype=torch.float16),
                             torch.ones(2, 5, 1, dtype=torch.float16)),
        "bf16-with-scales": (m["bf16"][0], bf, bf),
        "int4-columns": (torch.zeros(2, 5, 128, dtype=torch.uint8), bf, bf),
        "int4-mixed-scales": (int4, bf, torch.ones(2, 5, 1)),
    }[bad]
    with pytest.raises(ValueError, match="K2"):
        tda._kv_args(-1, kv, kv.clone(), ks, vs, 2)


def test_plans_count_each_modes_bytes():
    """The prefix CTA's shared memory at the cross call (T=1500, 8 CTAs of
    188 rows): int8 per row as before; int4 takes the head kernel, whose
    CTA (4 heads, 375 rows, per-head bf16 scales) fits three an SM, and the
    row kernel's plan refuses it; ring per-head scales take the 4-byte
    words holding a slot's heads (at two heads a CTA one at even H, two at
    odd), so the stream's ring takes the per-row form's two heads a CTA;
    the int4 beam kernel's CTA holds its ring of 16 stages of 2 KB K and V
    tiles and scale words, and O of 8 beams for each of 8 consumer warps,
    on one key share."""
    assert tda.prefix_smem_bytes(188, 20, torch.int8) == 105120
    with pytest.raises(ValueError, match="head kernel"):
        tda.prefix_smem_bytes(188, 20, torch.uint8, per_head=True)
    int4 = tda.head_smem_bytes(375, 4)
    assert int4 == 49184 and 3 * (int4 + 1024) <= tda.SM_SMEM
    for n_heads, words in ((20, 1), (21, 2)):  # a slot's two heads start a word at even H
        assert (tda.ring_smem_bytes(176, 2, torch.int8, per_head=True, n_heads=n_heads)
                - tda.ring_smem_bytes(176, 2, torch.int8) == 8 * 176 * (words - 1))
    assert tda.ring_plan(48, 176, 20, torch.int8, 132, per_head=True).heads == 2
    assert (tda.BEAM_INT4_STAGES, tda.BEAM_INT4_WARPS) == (16, 8)
    assert tda.beam_smem_bytes(torch.uint8) == 94208  # 92160 for int8
    assert tda.beam_smem_bytes(torch.int8) == 92160
    assert tda.beam_plan(12, 1500, 20, 5, torch.uint8).grid == (1, 20, 12)


# ---------------------------------------------------------------------------
# Decode steps and the decode modes
# ---------------------------------------------------------------------------

def _to_port_cache(jc):
    """A JAX int4 cache as the port's: the int4 codes packed, the rest as is."""
    def t(x):
        if x.dtype == jnp.bfloat16:
            return torch.from_numpy(np.asarray(x, np.float32)).bfloat16()
        return torch.from_numpy(np.asarray(x).astype(np.int8))

    def packed(x):
        return tw.pack_int4(t(x))

    return tw.KVCache(t(jc.self_k), t(jc.self_v), packed(jc.cross_k), packed(jc.cross_v),
                      int(jc.length), t(jc.self_k_scale), t(jc.self_v_scale),
                      t(jc.cross_k_scale), t(jc.cross_v_scale))


@pytest.mark.parametrize("mode", ["lockstep", "beam"])
def test_decode_logits_match_jax(setup, monkeypatch, mode):
    """A 3-token prefill (dequantized attention) and two single-token steps
    (the twins over the int4 cross and per-head int8 self K/V), each from
    JAX's cache of the moment; in beam mode 2 groups x 3 beams over shared
    cross rows. Where the two packages' new int8 self K/V codes agree, the
    logits agree within 1e-5 of their largest; a code that differs lies
    within 1e-3 of a .5 tie of x / scale (round half to even sends fp32
    projections a few ulps apart to neighbouring levels)."""
    jcfg, params, model, mels, _, _, _ = setup
    k = 3 if mode == "beam" else 1
    enc = jw.encode(params, jcfg, jnp.asarray(mels[:2]))
    jc = jw.init_cache(params, jcfg, enc, 8, kv_dtype="int4", beam_size=k)
    ids = np.random.default_rng(4).integers(3, 256, (2 * k, 5)).astype(np.int32)
    seen = []
    quantize = tw.quantize_kv_heads
    monkeypatch.setattr(tw, "quantize_kv_heads", lambda x, h, bits: seen.append(
        (x, quantize(x, h, bits)[1])) or quantize(x, h, bits))
    hd = jcfg.d_model // jcfg.decoder_attention_heads
    compared = 0
    for lo, hi in ((0, 3), (3, 4), (4, 5)):
        tc = _to_port_cache(jc)
        seen.clear()
        ref, jc = jw.decode(params, jcfg, jnp.asarray(ids[:, lo:hi]), cache=jc, beam_size=k)
        got, tc = tw.decode(model, torch.from_numpy(ids[:, lo:hi]).long(), cache=tc,
                            beam_size=k, device="cpu")
        assert len(seen) == 2 * jcfg.decoder_layers  # k and v of each layer
        parted = False
        for j, name in enumerate(("self_k", "self_v")):
            mine = getattr(tc, name)[:, :, lo:hi].numpy().astype(np.int32)
            theirs = np.asarray(getattr(jc, name))[:, :, lo:hi].astype(np.int32)
            for layer, row, pos, col in zip(*np.nonzero(mine != theirs)):
                parted = True
                x, scale = seen[2 * layer + j]
                y = float(x[row, pos, col]) / float(scale[row, pos, col // hd])
                assert abs(mine[layer, row, pos, col] - theirs[layer, row, pos, col]) == 1
                assert abs(abs(y - np.trunc(y)) - 0.5) <= 1e-3, (name, lo, y)
        if not parted:
            compared += 1
            ref = np.asarray(ref)
            assert np.abs(got.numpy() - ref).max() <= 1e-5 * np.abs(ref).max(), (lo, hi)
    assert compared >= 2


def test_greedy_tokens_equal_jax(setup):
    _, _, model, mels, _, opts, refs = setup
    got = tg.generate_greedy(model, torch.from_numpy(mels), opts[MAX_LEN], ST, kv_dtype="int4",
                             device="cpu").numpy()
    np.testing.assert_array_equal(got, refs["greedy"])


def test_beam_tokens_and_scores_equal_jax(setup):
    _, _, model, mels, _, opts, refs = setup
    toks, scores = tb.generate_beam(model, torch.from_numpy(mels[:N]), opts[BEAM_LEN], ST,
                                    num_beams=3, kv_dtype="int4", device="cpu")
    np.testing.assert_array_equal(toks.numpy(), refs["beam"][0])
    np.testing.assert_allclose(scores.numpy(), refs["beam"][1], rtol=1e-5, atol=1e-5)


def test_greedy_stream_equals_jax_and_lockstep(setup):
    """Tokens exact against the JAX stream, and up to each stop against the
    port's lockstep int4 greedy (the JAX package's
    test_streaming_matches_lockstep_greedy[int4], on its setup)."""
    _, _, model, mels, stops, opts, refs = setup
    got = ts.generate_greedy_streaming(
        model, mels, opts[MAX_LEN], ST, kv_dtype="int4",
        stream=ts.StreamConfig(batch=4, encode_batch=2, steps_per_round=3), stop_at=stops,
        device="cpu")
    np.testing.assert_array_equal(got, np.asarray(refs["stream"]))
    full = tg.generate_greedy(model, torch.from_numpy(mels), opts[MAX_LEN], ST,
                              kv_dtype="int4", device="cpu").numpy()
    for i, stop in enumerate(stops):
        np.testing.assert_array_equal(got[i][:stop], full[i][:stop], err_msg=f"row {i}")


@pytest.mark.parametrize("layout", ["ring", "scatter"])
def test_beam_stream_equals_jax_and_lockstep(setup, layout):
    """The beam stream's refill pool is int4 (not int8): tokens exact
    against the JAX stream and the port's lockstep int4 beam search (the
    JAX package's test_streaming_beam_int4_ring and
    test_streaming_beam_matches_lockstep[int4]), scores within 1e-5 of
    the JAX stream's."""
    _, _, model, mels, _, opts, refs = setup
    toks, scores = tsb.generate_beam_streaming(
        model, mels[:N], opts[BEAM_LEN], ST, kv_dtype="int4",
        stream=tsb.BeamStreamConfig(groups=3, num_beams=3, encode_batch=2, steps_per_round=4,
                                    layout=layout),
        device="cpu")
    ref_toks, ref_scores = refs[layout]
    np.testing.assert_array_equal(toks, np.asarray(ref_toks))
    np.testing.assert_allclose(scores, np.asarray(ref_scores), rtol=1e-5, atol=1e-5)
    lock, _ = tb.generate_beam(model, torch.from_numpy(mels[:N]), opts[BEAM_LEN], ST,
                               num_beams=3, kv_dtype="int4", device="cpu")
    np.testing.assert_array_equal(toks, lock.numpy())
