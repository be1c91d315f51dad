"""The port's experiment tools that time a path (kotoba_whisper_tpu_torch/
tools/: matmul_cal, train_exp, dec_exp, beam_exp, stream_exp, stream_ab,
speed_decomp, and enc_exp's variants) on the CPU at tiny sizes.

- Each tool's main() at test-tiny prints the JAX tool's JSON keys, plus
  the card's name ("device"; "cpu" here) and the keys the port adds, each
  named here: dec_exp's host_ms and host_bound, speed_decomp's config `pinned` in place
  of `attn` (refused by name).
- enc_exp's variants in fp32 equal the JAX tool's functions
  (tools/enc_exp.py loaded by importlib: encode_ablate with each flag,
  encode_bf16out, encode_tbd) within 1e-5, on the same test-tiny weights
  (models/convert.params_from_jax), unfused and fused; flat2d and unroll8
  are baseline exactly.
- dec_exp's full tokens equal a whisper.decode + apply_rules + argmax
  loop over the same encoder output; cross_t64 over the sliced output
  equals the same loop (fp32, compute KV).
- speed_decomp's split and fused calls give the same text.
- stream_ab's lockstep-real and stream-real give the same tokens for every
  utterance (fp32, compute KV, test-byte weights x4 so that logits sit
  far from ties).
- matmul_cal's int8 chain wraps as the JAX tool's astype(int8) does
  (tests/test_torch_tools_cuda.py holds its fp32 chain on the card).
"""
import importlib.util
import json
import pathlib

import jax
import numpy as np
import pytest
import torch

from kotoba_whisper_tpu.core.config import PRESETS as JAX_PRESETS
from kotoba_whisper_tpu.models import optimized as jopt
from kotoba_whisper_tpu.models import whisper as jw
from kotoba_whisper_tpu_torch.core.config import PRESETS, FeatureConfig, SpecialTokens
from kotoba_whisper_tpu_torch.decode.logits_rules import apply_rules
from kotoba_whisper_tpu_torch.models import whisper
from kotoba_whisper_tpu_torch.models.convert import params_from_jax
from kotoba_whisper_tpu_torch.models.optimized import fuse_for_inference
from kotoba_whisper_tpu_torch.tools import (
    beam_exp, dec_exp, enc_exp, matmul_cal, speed_decomp, stream_ab, stream_exp, train_exp,
)

REPO = pathlib.Path(__file__).resolve().parent.parent
TINY = ["--preset", "test-tiny", "--device", "cpu", "--trials", "1"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny CPU tensors: one intra-op thread, so torch's thread pool does
    not spin-wait on cores the parallel test workers oversubscribe."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _lines(capsys):
    return [json.loads(line) for line in capsys.readouterr().out.splitlines() if line.strip()]


# ---- each tool's record: the JAX tool's keys --------------------------------

def test_matmul_cal_keys(capsys):
    for dtype in ("bf16", "int8", "float32"):
        rec = matmul_cal.main(["--batch", "1", "--d_model", "32", "--steps", "2", "--trials", "1",
                               "--dtype", dtype, "--device", "cpu"])
        assert _lines(capsys) == [rec]
        assert set(rec) == {"shape", "dtype", "ms", "tflops", "device"}
        assert rec["dtype"] == dtype and rec["ms"] > 0 and rec["tflops"] > 0
        assert rec["shape"] == "(1500,32)x(32,128) chain x2"


def test_train_exp_keys(capsys):
    rec = train_exp.main(["--batch", "2", "--label_len", "16", *TINY])
    assert _lines(capsys) == [rec]
    assert set(rec) == {"batch", "remat", "microbatches", "ms_step", "audio_s_per_s", "compile_s",
                        "device"}
    assert (rec["batch"], rec["remat"], rec["microbatches"], rec["device"]) == (2, True, 1, "cpu")
    rec = train_exp.main(["--batch", "2", "--label_len", "16", "--no_remat", "--microbatches",
                          "2", *TINY])
    assert (rec["remat"], rec["microbatches"]) == (False, 2)


def test_train_exp_trains_the_decoder_only():
    cfg = PRESETS["test-tiny"]
    teacher = whisper.init_params(cfg, torch.Generator().manual_seed(0), device="cpu",
                                  dtype=torch.bfloat16).requires_grad_(False)
    student = train_exp.build_student(teacher, cfg, 1)
    enc = [p.clone() for p in student.model.encoder.parameters()]
    dec = [p.clone() for p in student.model.decoder.parameters()]
    train_exp.run(teacher, student, train_exp.make_batch(cfg, 2, 8, "cpu"), trials=1)
    assert all(torch.equal(a, b) for a, b in zip(enc, student.model.encoder.parameters()))
    assert not all(torch.equal(a, b) for a, b in zip(dec, student.model.decoder.parameters()))


def test_dec_exp_keys(capsys):
    out = dec_exp.main(["--batch", "2", "--steps", "3", *TINY])
    lines = _lines(capsys)
    assert lines[-1] == out and [list(line) for line in lines[:-1]] == [
        ["full"], ["no_head"], ["cross_t64"], ["w8a8"], ["attribution_per_step"]]
    assert set(out) == {"config", *dec_exp.VARIANTS, "attribution_per_step", "host_bound",
                        "device"}
    assert out["host_bound"] == all(out[v]["host_ms"] >= 0.9 * out[v]["total_ms"]
                                    for v in dec_exp.VARIANTS)
    assert out["config"] == {"batch": 2, "steps": 3, "kv": "int8"}
    for name in dec_exp.VARIANTS:
        assert set(out[name]) == {"total_ms", "per_step_ms", "host_ms"}
    attr = out["attribution_per_step"]
    assert set(attr) == {"logits_rules_argmax_ms", "cross_kv_stream_ms", "weight_stream_ms",
                         "residual_ms"}
    assert sum(attr.values()) == pytest.approx(out["full"]["per_step_ms"], rel=1e-12)


def test_dec_exp_w8a8_in_place_must_come_last():
    cfg, st, _, model = _tiny_fused()
    with pytest.raises(ValueError, match="last"):
        dec_exp.run(model, torch.zeros(1, 1500, cfg.d_model, dtype=torch.bfloat16), st,
                    ["w8a8", "full"], n_steps=1, trials=1)


def test_beam_exp_keys(capsys):
    out = beam_exp.main(["--groups", "2", "--beams", "2", "--steps", "2", "--max_len", "8", *TINY])
    lines = _lines(capsys)
    phases = ["encode_ms", "init_shared_ms", "prefill_ms", "step_shared_ms", "init_repl_ms",
              "step_repl_ms"]
    assert [list(line) for line in lines[:-1]] == [[p] for p in phases] and lines[-1] == out
    assert set(out) == {*phases, "full_ms", "full_per_step_ms", "config", "device"}
    assert out["config"] == {"groups": 2, "beams": 2, "gemm": "compute", "kv": "int8",
                             "steps": 2, "max_len": 8}


def test_stream_exp_keys(capsys):
    argv = ["--window", "4", "--encode_batch", "2", "--steps", "2", "--rounds", "1", *TINY[:4]]
    out = stream_exp.main(argv)
    assert _lines(capsys) == [out]
    assert set(out) == {"empty_state_ms", "encode_refill_ms", "round_ms", "per_step_ms", "config",
                        "device"}
    assert out["config"] == {"window": 4, "encode_batch": 2, "kv": "int8"}
    out = stream_exp.main(argv + ["--lockstep"])
    assert _lines(capsys) == [out] and set(out) == {"lockstep_e2e_ms", "device"}


def test_stream_ab_keys(capsys, monkeypatch):
    recs = stream_ab.main(["--n", "4", "--batch", "2", *TINY[:4]])
    assert _lines(capsys) == recs
    assert [r["config"] for r in recs] == ["lockstep-real", "stream-real"]
    assert all(set(r) == {"config", "value", "detail", "device"} for r in recs)
    assert set(recs[0]["detail"]) == {"batch_max", "mean_stop"}
    assert set(recs[1]["detail"]) == {"window", "kv", "trace"}
    assert recs[1]["detail"]["trace"]["refills"] == 2
    monkeypatch.setenv("KWT_AB_N", "2")
    monkeypatch.setenv("KWT_AB_EBATCH", "1")
    recs = stream_ab.main(["--n", "4", "--batch", "10", "--beam", *TINY[:4]])
    assert _lines(capsys) == recs
    assert [r["config"] for r in recs] == ["lockstep-beam", "stream-beam"]
    assert set(recs[0]) == {"config", "value", "device"}
    assert set(recs[1]) == {"config", "value", "detail", "device"}
    assert set(recs[1]["detail"]) == {"groups", "kv", "trace"}
    assert recs[1]["detail"]["trace"]["refills"] == 2
    recs = stream_ab.main(["--n", "6", "--batch", "2", "--skip-lockstep", "--prefetch",
                           *TINY[:4]])
    assert _lines(capsys) == recs and [r["config"] for r in recs] == ["stream-real"]
    assert recs[0]["detail"]["trace"]["refills"] == 3


def test_speed_decomp_keys(capsys):
    out = speed_decomp.main(["--duration", "20", "--model", "preset:test-tiny", "--device", "cpu",
                             "--trials", "1"])
    assert _lines(capsys) == [out]
    phases = {"host_chunk", "h2d", "mel", "decode", "d2h", "merge", "total_split", "fused_total"}
    assert set(out) == {*phases, "n_chunks", "config", "device"}
    assert all(set(out[p]) == {"min_s", "mean_s"} for p in phases)
    assert out["n_chunks"] == 2
    assert out["config"] == {"duration": 20.0, "serving": False, "max_length": 32,
                             "wire": "float32", "pinned": False}


def test_speed_decomp_refuses_attn():
    with pytest.raises(SystemExit):
        speed_decomp.main(["--attn", "pallas", "--device", "cpu"])


# ---- enc_exp's variants against the JAX tool's functions ---------------------

def _jax_enc_exp():
    spec = importlib.util.spec_from_file_location("jax_tools_enc_exp",
                                                  REPO / "tools" / "enc_exp.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def enc_setup():
    jcfg = JAX_PRESETS["test-tiny"]
    params = jw.init_params(jax.random.key(0), jcfg)
    feats = (np.random.default_rng(0).standard_normal((2, jcfg.num_mel_bins, 3000)) * 0.1
             ).astype(np.float32)
    return _jax_enc_exp(), jcfg, params, feats


JAX_VARIANTS = {
    "ab_nosoftmax": lambda m, p, c, f: m.encode_ablate(p, c, f, compute_dtype=np.float32,
                                                       no_softmax=True),
    "ab_nogelu": lambda m, p, c, f: m.encode_ablate(p, c, f, compute_dtype=np.float32,
                                                    no_gelu=True),
    "ab_noln": lambda m, p, c, f: m.encode_ablate(p, c, f, compute_dtype=np.float32, no_ln=True),
    "ab_gemmonly": lambda m, p, c, f: m.encode_ablate(p, c, f, compute_dtype=np.float32,
                                                      no_softmax=True, no_gelu=True, no_ln=True),
    "bf16out": lambda m, p, c, f: m.encode_bf16out(p, c, f, compute_dtype=np.float32),
    "tbd": lambda m, p, c, f: m.encode_tbd(p, c, f, compute_dtype=np.float32),
    "tbd_pallas": lambda m, p, c, f: m.encode_tbd(p, c, f, compute_dtype=np.float32,
                                                  attn_impl="pallas"),
}


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
@pytest.mark.parametrize("variant", list(JAX_VARIANTS))
def test_enc_exp_variant_equals_jax(enc_setup, variant, fused):
    mod, jcfg, params, feats = enc_setup
    model = params_from_jax(jax.tree.map(np.asarray, params), PRESETS["test-tiny"])
    if fused:
        params, model = jopt.fuse_for_inference(params), fuse_for_inference(model)
    ref = np.asarray(JAX_VARIANTS[variant](mod, params, jcfg, feats))
    fn = enc_exp.make_variants(model)[enc_exp.ALIASES.get(variant, variant)]
    got = fn(torch.from_numpy(feats)).numpy()
    assert got.shape == ref.shape == (2, 1500, jcfg.d_model)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)


@pytest.mark.parametrize("variant, target", [
    ("flat2d", "baseline"), ("unroll8", "baseline"), ("pallas", "baseline"), ("tbd_pallas", "tbd"),
])
def test_enc_exp_aliases_are_their_runs(capsys, variant, target):
    """An alias runs its target: the same --check record (flat2d, unroll8
    and pallas are baseline exactly)."""
    assert enc_exp.ALIASES[variant] == target
    argv = ["--check", "--dtype", "float32", "--batch", "1", "--preset", "test-tiny", "--device",
            "cpu"]
    got = enc_exp.main(["--variant", variant, *argv])
    want = enc_exp.main(["--variant", target, *argv])
    capsys.readouterr()
    assert {k: v for k, v in got.items() if k != "variant"} == {
        k: v for k, v in want.items() if k != "variant"}
    if target == "baseline":
        assert got["max_abs_diff"] == 0.0


def test_enc_exp_answers_every_jax_variant(enc_setup):
    mod = enc_setup[0]
    assert set(enc_exp.VARIANT_NAMES) == set(mod.VARIANTS)
    assert len(enc_exp.VARIANT_NAMES) == len(set(enc_exp.VARIANT_NAMES)) == 15


@pytest.mark.parametrize("variant", ["ab_gemmonly", "bf16out", "tbd"])
def test_enc_exp_check_runs(capsys, variant):
    rec = enc_exp.main(["--variant", variant, "--check", "--dtype", "float32", "--batch", "1",
                        "--preset", "test-tiny", "--device", "cpu"])
    assert _lines(capsys) == [rec]
    if variant == "bf16out":  # the port's dense already rounds before the bias
        assert rec["max_abs_diff"] == 0.0
    elif variant == "tbd":
        assert rec["max_abs_diff"] < 1e-5
    else:
        assert rec["rel_l2"] > 1e-3  # an ablation changes the output


# ---- dec_exp's loop against the public decode loop --------------------------

def _tiny_fused(dtype=torch.bfloat16, preset="test-tiny"):
    cfg = PRESETS[preset]
    model = whisper.init_params(cfg, torch.Generator().manual_seed(0), device="cpu", dtype=dtype)
    return (cfg, SpecialTokens.for_vocab(cfg.vocab_size), FeatureConfig(n_mels=cfg.num_mel_bins),
            fuse_for_inference(model))


def _reference_loop(model, enc, opts, st, n_steps):
    p = len(opts.prompt_ids)
    tokens = torch.zeros((enc.shape[0], opts.max_length), dtype=torch.long)
    tokens[:, :p] = torch.tensor(opts.prompt_ids)
    cache = whisper.init_cache(model, enc, opts.max_length, device="cpu")
    _, cache = whisper.decode(model, tokens[:, : p - 1], cache=cache, device="cpu")
    rc = opts.rule_config(st)
    for cur in range(p, p + n_steps):
        logits, cache = whisper.decode(model, tokens[:, cur - 1 : cur], cache=cache, device="cpu")
        tokens[:, cur] = torch.argmax(apply_rules(logits[:, 0].float(), tokens, cur, rc), -1)
    return tokens


@pytest.mark.parametrize("sources", [1500, 64], ids=["full", "cross_t64"])
def test_dec_exp_tokens_equal_decode_loop(sources):
    cfg, st, _, model = _tiny_fused(torch.float32)
    with torch.no_grad():
        for p in model.parameters():
            p.mul_(4.0)
    n_steps = 6
    enc = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (3, cfg.max_source_positions, cfg.d_model)).astype(np.float32))[:, :sources]
    opts = dec_exp.step_options(st, n_steps)
    tokens, cache = dec_exp.prefilled_cache(model, enc, opts, "compute")
    got = dec_exp.run_steps(model, tokens, cache, opts, st, n_steps)
    ref = _reference_loop(model, enc, opts, st, n_steps)
    torch.testing.assert_close(got, ref, rtol=0, atol=0)
    tokens, cache = dec_exp.prefilled_cache(model, enc, opts, "compute")
    no_head = dec_exp.run_steps(model, tokens, cache, opts, st, n_steps, head=False)
    p = len(opts.prompt_ids)
    assert (no_head[:, p : p + n_steps] == dec_exp.NO_HEAD_TOKEN).all()
    # the no_head run leaves the model's logits head as it was
    tokens, cache = dec_exp.prefilled_cache(model, enc, opts, "compute")
    torch.testing.assert_close(dec_exp.run_steps(model, tokens, cache, opts, st, n_steps), ref,
                               rtol=0, atol=0)


# ---- speed_decomp: both forms, one text -------------------------------------

def test_speed_decomp_split_equals_fused():
    from kotoba_whisper_tpu_torch.cli import common
    from kotoba_whisper_tpu_torch.eval.speed import generate_dummy_audio

    tok = common.load_tokenizer("byte")
    model, _ = common.load_model("preset:test-byte", torch.device("cpu"), torch.float32)
    with torch.no_grad():
        for p in model.parameters():
            p.mul_(4.0)
    d = speed_decomp.Decomp(fuse_for_inference(model), tok, max_length=24, kv_dtype="compute",
                            wire="float32")
    audio = generate_dummy_audio(40.0)
    phases = {}
    text = d.split(audio, phases)
    assert text == d.fused(audio, phases) and text
    assert set(phases) == {"host_chunk", "h2d", "mel", "decode", "d2h", "merge", "total_split",
                           "fused_total"}


# ---- stream_ab: both configs decode the same tokens -------------------------

def test_stream_ab_configs_give_the_same_tokens():
    cfg = PRESETS["test-byte"]
    model = whisper.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    with torch.no_grad():
        for p in model.parameters():
            p.mul_(4.0)
    st = SpecialTokens.layout(n_text=256, n_langs=99)
    feat = FeatureConfig(n_mels=cfg.num_mel_bins)
    audio, stops, opts = stream_ab.workload(6, st, feat, torch.device("cpu"))
    kw = dict(batch=4, kv_dtype="compute")
    rec_l, toks_l = stream_ab.lockstep_real(model, audio, stops, opts, st, feat, **kw)
    rec_s, toks_s = stream_ab.stream_real(model, audio, stops, opts, st, feat, **kw)
    assert toks_l.shape == toks_s.shape == (6, opts.max_length)
    for i in range(6):
        np.testing.assert_array_equal(toks_s[i], toks_l[i], err_msg=f"utterance {i}")
    assert rec_l["detail"]["batch_max"] == [int(stops[:4].max()), int(stops[4:].max())]
    assert rec_s["detail"]["trace"]["refills"] == 2


# ---- matmul_cal's chains ----------------------------------------------------

def test_matmul_cal_int8_chain_wraps_as_jax():
    x, w1, w2 = matmul_cal.make_operands(20, 16, torch.int8, torch.device("cpu"))
    got = matmul_cal.chain(x, w1, w2, 2).numpy()
    ref = x.numpy().astype(np.int64)
    for _ in range(2):  # s32 products wrapped to s8, as astype(int8) wraps
        ref = (ref @ w1.numpy().T.astype(np.int64)).astype(np.int32).astype(np.int8)
        ref = (ref.astype(np.int64) @ w2.numpy().T.astype(np.int64)).astype(np.int32)
        ref = ref.astype(np.int8).astype(np.int64)
    np.testing.assert_array_equal(got, ref.astype(np.int8))
