"""The port's cascaded ASR -> MT evaluation and NeMo baseline branch against
the JAX package's drivers, on the CPU.

- `eval_short_form --cascaded_mt`: a tiny Whisper checkpoint (test-byte
  widths, weights x4, exported by the JAX package) and a tiny NLLB
  checkpoint the test writes (config.json, pytorch_model.bin from the
  port's random init, a hand-written unigram tokenizer.json with the
  language codes as added tokens); both drivers write
  metric.ja.translate.jsonl with the same keys and the same per-utterance
  translations (the port's eval_diff --strict --tolerance 1e-6).
- `make_nllb_translate_fn` buckets the source as the JAX package does
  and gives its strings; `CascadedS2TPipeline` keeps the ASR text.
- A NeMo model spec goes to the reazonspeech package (the stub of
  tests/test_report_addons.py) in both drivers, with the same predictions
  and no Whisper pipeline; the ja-transcribe guard holds in the port.
"""
from __future__ import annotations

import csv
import json
import os
import sys

import jax
import numpy as np
import pytest
import torch

from kotoba_whisper_tpu.core.config import PRESETS as JAX_PRESETS
from kotoba_whisper_tpu.data import reazon
from kotoba_whisper_tpu.models import whisper as jw
from kotoba_whisper_tpu.train.checkpoint import export_hf_model
from kotoba_whisper_tpu_torch.data.reazon import wav_bytes
from kotoba_whisper_tpu_torch.models import text_seq2seq as ts

NLLB = dict(vocab_size=64, d_model=32, encoder_layers=2, decoder_layers=2,
            encoder_attention_heads=4, decoder_attention_heads=4, encoder_ffn_dim=64,
            decoder_ffn_dim=64, max_position_embeddings=512)
PIECES = ["▁", "▁a", "b", "c", "▁t", "e", "s", "t", "▁o", "k"] + [f"▁w{i}" for i in range(20)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny CPU tensors: one intra-op thread, so torch's thread pool does
    not spin-wait on cores the parallel test workers oversubscribe."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def eval_set(tmp_path_factory):
    """Three utterances of 1-3 s, tar + tsv."""
    rng = np.random.default_rng(4)
    d = tmp_path_factory.mktemp("eval_set")
    reazon.write_tar_shard(str(d / "000.tar"), [
        (f"000/u{i}.wav", wav_bytes(rng.standard_normal(16000 * (i + 1)) * 0.05 * (i + 1)))
        for i in range(3)])
    (d / "transcript.tsv").write_text(
        "\n".join(f"000/u{i}.wav\ttest ok {i}" for i in range(3)), encoding="utf-8")
    return str(d)


@pytest.fixture(scope="module")
def whisper_ckpt(tmp_path_factory):
    cfg = JAX_PRESETS["test-byte"]
    d = str(tmp_path_factory.mktemp("whisper"))
    export_hf_model(d, jax.tree.map(lambda x: x * 4.0, jw.init_params(jax.random.key(1), cfg)),
                    cfg)
    return d


def write_nllb_checkpoint(d: str, cfg: ts.TextSeq2SeqConfig, seed: int = 0) -> None:
    """config.json, pytorch_model.bin (HF key names) and a unigram
    tokenizer.json: <s> <pad> </s> <unk> and PIECES, the language codes as
    added tokens."""
    model = ts.init_params(cfg, torch.Generator().manual_seed(seed))
    with torch.no_grad():  # non-zero biases, so a dropped one shows
        for name, p in model.named_parameters():
            if name.endswith("bias"):
                p.normal_(0.0, 0.05, generator=torch.Generator().manual_seed(len(name)))
    sd = {f"model.{k}": v for k, v in model.model.state_dict().items()}
    torch.save(sd | {"lm_head.weight": sd["model.shared.weight"].clone()},
               os.path.join(d, "pytorch_model.bin"))
    with open(os.path.join(d, "config.json"), "w") as f:
        json.dump({"model_type": "m2m_100", "pad_token_id": 1, "eos_token_id": 2,
                   "decoder_start_token_id": 2, "scale_embedding": True,
                   **{k: getattr(cfg, k) for k in NLLB}}, f)
    vocab = [["<s>", 0.0], ["<pad>", 0.0], ["</s>", 0.0], ["<unk>", 0.0]] + [
        [p, -2.0 - 0.1 * i] for i, p in enumerate(PIECES)]
    added = [{"id": len(vocab) + i, "content": c, "special": True}
             for i, c in enumerate(("jpn_Jpan", "eng_Latn"))]
    with open(os.path.join(d, "tokenizer.json"), "w", encoding="utf-8") as f:
        json.dump({"added_tokens": added, "normalizer": {"type": "NFKC"},
                   "model": {"type": "Unigram", "unk_id": 3, "vocab": vocab}}, f,
                  ensure_ascii=False)


@pytest.fixture(scope="module")
def nllb_ckpt(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("nllb"))
    write_nllb_checkpoint(d, ts.TextSeq2SeqConfig(**NLLB))
    return d


def test_translate_fn_matches_jax(nllb_ckpt):
    from kotoba_whisper_tpu.eval.cascaded_s2t import make_nllb_translate_fn as jax_fn
    from kotoba_whisper_tpu_torch.eval.cascaded_s2t import make_nllb_translate_fn, source_ids

    ours = make_nllb_translate_fn(nllb_ckpt, max_length=20, device="cpu")
    ref = jax_fn(nllb_ckpt, max_length=20)
    for text in ("a test", "ok", "t" * 40, "", "未知の文字"):
        assert ours(text) == ref(text), repr(text)
    assert source_ids([5] * 17, 1).shape == (1, 32)
    assert source_ids([5] * 3, 1).tolist() == [[5, 5, 5] + [1] * 13]


def test_cascaded_pipeline_keeps_the_source_text():
    from kotoba_whisper_tpu_torch.eval.cascaded_s2t import CascadedS2TPipeline

    class FakeAsr:
        def __call__(self, audio):
            return {"text": "こんにちは", "chunks": []}

    out = CascadedS2TPipeline(asr=FakeAsr(), translate_fn=lambda s: f"<en>{s}</en>")(
        np.zeros(16000, np.float32))
    assert out == {"text": "<en>こんにちは</en>", "source_text": "こんにちは", "chunks": [],
                   "source_lang": "ja", "target_lang": "en"}


def _eval_args(model, eval_set, out, *extra):
    return ["--model", model, "--tokenizer", "byte", "--dataset_dir", eval_set,
            "--dataset_name", "synth", "--output_dir", out, "--dtype", "float32", *extra]


def _predictions(out):
    (name,) = [f for f in os.listdir(out) if f.startswith("model-")]
    with open(os.path.join(out, name), encoding="utf-8") as f:
        return [r["prediction_raw"] for r in csv.DictReader(f)]


def test_cascaded_eval_matches_jax(whisper_ckpt, nllb_ckpt, eval_set, tmp_path, capsys):
    from kotoba_whisper_tpu.cli import eval_short_form as jax_eval
    from kotoba_whisper_tpu_torch.cli import eval_diff
    from kotoba_whisper_tpu_torch.cli import eval_short_form as port_eval

    mt = ["--cascaded_mt", nllb_ckpt, "--mt_src_lang", "jpn_Jpan", "--mt_tgt_lang", "eng_Latn"]
    jax_out, port_out = str(tmp_path / "jax"), str(tmp_path / "port")
    jax_eval.main(_eval_args(whisper_ckpt, eval_set, jax_out, *mt))
    port_eval.main(_eval_args(whisper_ckpt, eval_set, port_out, *mt, "--device", "cpu"))
    assert sorted(os.listdir(port_out)) == sorted(os.listdir(jax_out))
    assert "metric.ja.translate.jsonl" in os.listdir(port_out)
    records = {}
    for name, out in (("port", port_out), ("jax", jax_out)):
        with open(os.path.join(out, "metric.ja.translate.jsonl")) as f:
            records[name] = [json.loads(line) for line in f]
    assert [sorted(r) for r in records["port"]] == [sorted(r) for r in records["jax"]]
    preds = _predictions(port_out)
    assert preds == _predictions(jax_out) and len(preds) == 3 and any(preds)
    capsys.readouterr()
    eval_diff.main(["--ours", port_out, "--reference", jax_out, "--strict",
                    "--tolerance", "1e-6"])
    said = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert said[-1] == {"kind": "summary", "compared": 2, "failures": 0}


def test_nemo_branch_matches_jax(eval_set, tmp_path, monkeypatch):
    from test_report_addons import _stub_reazonspeech

    from kotoba_whisper_tpu.cli import eval_short_form as jax_eval
    from kotoba_whisper_tpu_torch.cli import eval_short_form as port_eval
    from kotoba_whisper_tpu_torch.decode.pipeline import AsrPipeline
    from kotoba_whisper_tpu_torch.eval.nemo_baseline import is_nemo_model, \
        make_nemo_transcribe_fn

    def no_pipeline(*a, **k):
        raise AssertionError("the NeMo branch built a Whisper pipeline")

    monkeypatch.setattr(AsrPipeline, "__init__", no_pipeline)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)  # no device is asked for
    assert is_nemo_model("nemo-v2") and not is_nemo_model("preset:test-byte")
    outs, calls = {}, {}
    for name, main in (("jax", jax_eval.main), ("port", port_eval.main)):
        calls[name] = {}
        names = _stub_reazonspeech(calls[name])
        try:
            outs[name] = str(tmp_path / name)
            main(["--model", "reazon-research/reazonspeech-nemo-v2", "--dataset_dir", eval_set,
                  "--output_dir", outs[name]])
        finally:
            for n in names:
                del sys.modules[n]
    assert calls["port"] == calls["jax"] and calls["port"]["loaded"] == 1
    assert _predictions(outs["port"]) == _predictions(outs["jax"]) == [
        f"nemo transcript {i}" for i in (1, 2, 3)]
    with pytest.raises(ValueError, match="task=transcribe language=ja"):
        make_nemo_transcribe_fn(task="translate")
