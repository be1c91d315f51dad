"""Port's stage 3 (WER filter + vectorize), merge and unified CLI vs the JAX
package's, on the CPU.

A synthetic WAV-in-tar dataset with transcripts (the shape of
tests/test_torch_pseudo_label.py's), pseudo-labels written as byte-token
ids (some equal to the transcript, some off by a word or wholly wrong,
some with timestamps, in two label columns): the port's data_filter must
write the JAX driver's filtered.jsonl exactly (the WER gate, the seeded
timestamp and previous-context sampling, the length filters) and its
features.npz within 1e-3 (one fp16 ulp in [1, 2); the port computes the
log-mel with its own frontend), with the WER gate on and off and with two
label columns. The metrics and normalizers equal the JAX package's on the
cases of tests/test_data_eval.py and tests/test_number_normalizer.py. The
port's merge_splits writes the JAX driver's splits. `python -m
kotoba_whisper_tpu_torch` lists the port's ten stages, refuses the JAX
package's others, chains pseudo-label -> filter -> merge ->
create-student -> distill, and runs each stage-6 stage (prepare-eval-set,
eval, speed, report) once at a tiny size.
"""
import json
import os
import struct
import sys

import numpy as np
import pytest
import torch

from kotoba_whisper_tpu.data import reazon
from kotoba_whisper_tpu.tokenizer.whisper_tokenizer import WhisperTokenizer as JaxTokenizer

N_UTTS = 10
# utterance i's pseudo-label text: the transcript, or off by one word, or
# another text altogether (WER 0, 1/3 and 1 against "utterance number i")
TEXTS = ["utterance number {i}", "utterance number {i}", "utterance numbr {i}",
         "something else entirely", "utterance number {i}"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny CPU tensors: one intra-op thread, so torch's thread pool does
    not spin-wait on cores the parallel test workers oversubscribe."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _wav_bytes(audio, sr=16000):
    pcm = (np.clip(audio, -1, 1) * 32767).astype("<i2").tobytes()
    return (
        struct.pack(
            "<4sI4s4sIHHIIHH4sI",
            b"RIFF", 36 + len(pcm), b"WAVE", b"fmt ", 16, 1, 1,
            sr, sr * 2, 2, 16, b"data", len(pcm),
        )
        + pcm
    )


@pytest.fixture(scope="module")
def dataset_dir(tmp_path_factory):
    rng = np.random.default_rng(0)
    d = tmp_path_factory.mktemp("reazon")
    utts = [(f"000/utt{i}.wav", _wav_bytes(rng.standard_normal(4000 * (1 + i % 3)) * 0.1))
            for i in range(N_UTTS)]
    reazon.write_tar_shard(str(d / "000.tar"), utts)
    (d / "transcript.tsv").write_text(
        "\n".join(f"000/utt{i}.wav\tutterance number {i}" for i in range(N_UTTS)),
        encoding="utf-8",
    )
    return str(d)


@pytest.fixture(scope="module")
def labels(dataset_dir, tmp_path_factory):
    """pseudo_labels.jsonl with two label columns: the transcribe column
    from TEXTS (timestamps on even utterances), the translate column the
    text reversed."""
    tok = JaxTokenizer.byte_vocab()
    st = tok.special
    rows = []
    for i in range(N_UTTS):
        text = TEXTS[i % len(TEXTS)].format(i=i)
        body = tok.encode(text)
        if i % 2 == 0:
            body = [st.timestamp_begin, *body, st.timestamp_begin + 40]
        ja = tok.sot_sequence("ja", "transcribe", timestamps=i % 2 == 0) + body + [st.eot]
        en = tok.sot_sequence("en", "translate", timestamps=False) + tok.encode(text[::-1]) + [
            st.eot]
        rows.append({"name": f"000/utt{i}.wav", "transcription": f"utterance number {i}",
                     "whisper_transcript": ja, "whisper_transcript/transcribe.ja": ja,
                     "whisper_transcript/translate.en": en})
    path = tmp_path_factory.mktemp("labels") / "pseudo_labels.jsonl"
    path.write_text("".join(json.dumps(r) + "\n" for r in rows), encoding="utf-8")
    return str(path)


FILTER_CASES = {
    "wer-gate": [],
    "skip-filtering-int16": ["--skip_filtering", "--wire_dtype", "int16", "--seed", "3"],
    "two-columns": ["--label_column",
                    "whisper_transcript/transcribe.ja,whisper_transcript/translate.en",
                    "--timestamp_probability", "0.5", "--condition_on_prev_probability", "0.6"],
}


@pytest.mark.parametrize("case", list(FILTER_CASES))
def test_filter_driver_matches_jax(dataset_dir, labels, tmp_path, case):
    from kotoba_whisper_tpu.cli import data_filter as jax_filter
    from kotoba_whisper_tpu_torch.cli import data_filter as port_filter

    base = ["--dataset_dir", dataset_dir, "--labels", labels, "--tokenizer", "byte",
            "--batch_size", "4", *FILTER_CASES[case]]
    jax_filter.main(base + ["--output_dir", str(tmp_path / "jax")])
    port_filter.main(base + ["--output_dir", str(tmp_path / "port"), "--device", "cpu"])
    ref = (tmp_path / "jax" / "filtered.jsonl").read_text(encoding="utf-8")
    got = (tmp_path / "port" / "filtered.jsonl").read_text(encoding="utf-8")
    assert got == ref
    kept = len(ref.splitlines())
    assert 0 < kept < N_UTTS if case != "skip-filtering-int16" else kept == N_UTTS
    ref_f = np.load(tmp_path / "jax" / "features.npz")["input_features"]
    got_f = np.load(tmp_path / "port" / "features.npz")["input_features"]
    assert got_f.dtype == ref_f.dtype == np.float16 and got_f.shape == ref_f.shape
    assert got_f.shape[0] == kept
    np.testing.assert_allclose(got_f.astype(np.float32), ref_f.astype(np.float32), rtol=0,
                               atol=1e-3)


# the metric cases of tests/test_data_eval.py and the normalizer inputs of
# tests/test_data_eval.py and tests/test_number_normalizer.py
METRIC_CASES = [
    (["a b c"], ["a b c"]), (["a x c"], ["a b c"]), ([""], ["a b"]),
    (["a x c", "d"], ["a b c", "d"]), (["abcd"], ["abxd"]), (["こんにちは"], ["こんばんは"]),
    (["the quick brown fox", "jumps over", "a dog"], ["the quick brown cat", "jumped over it",
                                                      "a dog"]),
]
TEXT_CASES = [
    "Hello, World!", "こんにちは。世界  (笑) [music]", "ÀÇÉ naïve café", "A  B\t C ",
    "「日本語」のテスト、です。", "MIXED case And 123 Numbers", "こんにちは。 世界", "a b c 日本",
    "I won't do it", "they're here",
    "He won't pay twenty dollars for the ticket!", "She was born in nineteen eighty four.",
    "Mr. Smith bought one hundred and twenty three apples", "I'd say it's fifty percent done",
    "The temperature dropped to minus five degrees",
    "They're selling it for three point one four", "It happened in the nineteen sixties",
    "The twenty-first century began",
]
NUMBER_CASES = [
    "one", "twelve", "twenty", "twenty one", "twenty-three", "one hundred",
    "one hundred and twenty three", "two hundred fifty six", "three thousand",
    "twelve thousand five hundred", "four million", "seven billion people",
    "three point one four", "zero point five", "ten percent", "fifty percent of the time",
    "twenty dollars", "fifty cents", "first", "second place", "the twentieth century",
    "twenty-first", "he was born in nineteen eighty four", "the year two thousand",
    "i have two apples and three oranges", "no numbers here at all", "123 already digits",
    "it costs five dollars", "sixties", "the nineteen sixties", "forty two", "ninety nine",
    "a thousand and one nights", "seven hundred and seventy seven", "oh seven",
    "double oh seven", "minus five degrees", "negative ten", "nineteen eighty four",
    "one two three", "point five", "one point five", "a hundred and one", "ones",
    "plain words stay put",
]


def test_metrics_match_jax():
    from kotoba_whisper_tpu.eval import metrics as jm
    from kotoba_whisper_tpu_torch.eval import metrics as tm

    for preds, refs in METRIC_CASES:
        assert tm.wer(preds, refs) == jm.wer(preds, refs), (preds, refs)
        assert tm.cer(preds, refs) == jm.cer(preds, refs), (preds, refs)


@pytest.mark.parametrize("lang", ["ja", "en", "de"])
def test_normalizers_match_jax(lang):
    from kotoba_whisper_tpu.eval import normalizers as jn
    from kotoba_whisper_tpu_torch.eval import normalizers as tn

    ref, got = jn.make_normalizer(lang), tn.make_normalizer(lang)
    for s in TEXT_CASES:
        assert got(s) == ref(s), s
    for s in TEXT_CASES:
        assert tn.BasicTextNormalizer(remove_diacritics=True)(s) == jn.BasicTextNormalizer(
            remove_diacritics=True)(s), s


def test_ja_and_en_normalizers_need_no_regex_module(monkeypatch):
    """The card's machine has no `regex` package: only BasicTextNormalizer's
    split_letters branch imports it."""
    from kotoba_whisper_tpu_torch.eval import normalizers as tn

    monkeypatch.setitem(sys.modules, "regex", None)
    assert tn.make_normalizer("ja")("こんにちは。 世界") == "こんにちは世界"
    assert tn.make_normalizer("en")("I won't do it") == "i will not do it"
    with pytest.raises(ImportError):
        tn.BasicTextNormalizer(split_letters=True)("abc")


def test_number_normalizer_matches_jax():
    from kotoba_whisper_tpu.eval.number_normalizer import EnglishNumberNormalizer as JaxNumbers
    from kotoba_whisper_tpu_torch.eval.number_normalizer import EnglishNumberNormalizer

    ref, got = JaxNumbers(), EnglishNumberNormalizer()
    for s in NUMBER_CASES:
        assert got(s) == ref(s), s


def _chunks(root, n):
    """n chunk dirs of the filter stage's layout (chunk_<i>/filtered), one
    of them labels only (a --skip_logmel run)."""
    rng = np.random.default_rng(5)
    for c in range(n):
        d = root / f"chunk_{c}" / "filtered"
        d.mkdir(parents=True)
        rows = [{"name": f"c{c}u{i}", "labels": [1, 2 + i, 3]} for i in range(3 + c)]
        (d / "filtered.jsonl").write_text("".join(json.dumps(r) + "\n" for r in rows))
        if c != n - 1:
            feats = rng.standard_normal((len(rows), 4, 6)).astype(np.float16)
            np.savez(d / "features.npz", input_features=feats)


@pytest.mark.parametrize("chunks_per_split", [1, 2])
def test_merge_driver_matches_jax(tmp_path, capsys, chunks_per_split):
    from kotoba_whisper_tpu.cli import merge_splits as jax_merge
    from kotoba_whisper_tpu_torch.cli import merge_splits as port_merge

    _chunks(tmp_path / "work", 3)
    outs = {}
    for name, driver in (("jax", jax_merge), ("port", port_merge)):
        capsys.readouterr()
        driver.main(["--work_dir", str(tmp_path / "work"), "--output_dir", str(tmp_path / name),
                     "--n_chunks", "3", "--chunks_per_split", str(chunks_per_split),
                     "--shard_size", "2"])
        outs[name] = json.loads(capsys.readouterr().out)
    assert outs["port"]["n_chunks"] == outs["jax"]["n_chunks"] == 3
    assert [os.path.basename(p) for p in outs["port"]["splits"]] == [
        os.path.basename(p) for p in outs["jax"]["splits"]]
    for split in (os.path.basename(p) for p in outs["jax"]["splits"]):
        ref_dir, got_dir = tmp_path / "jax" / split, tmp_path / "port" / split
        assert sorted(os.listdir(got_dir)) == sorted(os.listdir(ref_dir))
        for f in os.listdir(ref_dir):
            if f.endswith(".npy"):
                np.testing.assert_array_equal(np.load(got_dir / f), np.load(ref_dir / f))
            else:
                assert (got_dir / f).read_text() == (ref_dir / f).read_text(), f
    for name, driver in (("jax", jax_merge), ("port", port_merge)):
        driver.main(["--work_dir", str(tmp_path / "work"), "--output_dir", str(tmp_path / "s"),
                     "--n_chunks", "4", "--status"])
        outs[name] = capsys.readouterr().out
    assert outs["port"] == outs["jax"]
    with pytest.raises(SystemExit, match="chunks missing filter output"):
        port_merge.main(["--work_dir", str(tmp_path / "work"), "--output_dir",
                         str(tmp_path / "m"), "--n_chunks", "4"])


def test_cli_lists_the_port_stages(capsys):
    from kotoba_whisper_tpu_torch.__main__ import STAGES, main

    with pytest.raises(SystemExit) as e:
        main(["--help"])
    assert e.value.code == 0
    said = capsys.readouterr().out
    assert list(STAGES) == ["pseudo-label", "filter", "merge", "create-student", "distill",
                            "distill-bilingual", "eval", "speed", "report",
                            "prepare-eval-set", "parity-check"]
    for stage in STAGES:
        assert f"  {stage} " in said


@pytest.mark.parametrize("stage", ["parity-check"])
def test_cli_refuses_the_stages_not_ported(stage, capsys):
    """The last stage the port lacked is a stage now; only unknown names
    are refused."""
    from kotoba_whisper_tpu_torch.__main__ import main

    with pytest.raises(SystemExit) as e:
        main([stage, "--help"])
    assert e.value.code == 0 and "--checkpoint" in capsys.readouterr().out
    with pytest.raises(SystemExit, match="unknown stage"):
        main(["no-such-stage"])


@pytest.mark.parametrize("stage", ["prepare-eval-set", "eval", "speed", "report"])
def test_cli_runs_the_eval_stages(dataset_dir, tmp_path, capsys, stage):
    """Each stage-6 stage once through `python -m kotoba_whisper_tpu_torch`,
    the test-byte preset on the CPU."""
    from kotoba_whisper_tpu_torch.__main__ import main

    model = ["--model", "preset:test-byte", "--tokenizer", "byte", "--dtype", "float32",
             "--device", "cpu"]
    if stage == "prepare-eval-set":
        main([stage, "--input", dataset_dir, "--output_dir", str(tmp_path / "set"),
              "--shard_size", "4", "--limit", "5"])
        assert sorted(os.listdir(tmp_path / "set")) == ["000.tar", "001.tar", "transcript.tsv"]
        assert "wrote 5 utterances in 2 shard(s)" in capsys.readouterr().out
    elif stage == "eval":
        main([stage, *model, "--dataset_dir", dataset_dir, "--output_dir",
              str(tmp_path / "ev"), "--limit", "3"])
        record = json.loads((tmp_path / "ev" / "metric.ja.transcribe.jsonl").read_text())
        assert record["model"] == "preset:test-byte" and record["cer_norm"] >= 0
        assert len((tmp_path / "ev" / next(f for f in os.listdir(tmp_path / "ev")
                                           if f.startswith("model-"))).read_text(
            encoding="utf-8").splitlines()) == 4
    elif stage == "speed":
        main([stage, *model, "--durations", "1,2", "--n_trials", "1", "--max_length", "6",
              "--kv_dtype", "int8", "--wire_dtype", "int16",
              "--output", str(tmp_path / "runtime.jsonl")])
        rows = [json.loads(line)
                for line in (tmp_path / "runtime.jsonl").read_text().splitlines()]
        assert [r["duration"] for r in rows] == [1.0, 2.0]
        assert {(r["attention"], r["device"], r["wire_dtype"], r["kv_dtype"]) for r in rows} == {
            ("plain", "cpu", "int16", "int8")}
    else:
        (tmp_path / "m.jsonl").write_text(json.dumps(
            {"model": "m", "dataset": "d", "cer_norm": 1.25}) + "\n")
        main([stage, "--metric_jsonl", str(tmp_path / "m.jsonl")])
        assert capsys.readouterr().out.splitlines() == ["| model | d |", "|---|---|",
                                                        "| m | 1.2 |"]


def test_cli_chains_the_pipeline(dataset_dir, tmp_path, capsys):
    """pseudo-label -> filter (two chunks) -> merge -> create-student ->
    distill through `python -m kotoba_whisper_tpu_torch`, the test-byte
    preset on the CPU."""
    from kotoba_whisper_tpu_torch.__main__ import main

    work = tmp_path / "work"
    main(["pseudo-label", "--dataset_dir", dataset_dir, "--output_dir", str(tmp_path / "pl"),
          "--model", "preset:test-byte", "--tokenizer", "byte", "--batch_size", "4",
          "--max_label_length", "16", "--dtype", "float32", "--kv_dtype", "int8",
          "--streaming", "--num_beams", "2", "--device", "cpu"])
    labels = str(tmp_path / "pl" / "pseudo_labels.jsonl")
    for c in range(2):
        main(["filter", "--dataset_dir", dataset_dir, "--labels", labels, "--output_dir",
              str(work / f"chunk_{c}" / "filtered"), "--tokenizer", "byte", "--seed", str(c),
              "--skip_filtering", "--device", "cpu"])
    main(["merge", "--work_dir", str(work), "--output_dir", str(tmp_path / "merged"),
          "--n_chunks", "2", "--chunks_per_split", "2"])
    main(["create-student", "--teacher", "preset:test-byte", "--save_dir",
          str(tmp_path / "student"), "--decoder_layers", "1", "--dtype", "float32",
          "--device", "cpu"])
    main(["distill", "--train_splits", str(tmp_path / "merged"), "--student",
          str(tmp_path / "student"), "--teacher", "preset:test-byte", "--output_dir",
          str(tmp_path / "run"), "--per_device_train_batch_size", "4", "--max_steps", "2",
          "--max_label_length", "24", "--warmup_steps", "1", "--logging_steps", "1",
          "--save_steps", "100", "--dtype", "float32", "--no_prefetch", "--device", "cpu"])
    said = capsys.readouterr().out
    assert f"pseudo-labelled {N_UTTS} utterances" in said
    assert said.count(f"kept {N_UTTS}/{N_UTTS}") == 2
    merged = tmp_path / "merged" / "split_0"
    rows = [json.loads(line) for line in (merged / "filtered.jsonl").read_text().splitlines()]
    assert len(rows) == 2 * N_UTTS
    with open(tmp_path / "run" / "metrics.run.jsonl") as f:
        logged = [json.loads(line) for line in f]
    assert [r["step"] for r in logged] == [1, 2]
    assert all(np.isfinite(r["train/loss"]) for r in logged)
    assert (tmp_path / "run" / "final").is_dir()
