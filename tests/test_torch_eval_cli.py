"""Port's stage-6 evaluation against the JAX package's, on the CPU.

- eval_short_form: the JAX and the port driver on one exported checkpoint
  (test-byte widths, weights x4 so that the predictions follow the audio)
  and one tar+tsv eval set, fp32; the port's eval_diff --strict
  --tolerance 1e-6 passes between the two output directories, plain and
  with --stable_ts --punctuator; a second port run reads every prediction
  from its cache.
- eval_diff: fails on an injected prediction and metric change, passes on
  a fresh JAX golden run against tests/goldens/eval_pipeline.
- evaluate_speed's record: the JAX keys, with what ran ("plain", "cpu").
- report: pivot_table and runtime_pivot_table equal to the JAX package's
  on the same records; an int16-wire row stays a row of its own, where
  the JAX key lets it collide with the fp32-wire row.
- prepare_eval_set and iter_eval_set: manifest -> tar+tsv round trips equal
  to the JAX package's.
- the flags the port once refused (--corpus, a NeMo model, --cascaded_mt)
  now run, and fail as the JAX drivers fail on bad input.
"""
import csv
import json
import os
import shutil
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

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN_DIR = os.path.join(REPO, "tests", "goldens", "eval_pipeline")


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
    """Five utterances of 1-17 s (the last takes two chunks), tar + tsv."""
    rng = np.random.default_rng(3)
    d = tmp_path_factory.mktemp("eval_set")
    secs = [1.0, 2.5, 4.0, 6.0, 17.0]
    reazon.write_tar_shard(str(d / "000.tar"), [
        (f"000/u{i}.wav", wav_bytes(rng.standard_normal(int(16000 * s)) * 0.05 * (i + 1)))
        for i, s in enumerate(secs)])
    (d / "transcript.tsv").write_text(
        "\n".join(f"000/u{i}.wav\tテスト 発話 {i}" for i in range(len(secs))),
        encoding="utf-8")
    return str(d)


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    cfg = JAX_PRESETS["test-byte"]
    d = str(tmp_path_factory.mktemp("ckpt"))
    export_hf_model(d, jax.tree.map(lambda x: x * 4.0, jw.init_params(jax.random.key(1), cfg)),
                    cfg)
    return d


def _eval_args(checkpoint, eval_set, out, *extra):
    return ["--model", checkpoint, "--tokenizer", "byte", "--dataset_dir", eval_set,
            "--dataset_name", "synth", "--output_dir", out, "--dtype", "float32", *extra]


@pytest.fixture(scope="module")
def eval_runs(checkpoint, eval_set, tmp_path_factory):
    """{(driver, add-ons): output dir} for both drivers, plain and with
    --stable_ts --punctuator."""
    from kotoba_whisper_tpu.cli import eval_short_form as jax_eval
    from kotoba_whisper_tpu_torch.cli import eval_short_form as port_eval

    runs = {}
    for addons in ((), ("--stable_ts", "--punctuator")):
        for name, main, device in (("jax", jax_eval.main, ()),
                                   ("port", port_eval.main, ("--device", "cpu"))):
            out = str(tmp_path_factory.mktemp(f"{name}{len(addons)}"))
            main(_eval_args(checkpoint, eval_set, out, *addons, *device))
            runs[name, addons] = out
    return runs


def _port_eval_diff(ours, reference, *extra):
    from kotoba_whisper_tpu_torch.cli import eval_diff

    eval_diff.main(["--ours", ours, "--reference", reference, *extra])


@pytest.mark.parametrize("addons", [(), ("--stable_ts", "--punctuator")],
                         ids=["plain", "stable_ts-punctuator"])
def test_port_eval_matches_jax_eval(eval_runs, addons, capsys):
    ours, theirs = eval_runs["port", addons], eval_runs["jax", addons]
    assert sorted(os.listdir(ours)) == sorted(os.listdir(theirs))
    csvs = [f for f in os.listdir(ours) if f.startswith("model-")]
    assert len(csvs) == 1 and (f"stable-ts-{bool(addons) or None}" in csvs[0])
    capsys.readouterr()
    _port_eval_diff(ours, theirs, "--strict", "--tolerance", "1e-6")
    said = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert said[-1] == {"kind": "summary", "compared": 2, "failures": 0}
    with open(os.path.join(ours, csvs[0]), encoding="utf-8") as f:
        rows = list(csv.DictReader(f))
    assert len(rows) == 5 and len({r["prediction_raw"] for r in rows}) > 1
    if addons:  # the rule-based punctuator ends every non-empty chunk with 。
        assert all(r["prediction_raw"].endswith("。") for r in rows if r["prediction_raw"])


def test_a_second_port_eval_reads_its_cache(eval_runs, checkpoint, eval_set, tmp_path,
                                            monkeypatch):
    from kotoba_whisper_tpu_torch.cli import eval_short_form
    from kotoba_whisper_tpu_torch.decode.pipeline import AsrPipeline

    out = str(tmp_path / "again")
    shutil.copytree(eval_runs["port", ()], out)

    def no_decode(self, batch):
        raise AssertionError("a cached utterance was decoded again")

    monkeypatch.setattr(AsrPipeline, "_generate", no_decode)
    eval_short_form.main(_eval_args(checkpoint, eval_set, out, "--device", "cpu"))
    with open(os.path.join(out, "metric.ja.transcribe.jsonl")) as f:
        records = [json.loads(line) for line in f]
    assert len(records) == 2 and records[0] == records[1]
    _port_eval_diff(out, eval_runs["jax", ()], "--strict", "--tolerance", "1e-6")


def test_port_eval_diff_fails_on_a_changed_prediction_and_metric(eval_runs, tmp_path):
    broken = tmp_path / "broken"
    shutil.copytree(eval_runs["port", ()], broken)
    path = broken / next(f for f in os.listdir(broken) if f.startswith("model-"))
    with open(path, encoding="utf-8") as f:
        rows = list(csv.reader(f))
    rows[1][2] = rows[1][2] + "x"
    with open(path, "w", newline="", encoding="utf-8") as f:
        csv.writer(f).writerows(rows)
    with pytest.raises(SystemExit):
        _port_eval_diff(str(broken), eval_runs["jax", ()], "--strict", "--tolerance", "1e-6")
    shutil.copy(os.path.join(eval_runs["port", ()], path.name), path)
    jl = broken / "metric.ja.transcribe.jsonl"
    rec = json.loads(jl.read_text().splitlines()[-1])
    rec["cer_norm"] += 5.0
    jl.write_text(json.dumps(rec) + "\n", encoding="utf-8")
    with pytest.raises(SystemExit):
        _port_eval_diff(str(broken), eval_runs["jax", ()], "--tolerance", "1e-6")


def test_port_eval_diff_passes_a_fresh_jax_golden_run(tmp_path, capsys):
    sys.path.insert(0, REPO)
    from tools import make_eval_goldens

    ds = make_eval_goldens.make_dataset(str(tmp_path / "ds"))
    out = str(tmp_path / "eval_pipeline")
    make_eval_goldens.run_eval(ds, out)
    capsys.readouterr()
    _port_eval_diff(out, GOLDEN_DIR, "--strict", "--tolerance", "1e-6")
    said = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert said[-1] == {"kind": "summary", "compared": 2, "failures": 0}


def test_speed_record_schema(tmp_path):
    from kotoba_whisper_tpu.eval.speed import evaluate_speed as jax_speed
    from kotoba_whisper_tpu_torch.eval.speed import evaluate_speed, generate_dummy_audio

    seen = []
    kw = dict(model_name="m", durations=[1.0, 2.0], n_trials=2, n_warmup=1,
              extra={"max_length": 32, "wire_dtype": "int16"})
    got = evaluate_speed(lambda a: seen.append(a.copy()) or "x",
                         output_path=str(tmp_path / "port.jsonl"), device="cpu", **kw)
    ref = jax_speed(lambda a: "x", output_path=str(tmp_path / "jax.jsonl"), **kw)
    assert [list(r) for r in got] == [list(r) for r in ref]
    with open(tmp_path / "port.jsonl") as f:
        assert [json.loads(line) for line in f] == got
    for r in got:
        assert (r["attention"], r["device"], r["trials"]) == ("plain", "cpu", 2)
        assert r["mean"] == r["time (mean)"] and len(r["time (all)"]) == 2
    assert len(seen) == 6  # (1 warm-up + 2 trials) x 2 durations
    np.testing.assert_array_equal(seen[0], generate_dummy_audio(1.0))
    assert len(seen[3]) == 32000


def test_speed_runs_with_int4_kv(checkpoint, tmp_path, capsys):
    """eval_speed --kv_dtype int4 runs and records its KV dtype."""
    from kotoba_whisper_tpu_torch.cli import eval_speed

    out = tmp_path / "runtime.jsonl"
    eval_speed.main(["--model", checkpoint, "--kv_dtype", "int4", "--dtype", "float32",
                     "--durations", "2", "--n_trials", "1", "--max_length", "6",
                     "--output", str(out), "--device", "cpu"])
    with open(out) as f:
        records = [json.loads(line) for line in f]
    assert [(r["kv_dtype"], r["trials"], r["device"]) for r in records] == [("int4", 1, "cpu")]


RECORDS = [
    {"model": "a", "dataset": "jsut", "cer_norm": 9.87, "wer_norm": 12.0},
    {"model": "a", "dataset": "cv8", "cer_norm": 11.1},
    {"model": "b", "dataset": "jsut", "cer_norm": 7.25},
    {"model": "b", "dataset": "jsut", "cer_norm": 7.5},
]
RUNTIME = [
    {"model": "m", "duration": 10, "time (mean)": 0.5, "gemm_dtype": "compute",
     "kv_dtype": "compute"},
    {"model": "m", "duration": 300, "mean": 2.25, "gemm_dtype": "int8", "kv_dtype": "int8"},
    {"model": "m", "duration": 10, "time (mean)": 0.4, "gemm_dtype": "int8",
     "kv_dtype": "int8"},
    {"model": "n", "duration": 30.0, "time (mean)": 1.0},
    {"model": "n", "duration": 30.0, "time (mean)": 1.5},  # a true duplicate
]


def test_report_tables_match_jax(tmp_path, capsys):
    from kotoba_whisper_tpu.eval import report as jax_report
    from kotoba_whisper_tpu_torch.eval import report

    for metric in ("cer_norm", "wer_norm", "missing"):
        assert report.pivot_table(RECORDS, metric) == jax_report.pivot_table(RECORDS, metric)
    assert report.runtime_pivot_table(RUNTIME) == jax_report.runtime_pivot_table(RUNTIME)
    assert report.runtime_pivot_table([]) == "(no records)"
    for name, rows in (("metric.jsonl", RECORDS), ("runtime.jsonl", RUNTIME)):
        (tmp_path / name).write_text("".join(json.dumps(r) + "\n" for r in rows))
    for argv in (["--metric_jsonl", str(tmp_path / "metric.jsonl")],
                 ["--metric_jsonl", str(tmp_path / "runtime.jsonl"), "--runtime"]):
        capsys.readouterr()
        report.main(argv)
        got = capsys.readouterr()
        jax_report.main(argv)
        assert got == capsys.readouterr()


def test_runtime_pivot_keeps_the_int16_wire_row_apart():
    """The JAX key leaves the wire out, so its int16-wire row overwrites
    the fp32-wire cell; the port's tags it."""
    from kotoba_whisper_tpu.eval import report as jax_report
    from kotoba_whisper_tpu_torch.eval import report

    rows = [{"model": "m", "duration": 10, "time (mean)": 0.5, "gemm_dtype": "int8",
             "kv_dtype": "int8"},
            {"model": "m", "duration": 10, "time (mean)": 0.25, "gemm_dtype": "int8",
             "kv_dtype": "int8", "wire_dtype": "int16"}]
    got, ref = report.runtime_pivot_table(rows), jax_report.runtime_pivot_table(rows)
    assert "| m [gemm=int8, kv=int8] | 0.500 |" in got
    assert "| m [gemm=int8, kv=int8, wire=int16] | 0.250 |" in got
    assert len(got.splitlines()) == 4
    assert len(ref.splitlines()) == 3 and "| m [gemm=int8, kv=int8] | 0.250 |" in ref


def test_prepare_eval_set_round_trip_matches_jax(tmp_path):
    from kotoba_whisper_tpu.cli import prepare_eval_set as jax_prepare
    from kotoba_whisper_tpu.data.eval_sets import iter_eval_set as jax_iter
    from kotoba_whisper_tpu_torch.cli import prepare_eval_set
    from kotoba_whisper_tpu_torch.data.eval_sets import iter_eval_set

    rng = np.random.default_rng(5)
    src = tmp_path / "src"
    src.mkdir()
    rows = []
    for i in range(5):
        (src / f"u{i}.wav").write_bytes(wav_bytes(rng.standard_normal(800 + 160 * i) * 0.1))
        rows.append({"audio": f"u{i}.wav", "text": f"utterance\t{i}", "id": f"id{i}"})
    (src / "manifest.jsonl").write_text("\n".join(json.dumps(r) for r in rows))

    def same(got, ref):
        assert len(got) == len(ref)
        for g, r in zip(got, ref):
            assert (g.text, g.audio_id) == (r.text, r.audio_id)
            np.testing.assert_array_equal(g.audio, r.audio)

    same(list(iter_eval_set(str(src), limit=4)), list(jax_iter(str(src), limit=4)))
    for name, prepare in (("port", prepare_eval_set.main), ("jax", jax_prepare.main)):
        prepare(["--input", str(src), "--output_dir", str(tmp_path / name),
                 "--shard_size", "2"])
    port_dir, jax_dir = tmp_path / "port", tmp_path / "jax"
    assert sorted(os.listdir(port_dir)) == sorted(os.listdir(jax_dir)) == [
        "000.tar", "001.tar", "002.tar", "transcript.tsv"]
    for f in os.listdir(jax_dir):
        assert (port_dir / f).read_bytes() == (jax_dir / f).read_bytes(), f
    back = list(iter_eval_set(str(port_dir)))
    same(back, list(jax_iter(str(jax_dir))))
    assert [b.text for b in back] == [f"utterance {i}" for i in range(5)]
    with pytest.raises(ValueError, match="unrecognized eval-set layout"):
        list(iter_eval_set(str(tmp_path)))


def test_what_is_not_ported_raises(checkpoint, eval_set, tmp_path):
    """Nothing of these drivers is left unported: --corpus, a NeMo model
    and --cascaded_mt run (tests/test_torch_esb.py, test_torch_cascaded.py)
    and raise as the JAX drivers raise: an unknown corpus, a NeMo model
    without the reazonspeech package, an MT dir without a checkpoint."""
    from kotoba_whisper_tpu_torch.cli import eval_short_form, prepare_eval_set

    with pytest.raises(ValueError, match="unknown ESB corpus"):
        prepare_eval_set.main(["--input", str(tmp_path), "--output_dir", str(tmp_path),
                               "--corpus", "switchboard"])
    with pytest.raises(ImportError, match="reazonspeech"):
        eval_short_form.main(["--model", "reazon-research/reazonspeech-nemo-v2",
                              "--dataset_dir", eval_set, "--device", "cpu"])
    with pytest.raises(FileNotFoundError, match="config.json"):
        eval_short_form.main(_eval_args(checkpoint, eval_set, str(tmp_path),
                                        "--cascaded_mt", str(tmp_path), "--device", "cpu"))
