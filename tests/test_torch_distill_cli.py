"""The port's create_student and distill drivers vs the JAX drivers, fp32 on
the CPU.

One tiny teacher with head dim 64 (d_model 128, 2 heads, 2+4 layers) from
the JAX `init_params`, exported in HF layout by the JAX package; one
synthetic feature split of 8 utterances written with the port's
`ShardWriter` (the layout both packages read). Both create_student drivers
run on that teacher, both distill drivers on their students and that split.
The shard layout and `append_jsonl` are also held to the JAX package's.

Tolerances: the student exports are identical (a copy of teacher layers);
logged losses, grad norm and learning rate rtol 1e-5 + atol 1e-6 and
parameters after three AdamW steps at lr 1e-3 atol 1e-2 x lr, as
tests/test_torch_distill.py states them; a resumed run equals an
uninterrupted one exactly (same CPU kernels, same order of sums).
"""
import json
import os

import jax
import numpy as np
import pytest
import torch

from kotoba_whisper_tpu.core.config import WhisperConfig as JaxConfig
from kotoba_whisper_tpu.models import whisper as jw
from kotoba_whisper_tpu.train import checkpoint as jckpt
from kotoba_whisper_tpu_torch.cli import create_student as port_create
from kotoba_whisper_tpu_torch.cli import distill as port_distill
from kotoba_whisper_tpu_torch.core.config import WhisperConfig
from kotoba_whisper_tpu_torch.data.shards import ShardWriter
from kotoba_whisper_tpu_torch.models.convert import params_from_jax
from kotoba_whisper_tpu_torch.train.checkpoint import import_hf_model

TINY = dict(
    vocab_size=300, num_mel_bins=16, d_model=128, encoder_layers=2,
    encoder_attention_heads=2, decoder_layers=4, decoder_attention_heads=2,
    encoder_ffn_dim=192, decoder_ffn_dim=192, max_source_positions=24,
    max_target_positions=32, pad_token_id=0, bos_token_id=1, eos_token_id=1,
    decoder_start_token_id=2,
)
LOSS_TOL = dict(rtol=1e-5, atol=1e-6)
LR = 1e-3
METRICS = ("loss", "ce_loss", "kl_loss", "grad_norm", "learning_rate")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny CPU tensors: one intra-op thread, so torch's thread pool does
    not spin-wait on cores the parallel test workers oversubscribe."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def teacher_dir(tmp_path_factory):
    cfg = JaxConfig(**TINY)
    d = str(tmp_path_factory.mktemp("teacher"))
    jckpt.export_hf_model(d, jw.init_params(jax.random.key(0), cfg), cfg)
    return d


@pytest.fixture(scope="module")
def split_dir(tmp_path_factory):
    """8 utterances: random features, label sequences <|sot|> ... eot of
    3-9 tokens, so the -100 tails differ between rows."""
    d = str(tmp_path_factory.mktemp("split"))
    rng = np.random.default_rng(7)
    w = ShardWriter(d, shard_size=3)
    for i in range(8):
        n = int(rng.integers(3, 10))
        labels = [2, *rng.integers(3, TINY["vocab_size"], n).tolist(), 1]
        feats = rng.standard_normal((TINY["num_mel_bins"], 2 * TINY["max_source_positions"]))
        w.add({"name": f"utt{i}", "labels": labels}, feats.astype(np.float32))
    w.close()
    return d


def test_shards_and_jsonl_match_jax(tmp_path):
    """Either package reads the other's splits (`add_batch` into shards of
    3), with the same rows and features, and resolves the same split dirs;
    `append_jsonl` writes the same lines."""
    from kotoba_whisper_tpu.data import shards as jshards
    from kotoba_whisper_tpu.train.logging import append_jsonl as jax_append
    from kotoba_whisper_tpu_torch.data import shards as tshards
    from kotoba_whisper_tpu_torch.train.logging import append_jsonl

    rng = np.random.default_rng(3)
    rows = [{"name": f"u{i}", "labels": [2, i, 1]} for i in range(7)]
    feats = rng.standard_normal((7, 4, 6)).astype(np.float32)
    for writer, name in ((jshards.ShardWriter, "jax"), (tshards.ShardWriter, "port")):
        w = writer(str(tmp_path / name), shard_size=3)
        w.add_batch(rows, feats)
        w.close()
    idx = np.array([6, 0, 4, 3])
    for name in ("jax", "port"):
        for store in (jshards.FeatureStore, tshards.FeatureStore):
            s = store(str(tmp_path / name))
            assert s.rows == rows
            np.testing.assert_array_equal(s.gather(idx), feats[idx].astype(np.float16))
    assert tshards.resolve_split_dirs(str(tmp_path)) == jshards.resolve_split_dirs(str(tmp_path))
    for fn, name in ((jax_append, "a.jsonl"), (append_jsonl, "b.jsonl")):
        fn(str(tmp_path / name), {"wer": 0.5, "text": "こんにちは"})
    assert (tmp_path / "a.jsonl").read_text() == (tmp_path / "b.jsonl").read_text()


@pytest.fixture(scope="module")
def students(teacher_dir, tmp_path_factory):
    from kotoba_whisper_tpu.cli import create_student as jax_create

    root = tmp_path_factory.mktemp("students")
    jax_create.main(["--teacher", teacher_dir, "--save_dir", str(root / "jax"),
                     "--decoder_layers", "2"])
    port_create.main(["--teacher", teacher_dir, "--save_dir", str(root / "port"),
                      "--decoder_layers", "2", "--dtype", "float32", "--device", "cpu"])
    return str(root / "jax"), str(root / "port")


def _distill_args(split_dir, student, teacher_dir, out, max_steps):
    return [
        "--data_dir", split_dir, "--student", student, "--teacher", teacher_dir,
        "--output_dir", out, "--per_device_train_batch_size", "2",
        "--max_steps", str(max_steps), "--max_label_length", "12",
        "--learning_rate", str(LR), "--warmup_steps", "1", "--logging_steps", "1",
        "--save_steps", "100", "--dtype", "float32", "--num_train_epochs", "2",
        "--no_prefetch",
    ]


def _metrics(out):
    with open(os.path.join(out, "metrics.run.jsonl")) as f:
        return [json.loads(line) for line in f]


def _jax_state_dict(path):
    params, cfg = jckpt.import_hf_model(path)
    return params_from_jax(jax.tree.map(np.asarray, params), WhisperConfig(**TINY).replace(
        encoder_layers=cfg.encoder_layers, decoder_layers=cfg.decoder_layers)).state_dict()


def test_create_student_matches_jax(students):
    """The port's student export equals the JAX driver's, and loads in the
    JAX package's import_hf_model to the same parameters."""
    jax_dir, port_dir = students
    ref, _ = import_hf_model(jax_dir)
    got, cfg = import_hf_model(port_dir)
    assert (cfg.encoder_layers, cfg.decoder_layers) == (2, 2)
    ref_sd, got_sd = ref.state_dict(), got.state_dict()
    assert set(got_sd) == set(ref_sd)
    for name in got_sd:
        torch.testing.assert_close(got_sd[name], ref_sd[name], rtol=0, atol=0, msg=name)
    via_jax = _jax_state_dict(port_dir)
    for name in got_sd:
        torch.testing.assert_close(via_jax[name], got_sd[name], rtol=0, atol=0, msg=name)


def test_distill_driver_matches_jax(students, teacher_dir, split_dir, tmp_path):
    """Three steps of both drivers: every logged metric, and the exported
    students (the port's read back by the JAX package's import_hf_model)."""
    from kotoba_whisper_tpu.cli import distill as jax_distill

    jax_dir, port_dir = students
    jax_distill.main(_distill_args(split_dir, jax_dir, teacher_dir, str(tmp_path / "jax"), 3)
                     + ["--num_devices", "1"])
    port_distill.main(_distill_args(split_dir, port_dir, teacher_dir, str(tmp_path / "port"), 3)
                      + ["--device", "cpu"])
    ref, got = _metrics(tmp_path / "jax"), _metrics(tmp_path / "port")
    assert [r["step"] for r in got] == [r["step"] for r in ref] == [1, 2, 3]
    for r, g in zip(ref, got):
        for key in METRICS:
            np.testing.assert_allclose(g[f"train/{key}"], r[f"train/{key}"], **LOSS_TOL,
                                       err_msg=f"step {g['step']} {key}")
    want = _jax_state_dict(str(tmp_path / "jax" / "final"))
    have = _jax_state_dict(str(tmp_path / "port" / "final"))
    for name, p in have.items():
        torch.testing.assert_close(p, want[name], atol=1e-2 * LR, rtol=0, msg=name)


def test_distill_resume_equals_uninterrupted(students, teacher_dir, split_dir, tmp_path):
    """2 steps, save, then a second invocation resumes to step 3: the same
    metrics and the same final student as 3 steps in one run."""
    _, port_dir = students
    whole, split = str(tmp_path / "whole"), str(tmp_path / "split")
    port_distill.main(_distill_args(split_dir, port_dir, teacher_dir, whole, 3) + ["--device", "cpu"])
    port_distill.main(_distill_args(split_dir, port_dir, teacher_dir, split, 2) + ["--device", "cpu"])
    assert os.path.isdir(os.path.join(split, "checkpoint-2-epoch-0"))
    port_distill.main(_distill_args(split_dir, port_dir, teacher_dir, split, 3) + ["--device", "cpu"])
    assert sorted(os.listdir(split)) == ["checkpoint-3-epoch-0", "final", "metrics.run.jsonl"]
    ref, got = _metrics(whole), _metrics(split)
    assert [r["step"] for r in got] == [1, 2, 3]
    for r, g in zip(ref, got):
        for key in METRICS:
            assert g[f"train/{key}"] == r[f"train/{key}"], (g["step"], key)
    a, _ = import_hf_model(os.path.join(whole, "final"))
    b, _ = import_hf_model(os.path.join(split, "final"))
    for (name, p), q in zip(a.state_dict().items(), b.state_dict().values()):
        torch.testing.assert_close(q, p, rtol=0, atol=0, msg=name)


@pytest.mark.parametrize("flags, what", [
    (["--wandb_project", "p"], "--wandb_project"),
])
def test_distill_unported_flags_raise(students, teacher_dir, split_dir, tmp_path, monkeypatch,
                                      flags, what):
    """The flags that once refused now run: --wandb_project starts a wandb
    run (a stub module here) with the project, mirrors every JSONL record
    to it and finishes it at the end."""
    import sys
    import types

    calls = []

    class Run:
        def log(self, record, step=None):
            calls.append(("log", step))

        def finish(self):
            calls.append(("finish",))

    def init(**kw):
        calls.append(("init", kw))
        return Run()

    monkeypatch.setitem(sys.modules, "wandb", types.SimpleNamespace(init=init))
    monkeypatch.delenv("WANDB_DISABLED", raising=False)
    _, port_dir = students
    out = str(tmp_path)
    port_distill.main(_distill_args(split_dir, port_dir, teacher_dir, out, 1)
                      + ["--device", "cpu", *flags])
    logged = [r["step"] for r in _metrics(out)]
    assert what == "--wandb_project" and logged
    assert calls == [("init", {"project": "p", "name": "run"}),
                     *(("log", s) for s in logged), ("finish",)]


def test_float32_on_the_card_is_not_ported(students, teacher_dir, split_dir, tmp_path,
                                           monkeypatch):
    """--dtype float32 trains on the card through K5's fp32 form (the CLI
    tests above run it on the CPU): on a CUDA device the driver gets past
    its checks and reads the split, and stops at loading the models (a
    stub; no card needed)."""
    from kotoba_whisper_tpu_torch.cli import common

    _, port_dir = students
    args = port_distill._parser().parse_args(
        _distill_args(split_dir, port_dir, teacher_dir, str(tmp_path), 1))
    assert args.dtype == "float32"

    class Reached(Exception):
        pass

    def load_model(spec, dev, dtype, **kw):
        assert (dev.type, dtype) == ("cuda", torch.float32)
        raise Reached

    monkeypatch.setattr(common, "load_model", load_model)
    with pytest.raises(Reached):
        port_distill._run(args, torch.device("cuda"))


def test_drivers_raise_without_a_card(students, teacher_dir, split_dir, tmp_path, monkeypatch):
    """Both drivers default to the card; with none they raise rather than
    move to the CPU."""
    _, port_dir = students
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_distill.main(_distill_args(split_dir, port_dir, teacher_dir, str(tmp_path / "d"), 1))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_create.main(["--teacher", teacher_dir, "--save_dir", str(tmp_path / "s")])
