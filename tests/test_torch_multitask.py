"""The port's bilingual / multi-task distillation vs the JAX package's,
fp32 on the CPU.

The tiny teacher of tests/test_torch_distill.py (head dim 64, perturbed
biases and LayerNorm terms) from the JAX `init_params`, bridged by
`params_from_jax`; the student keeps two decoder layers. Two datasets are
zipped a step: one with two task keys and KL, one with one key and no KL.
`multitask_loss` and every per-task metric must match the JAX function
within 1e-5 (rtol, atol 1e-6), with the teacher encoder shared and with
its own pass, and its gradients within the distill tests' tolerance;
three train steps must log the JAX step's metrics; `python -m
kotoba_whisper_tpu_torch distill-bilingual` runs both drivers' data
layout end to end and exports an HF checkpoint that the JAX package's
importer reads, with the metrics and weights of the JAX driver.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kotoba_whisper_tpu.core.config import WhisperConfig as JaxConfig
from kotoba_whisper_tpu.models import student_init as jsi
from kotoba_whisper_tpu.models import whisper as jw
from kotoba_whisper_tpu.train import checkpoint as jckpt
from kotoba_whisper_tpu.train import distill as jd
from kotoba_whisper_tpu.train import distill_multitask as jmt
from kotoba_whisper_tpu.train import optim as jo
from kotoba_whisper_tpu_torch.core.config import WhisperConfig
from kotoba_whisper_tpu_torch.models.convert import params_from_jax
from kotoba_whisper_tpu_torch.models.student_init import init_student_from_teacher
from kotoba_whisper_tpu_torch.train import distill as td
from kotoba_whisper_tpu_torch.train import distill_multitask as tmt
from kotoba_whisper_tpu_torch.train import optim as to

TINY = dict(
    vocab_size=300, num_mel_bins=16, d_model=128, encoder_layers=2,
    encoder_attention_heads=2, decoder_layers=4, decoder_attention_heads=2,
    encoder_ffn_dim=192, decoder_ffn_dim=192, max_source_positions=24,
    max_target_positions=16, pad_token_id=0, bos_token_id=1, eos_token_id=1,
    decoder_start_token_id=2,
)
LOSS_TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_TOL = dict(atol=1e-6, rtol=1e-4)
LR = 1e-3
KEYS = (("transcribe.ja", "translate.en"), ("transcribe.ja",))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny CPU tensors: one intra-op thread, so torch's thread pool does
    not spin-wait on cores the parallel test workers oversubscribe."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def teachers():
    jcfg = JaxConfig(**TINY)
    params = jw.init_params(jax.random.key(0), jcfg)
    leaves, treedef = jax.tree.flatten(params)
    rng = np.random.default_rng(1)
    leaves = [np.asarray(x) + rng.standard_normal(x.shape).astype(np.float32) * 0.02
              for x in leaves]
    params = jax.tree.unflatten(treedef, [jnp.asarray(x) for x in leaves])
    return jcfg, params, params_from_jax(jax.tree.map(np.asarray, params), WhisperConfig(**TINY))


def _students(teachers):
    jcfg, jteacher, tteacher = teachers
    jstudent, js_cfg = jsi.init_student_from_teacher(jteacher, jcfg, decoder_layers=2)
    tstudent, _ = init_student_from_teacher(tteacher, WhisperConfig(**TINY), decoder_layers=2)
    td.freeze_encoder_(tstudent)
    return jstudent, js_cfg, tstudent


def _batches(seed, b=3, t=10):
    """One batch a dataset; each task's labels have their own -100 tails."""
    rng = np.random.default_rng(seed)
    out = []
    for keys in KEYS:
        feats = rng.standard_normal(
            (b, TINY["num_mel_bins"], 2 * TINY["max_source_positions"])).astype(np.float32)
        tasks = {}
        for key in keys:
            labels = rng.integers(3, TINY["vocab_size"], (b, t)).astype(np.int32)
            for row in range(b):
                labels[row, t - int(rng.integers(1, 5)):] = -100
            dii = np.array(jw.shift_labels_right(jnp.asarray(labels), 2, 0))
            tasks[key] = {"labels": labels, "decoder_input_ids": dii}
        out.append({"input_features": feats, "tasks": tasks})
    return out


def _jax(batches):
    return tuple(jax.tree.map(jnp.asarray, b) for b in batches)


def _torch(batches):
    return [{"input_features": torch.from_numpy(b["input_features"]),
             "tasks": {k: {n: torch.from_numpy(v).long() for n, v in tb.items()}
                       for k, tb in b["tasks"].items()}} for b in batches]


def _specs(mod):
    return (mod.DatasetSpec("ja", KEYS[0], use_kl=True),
            mod.DatasetSpec("en", KEYS[1], use_kl=False))


@pytest.mark.parametrize("share", [True, False], ids=["shared-encoder", "teacher-encoder"])
def test_multitask_loss_matches_jax(teachers, share):
    """The loss, both totals and every per-task metric within 1e-5, and the
    student's gradients within the distill tests' tolerance."""
    jcfg, jteacher, tteacher = teachers
    jstudent, js_cfg, tstudent = _students(teachers)
    batches = _batches(3)
    jdc = jd.DistillConfig(compute_dtype=jnp.float32, attn_impl="xla", remat=True,
                           share_hidden_states=share)
    (jloss, jm), jgrads = jax.value_and_grad(jmt.multitask_loss, has_aux=True)(
        jstudent, jteacher, js_cfg, jcfg, jdc, _specs(jmt), _jax(batches))
    dc = td.DistillConfig(compute_dtype=torch.float32, remat=True, share_hidden_states=share)
    loss, m = tmt.multitask_loss(tstudent, tteacher, dc, _specs(tmt), _torch(batches))
    loss.backward()
    assert set(m) == set(jm) == {"ce_loss.transcribe.ja", "ce_loss.translate.en",
                                 "kl_loss.transcribe.ja", "kl_loss.translate.en",
                                 "ce_loss", "kl_loss"}
    np.testing.assert_allclose(float(loss.detach()), float(jloss), **LOSS_TOL)
    for key in jm:
        np.testing.assert_allclose(float(m[key]), float(jm[key]), **LOSS_TOL, err_msg=key)
    ref = params_from_jax(jax.tree.map(np.asarray, jgrads), WhisperConfig(**TINY).replace(
        decoder_layers=2)).state_dict()
    for name, p in tstudent.named_parameters():
        if name.startswith("model.encoder."):
            assert p.grad is None, name
            continue
        torch.testing.assert_close(p.grad, ref[name], **GRAD_TOL, msg=name)


def test_multitask_loss_kl_only_where_asked(teachers):
    """A dataset without KL never runs the teacher: the same loss with a
    teacher whose weights are all NaN, and no kl_loss metric for its key."""
    _, _, tteacher = teachers
    _, _, tstudent = _students(teachers)
    batches = _torch(_batches(5))[1:]
    spec = (tmt.DatasetSpec("en", KEYS[1], use_kl=False),)
    dc = td.DistillConfig(compute_dtype=torch.float32, share_hidden_states=False)
    nan_teacher = init_student_from_teacher(tteacher, WhisperConfig(**TINY), decoder_layers=4)[0]
    with torch.no_grad():
        for p in nan_teacher.parameters():
            p.fill_(float("nan"))
    want, m1 = tmt.multitask_loss(tstudent, tteacher, dc, spec, batches)
    got, m2 = tmt.multitask_loss(tstudent, nan_teacher, dc, spec, batches)
    assert set(m2) == {"ce_loss.transcribe.ja", "ce_loss", "kl_loss"}
    assert float(m2["kl_loss"]) == 0.0
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_three_multitask_steps_match_jax(teachers):
    """make_multitask_train_step at lr 1e-3, warmup 1: every metric each
    step, and the parameters after the third."""
    jcfg, jteacher, tteacher = teachers
    jstudent, js_cfg, tstudent = _students(teachers)
    tx, jsched = jo.make_optimizer(jstudent, lr=LR, warmup_steps=1)
    jstate = jd.init_train_state(jstudent, tx)
    jdc = jd.DistillConfig(compute_dtype=jnp.float32, attn_impl="xla", remat=True)
    jstep = jax.jit(jmt.make_multitask_train_step(js_cfg, jcfg, jdc, _specs(jmt), tx, jsched))
    opt, sched = to.make_optimizer(tstudent, lr=LR, warmup_steps=1)
    state = td.TrainState(tstudent, opt)
    step = tmt.make_multitask_train_step(
        td.DistillConfig(compute_dtype=torch.float32, remat=True), _specs(tmt), sched,
        device="cpu")
    for i in range(3):
        batches = _batches(10 + i)
        jstate, jm = jstep(jstate, jteacher, _jax(batches))
        m = step(state, tteacher, _torch(batches))
        assert set(m) == set(jm)
        for key in jm:
            np.testing.assert_allclose(float(m[key]), float(jm[key]), **LOSS_TOL,
                                       err_msg=f"step {i} {key}")
    assert state.step == int(jstate.step) == 3
    ref = params_from_jax(jax.tree.map(np.asarray, jstate.params),
                          WhisperConfig(**TINY).replace(decoder_layers=2)).state_dict()
    for name, p in tstudent.state_dict().items():
        torch.testing.assert_close(p, ref[name], atol=1e-2 * LR, rtol=0, msg=name)


@pytest.fixture(scope="module")
def bilingual_data(teachers, tmp_path_factory):
    """A teacher and a student in HF layout, and two dataset dirs (the
    first a comma-joined group of two) of features.npz + filtered.jsonl
    with labels/<key> columns."""
    jcfg, jteacher, _ = teachers
    root = tmp_path_factory.mktemp("bilingual")
    jckpt.export_hf_model(str(root / "teacher"), jteacher, jcfg)
    jstudent, js_cfg = jsi.init_student_from_teacher(jteacher, jcfg, decoder_layers=2)
    jckpt.export_hf_model(str(root / "student"), jstudent, js_cfg)
    rng = np.random.default_rng(11)
    dirs = []
    for name, keys, n in (("ja0", KEYS[0], 3), ("ja1", KEYS[0], 4), ("en", KEYS[1], 6)):
        d = root / name
        d.mkdir()
        rows = [{"name": f"{name}{i}", **{
            f"labels/{k}": [2, *rng.integers(3, TINY["vocab_size"],
                                            int(rng.integers(3, 9))).tolist(), 1]
            for k in keys}} for i in range(n)]
        (d / "filtered.jsonl").write_text("".join(json.dumps(r) + "\n" for r in rows))
        feats = rng.standard_normal(
            (n, TINY["num_mel_bins"], 2 * TINY["max_source_positions"])).astype(np.float16)
        np.savez(d / "features.npz", input_features=feats)
        dirs.append(str(d))
    return root, [f"ja:{dirs[0]},{dirs[1]}:{'+'.join(KEYS[0])}:kl",
                  f"en:{dirs[2]}:{KEYS[1][0]}:nokl"]


def _bilingual_args(root, specs, out):
    args = []
    for s in specs:
        args += ["--dataset", s]
    return args + ["--student", str(root / "student"), "--teacher", str(root / "teacher"),
                   "--output_dir", out, "--per_dataset_batch_size", "2", "--num_train_epochs",
                   "2", "--max_steps", "5", "--max_label_length", "12", "--learning_rate",
                   str(LR), "--warmup_steps", "1", "--logging_steps", "1", "--dtype",
                   "float32"]


def test_bilingual_driver_matches_jax(bilingual_data, tmp_path, capsys):
    """Both drivers, 5 steps over two epochs of 3 steps: every logged
    metric, the checkpoint, and the exported student (the port's read back
    by the JAX package's import_hf_model) against the JAX driver's."""
    from kotoba_whisper_tpu.cli import distill_bilingual as jax_driver
    from kotoba_whisper_tpu_torch.__main__ import main

    root, specs = bilingual_data
    jax_driver.main(_bilingual_args(root, specs, str(tmp_path / "jax")))
    main(["distill-bilingual", *_bilingual_args(root, specs, str(tmp_path / "port")),
          "--device", "cpu"])
    assert "bilingual training done at step 5" in capsys.readouterr().out

    def logged(d):
        with open(os.path.join(d, "metrics.bilingual.jsonl")) as f:
            return [json.loads(line) for line in f]

    ref, got = logged(tmp_path / "jax"), logged(tmp_path / "port")
    assert [r["step"] for r in got] == [r["step"] for r in ref] == [1, 2, 3, 4, 5]
    assert [r["train/epoch"] for r in got] == [0, 0, 0, 1, 1]
    for r, g in zip(ref, got):
        keys = {k for k in r if k.startswith("train/") and k != "train/time"}
        assert keys == {k for k in g if k.startswith("train/") and k != "train/time"}
        for k in keys:
            np.testing.assert_allclose(g[k], r[k], **LOSS_TOL, err_msg=f"{g['step']} {k}")
    assert os.path.isdir(tmp_path / "port" / "checkpoint-5-epoch-1")
    want, _ = jckpt.import_hf_model(str(tmp_path / "jax" / "final"))
    have, cfg = jckpt.import_hf_model(str(tmp_path / "port" / "final"))
    assert cfg.decoder_layers == 2
    for path, w in jax.tree_util.tree_leaves_with_path(want):
        h = have
        for p in path:
            h = h[p.key]
        np.testing.assert_allclose(np.asarray(h), np.asarray(w), atol=1e-2 * LR, rtol=0,
                                   err_msg=jax.tree_util.keystr(path))


def test_bilingual_driver_rejects_bad_specs(bilingual_data, tmp_path, monkeypatch):
    """A spec whose last field is not kl/nokl, a batch larger than a
    dataset, and --dtype float32 on the card (checked before any card
    work) each raise."""
    from kotoba_whisper_tpu_torch.cli import distill_bilingual as port_driver

    root, specs = bilingual_data
    args = _bilingual_args(root, specs, str(tmp_path))
    with pytest.raises(SystemExit, match="kl or nokl"):
        port_driver.main(_bilingual_args(root, [specs[0][:-3] + ":maybe"], str(tmp_path))
                         + ["--device", "cpu"])
    with pytest.raises(SystemExit, match="smaller than the per-dataset batch"):
        port_driver.main(args + ["--device", "cpu", "--per_dataset_batch_size", "7"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(SystemExit, match="--dtype float32 on the card"):
        port_driver.main(args)
