"""The port's multi-process runtime and data-parallel training, with two
gloo ranks on the CPU (spawned processes, one torch thread each, a file
store or a free port, each run inside a 120 s timeout).

- parallel/multihost: ranks, hosts and their groups, barriers, gathers
  of host arrays (ragged ones padded first), the host slice of a work
  list, and the backend rule (NCCL on cards, gloo on the CPU, a missing
  NCCL raises).
- The DDP step: the tiny teacher and student of tests/test_torch_distill.py,
  a global batch of 8 whose two halves hold different label lengths (so a
  mean of the ranks' own token means would show): two data ranks (one and
  two microbatches), and a teacher split over a model axis of 2, each
  give the parameters of one process stepping the global batch within
  1e-6, the same global loss on both ranks, and the JAX step's metrics and
  parameters within tests/test_torch_distill.py's tolerances.
- The drivers: `pseudo-label --num_devices 2` (and a model axis of 2)
  writes the one-card files; two hosts (--coordinator_address,
  --num_processes 2) merge their tar slices by utterance name; `distill
  --num_devices 2` with a resume logs the metrics of a one-card run on the
  same global batches and exports its student.
"""
import csv
import json
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kotoba_whisper_tpu.core.config import WhisperConfig as JaxConfig
from kotoba_whisper_tpu.models import student_init as jsi
from kotoba_whisper_tpu.models import whisper as jw
from kotoba_whisper_tpu.train import distill as jd
from kotoba_whisper_tpu.train import optim as jo
from kotoba_whisper_tpu_torch.core.config import WhisperConfig
from kotoba_whisper_tpu_torch.models.convert import params_from_jax
from kotoba_whisper_tpu_torch.models.student_init import init_student_from_teacher
from kotoba_whisper_tpu_torch.parallel import multihost
from kotoba_whisper_tpu_torch.train import distill as td
from kotoba_whisper_tpu_torch.train import optim as to

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(
    vocab_size=300, num_mel_bins=16, d_model=128, encoder_layers=2,
    encoder_attention_heads=2, decoder_layers=4, decoder_attention_heads=2,
    encoder_ffn_dim=192, decoder_ffn_dim=192, max_source_positions=24,
    max_target_positions=16, pad_token_id=0, bos_token_id=1, eos_token_id=1,
    decoder_start_token_id=2,
)
LOSS_TOL = dict(rtol=1e-5, atol=1e-6)
LR = 1e-3
TIMEOUT = 120


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny CPU tensors: one intra-op thread, so torch's thread pool does
    not spin-wait on cores the parallel test workers oversubscribe."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _env():
    return dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""),
                OMP_NUM_THREADS="1")


def spawn_ranks(script: str, root, n: int = 2, args=()):
    """Run `script` as n ranks (argv: rank, root, *args); raise with their
    output unless all exit 0 within the timeout."""
    procs = [subprocess.Popen([sys.executable, "-c", script, str(r), str(root), *args],
                              cwd=REPO, env=_env(), stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(n)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=TIMEOUT)[0])
    finally:
        for p in procs:
            p.kill()
    for r, (p, o) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r}:\n{o[-4000:]}"
    return outs


def _cli(*args, n: int = 1, per_rank=None):
    """`python -m kotoba_whisper_tpu_torch` in n processes (per_rank(i)
    adds each one's flags); returns their outputs."""
    procs = [subprocess.Popen(
        [sys.executable, "-m", "kotoba_whisper_tpu_torch", *args,
         *(per_rank(i) if per_rank else ())],
        cwd=REPO, env=_env(), stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for i in range(n)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=TIMEOUT)[0])
    finally:
        for p in procs:
            p.kill()
    for p, o in zip(procs, outs):
        assert p.returncode == 0, o[-4000:]
    return outs


# ---------------------------------------------------------------------------
# parallel/multihost
# ---------------------------------------------------------------------------

MULTIHOST = r"""
import os, sys
import numpy as np
import torch
import torch.distributed as dist

rank, root = int(sys.argv[1]), sys.argv[2]
from kotoba_whisper_tpu_torch.parallel import multihost as mh

assert (mh.process_index(), mh.process_count(), mh.is_main_process()) == (0, 1, True)
mh.initialize("file://" + os.path.join(root, "store"), 2, rank, device="cpu", local_size=1)
assert dist.get_backend() == "gloo"
assert (mh.process_index(), mh.process_count(), mh.local_rank()) == (rank, 2, 0)
assert (mh.host_index(), mh.host_count(), mh.is_main_process()) == (rank, 2, rank == 0)
assert dist.get_world_size(mh.host_group()) == 1
assert mh.shard_for_host(list("abcde")) == [list("ace"), list("bd")][rank]
got = mh.all_gather_host(np.full((2, 3), rank, np.int32))
assert got.tolist() == [[0] * 3] * 2 + [[1] * 3] * 2, got
ragged = np.full((1, 2 + 3 * rank), 7 + rank, np.int64)
padded = mh.pad_across_processes(ragged, axis=1, pad_value=-1)
assert padded.shape == (1, 5)
both = mh.all_gather_host(padded)
assert both.tolist() == [[7, 7, -1, -1, -1], [8] * 5], both
assert mh.host_copy({"a": [torch.ones(2)], "b": 3})["a"][0].tolist() == [1.0, 1.0]
from kotoba_whisper_tpu_torch.parallel import sharded
lin = torch.nn.Linear(2, 3)
torch.nn.init.constant_(lin.weight, float(rank))
mine = {"t": torch.full((4,), 10.0 + rank)}
sharded.replicate(lin), sharded.replicate(mine)
assert lin.weight.eq(0.0).all() and mine["t"].tolist() == [10.0] * 4
mh.barrier("done")
mh.shutdown()
assert mh.process_count() == 1
print(f"WORKER_{rank}_OK", flush=True)
"""


def test_multihost_runtime_on_two_ranks(tmp_path):
    outs = spawn_ranks(MULTIHOST, tmp_path)
    assert all(f"WORKER_{r}_OK" in o for r, o in enumerate(outs))


def test_backend_follows_the_device(monkeypatch):
    """gloo on the CPU; NCCL for ranks on cards, raising where the torch
    build has none (no fallback)."""
    import torch.distributed as dist

    assert multihost.backend_for("cpu") == "gloo"
    monkeypatch.setattr(dist, "is_nccl_available", lambda: True)
    assert multihost.backend_for(torch.device("cuda", 1)) == "nccl"
    monkeypatch.setattr(dist, "is_nccl_available", lambda: False)
    with pytest.raises(RuntimeError, match="need NCCL"):
        multihost.backend_for("cuda")


# ---------------------------------------------------------------------------
# The DDP step
# ---------------------------------------------------------------------------

STEP_WORKER = r"""
import json, os, sys
import numpy as np
import torch

torch.set_num_threads(1)
rank, root = int(sys.argv[1]), sys.argv[2]
from kotoba_whisper_tpu_torch.core.config import WhisperConfig
from kotoba_whisper_tpu_torch.core.mesh import DATA_AXIS, MeshConfig, build_mesh
from kotoba_whisper_tpu_torch.models.convert import model_from_state_dict
from kotoba_whisper_tpu_torch.parallel import multihost, sharded
from kotoba_whisper_tpu_torch.train import distill as td
from kotoba_whisper_tpu_torch.train import optim as to

class Recording:  # the optimizer, recording the gradients each step hands it
    def __init__(self, opt):
        self.opt, self.params, self.grads = opt, opt.params, []
    def step(self, count):
        self.grads.append([p.grad.clone() for p in self.params])
        return self.opt.step(count)

spec = json.load(open(os.path.join(root, "spec.json")))
multihost.initialize("file://" + os.path.join(root, "store"), 2, rank, device="cpu")
tcfg = WhisperConfig(**spec["tiny"])
scfg = tcfg.replace(decoder_layers=2)
batches = [dict(np.load(os.path.join(root, f"batch{i}.npz"))) for i in range(spec["steps"])]
out = {}
for name, (data, model, mb) in spec["cases"].items():
    mesh = build_mesh(MeshConfig(data=data, model=model))
    teacher = model_from_state_dict(dict(np.load(os.path.join(root, "teacher.npz"))), tcfg)
    teacher = sharded.place_params(mesh, teacher, model_sharded=model > 1)
    student = model_from_state_dict(dict(np.load(os.path.join(root, "student.npz"))), scfg)
    sharded.replicate(student)
    td.freeze_encoder_(student)
    opt, sched = to.make_optimizer(student, lr=spec["lr"], warmup_steps=1)
    state = td.TrainState(student, Recording(opt))
    dc = td.DistillConfig(compute_dtype=torch.float32, remat=True, num_microbatches=mb)
    step = td.make_train_step(dc, sched, device="cpu", data_group=mesh.get_group(DATA_AXIS))
    d, n = sharded.data_coords(mesh)
    rows = sharded.rank_rows(8, d, n, mb)
    for i, b in enumerate(batches):
        m = step(state, teacher, {k: torch.from_numpy(v[rows]).long() if k != "input_features"
                                  else torch.from_numpy(v[rows]) for k, v in b.items()})
        for k, v in m.items():
            out[f"{name}/{i}/{k}"] = np.asarray(float(v))
        for j, g in enumerate(state.optimizer.grads[i]):
            out[f"{name}/{i}/grad{j}"] = g.numpy().copy()
        if i == 1:
            for k, v in student.state_dict().items():
                out[f"{name}/param1/{k}"] = v.numpy().copy()
    for k, v in student.state_dict().items():
        out[f"{name}/param/{k}"] = v.numpy().copy()
np.savez(os.path.join(root, f"out{rank}.npz"), **out)
multihost.shutdown()
print(f"WORKER_{rank}_OK", flush=True)
"""
STEP_CASES = {"dp2": (2, 1, 1), "dp2-mb2": (2, 1, 2), "tp2-teacher": (1, 2, 1)}
STEPS = 3


def _step_batch(seed):
    """8 rows; rows 0-3 keep 8-9 labels, rows 4-7 only 2-5, so the two
    data ranks (and the microbatches' blocks) hold different counts."""
    rng = np.random.default_rng(seed)
    t = 10
    labels = rng.integers(3, TINY["vocab_size"], (8, t)).astype(np.int32)
    for row, keep in enumerate([9, 8, 9, 8, 2, 5, 3, 4]):
        labels[row, keep:] = -100
    feats = rng.standard_normal(
        (8, TINY["num_mel_bins"], 2 * TINY["max_source_positions"])).astype(np.float32)
    dii = np.array(jw.shift_labels_right(jnp.asarray(labels), 2, 0))
    return {"input_features": feats, "labels": labels, "decoder_input_ids": dii}


@pytest.fixture(scope="module")
def ddp_runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("ddp")
    jcfg = JaxConfig(**TINY)
    params = jw.init_params(jax.random.key(0), jcfg)
    leaves, treedef = jax.tree.flatten(params)
    rng = np.random.default_rng(1)
    leaves = [np.asarray(x) + rng.standard_normal(x.shape).astype(np.float32) * 0.02
              for x in leaves]
    jteacher = jax.tree.unflatten(treedef, [jnp.asarray(x) for x in leaves])
    tteacher = params_from_jax(jax.tree.map(np.asarray, jteacher), WhisperConfig(**TINY))
    tstudent, _ = init_student_from_teacher(tteacher, WhisperConfig(**TINY), decoder_layers=2)
    for name, m in (("teacher", tteacher), ("student", tstudent)):
        np.savez(root / f"{name}.npz", **{k: v.numpy() for k, v in m.state_dict().items()})
    batches = [_step_batch(30 + i) for i in range(STEPS)]
    for i, b in enumerate(batches):
        np.savez(root / f"batch{i}.npz", **b)
    (root / "spec.json").write_text(json.dumps(
        {"tiny": TINY, "cases": STEP_CASES, "steps": STEPS, "lr": LR}))
    outs = spawn_ranks(STEP_WORKER, root)
    assert all(f"WORKER_{r}_OK" in o for r, o in enumerate(outs))
    ranks = [dict(np.load(root / f"out{r}.npz")) for r in range(2)]
    return (jcfg, jteacher, tteacher), batches, ranks


def _one_process(teachers, batches, mb):
    """The port's step on the global batches in one process -> (metrics
    and the gradients handed to the optimizer, each step; the parameters
    after the second step, the first at a learning rate above 0)."""
    _, _, tteacher = teachers
    student, _ = init_student_from_teacher(tteacher, WhisperConfig(**TINY), decoder_layers=2)
    td.freeze_encoder_(student)
    opt, sched = to.make_optimizer(student, lr=LR, warmup_steps=1)
    real_step, grads = opt.step, []

    def recording_step(count):
        grads.append([p.grad.clone() for p in opt.params])
        return real_step(count)

    opt.step = recording_step
    state = td.TrainState(student, opt)
    step = td.make_train_step(td.DistillConfig(compute_dtype=torch.float32, remat=True,
                                               num_microbatches=mb), sched, device="cpu")
    metrics = []
    for i, b in enumerate(batches):
        metrics.append(step(state, tteacher, {
            k: torch.from_numpy(v).long() if k != "input_features" else torch.from_numpy(v)
            for k, v in b.items()}))
        if i == 1:
            params1 = {k: v.clone() for k, v in student.state_dict().items()}
    return metrics, grads, params1


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_ddp_step_matches_one_process(ddp_runs, case):
    """On both ranks: the gradients each step hands the optimizer, and the
    parameters after the first update at a learning rate above 0, within
    1e-6 of one process stepping the global batch; the global metrics
    within 1e-5 (the JAX comparisons' tolerance: later steps follow
    parameters that Adam moved by up to ~1e-2 x lr where a gradient is
    near 0 and its rounding differs, tests/test_torch_distill.py)."""
    teachers, batches, ranks = ddp_runs
    metrics, grads, params1 = _one_process(teachers, batches, STEP_CASES[case][2])
    for r in ranks:
        for i, m in enumerate(metrics):
            for k, v in m.items():
                np.testing.assert_allclose(r[f"{case}/{i}/{k}"], float(v), **LOSS_TOL,
                                           err_msg=f"{case} step {i} {k}")
            for j, g in enumerate(grads[i]):
                np.testing.assert_allclose(r[f"{case}/{i}/grad{j}"], g.numpy(), atol=1e-6,
                                           rtol=0, err_msg=f"{case} step {i} grad {j}")
        for k, v in params1.items():
            np.testing.assert_allclose(r[f"{case}/param1/{k}"], v.numpy(), atol=1e-6, rtol=0,
                                       err_msg=f"{case} {k}")


def test_ddp_ranks_hold_different_label_counts(ddp_runs):
    """The witness that the means are global: each rank's own token mean
    differs from the global one, yet the ranks' reported losses are equal."""
    _, batches, ranks = ddp_runs
    labels = batches[0]["labels"]
    assert (labels[:4] != -100).sum() != (labels[4:] != -100).sum()
    for k in ("loss", "ce_loss", "kl_loss", "grad_norm"):
        assert ranks[0][f"dp2/0/{k}"] == ranks[1][f"dp2/0/{k}"]


@pytest.mark.parametrize("mb", [1, 2])
def test_ddp_step_matches_jax(ddp_runs, mb):
    """The two-rank step against the JAX step on the global batch: metrics
    within 1e-5, parameters within 1e-2 x lr (tests/test_torch_distill.py)."""
    (jcfg, jteacher, _), batches, ranks = ddp_runs
    jstudent, js_cfg = jsi.init_student_from_teacher(jteacher, jcfg, decoder_layers=2)
    tx, jsched = jo.make_optimizer(jstudent, lr=LR, warmup_steps=1)
    jstate = jd.init_train_state(jstudent, tx)
    jstep = jax.jit(jd.make_train_step(
        js_cfg, jcfg, jd.DistillConfig(compute_dtype=jnp.float32, attn_impl="xla", remat=True,
                                       num_microbatches=mb), tx, jsched))
    case = "dp2" if mb == 1 else "dp2-mb2"
    for i, b in enumerate(batches):
        jstate, jm = jstep(jstate, jteacher, {k: jnp.asarray(v) for k, v in b.items()})
        for k in ("loss", "ce_loss", "kl_loss", "grad_norm", "learning_rate"):
            np.testing.assert_allclose(ranks[0][f"{case}/{i}/{k}"], float(jm[k]), **LOSS_TOL,
                                       err_msg=f"step {i} {k}")
    ref = params_from_jax(jax.tree.map(np.asarray, jstate.params),
                          WhisperConfig(**TINY).replace(decoder_layers=2)).state_dict()
    for k, v in ref.items():
        np.testing.assert_allclose(ranks[0][f"{case}/param/{k}"], v.numpy(), atol=1e-2 * LR,
                                   rtol=0, err_msg=k)


# ---------------------------------------------------------------------------
# The drivers
# ---------------------------------------------------------------------------

def _wav_bytes(audio, sr=16000):
    from kotoba_whisper_tpu_torch.data.reazon import wav_bytes

    return wav_bytes(audio, sr)


@pytest.fixture(scope="module")
def dataset_dir(tmp_path_factory):
    """Two tar shards of three utterances, with transcripts."""
    from kotoba_whisper_tpu_torch.data import reazon

    rng = np.random.default_rng(0)
    d = tmp_path_factory.mktemp("reazon")
    names = []
    for s in range(2):
        utts = [(f"{s:03d}/utt{i}.wav", _wav_bytes(rng.standard_normal(8000) * 0.1))
                for i in range(3)]
        names += [n for n, _ in utts]
        reazon.write_tar_shard(str(d / f"{s:03d}.tar"), utts)
    (d / "transcript.tsv").write_text(
        "\n".join(f"{n}\tutterance {i}" for i, n in enumerate(names)), encoding="utf-8")
    return str(d)


def _read(out):
    rows = [json.loads(line) for line in open(f"{out}/pseudo_labels.jsonl")]
    with open(f"{out}/pseudo_labels.csv", newline="") as f:
        text = list(csv.reader(f))
    return rows, text


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


PL = ["pseudo-label", "--model", "preset:test-byte", "--tokenizer", "byte", "--batch_size",
      "4", "--max_label_length", "12", "--dtype", "float32", "--kv_dtype", "int8",
      "--device", "cpu"]


@pytest.fixture(scope="module")
def one_card(dataset_dir, tmp_path_factory):
    out = str(tmp_path_factory.mktemp("pl1"))
    _cli(*PL, "--dataset_dir", dataset_dir, "--output_dir", out)
    return _read(out)


@pytest.mark.parametrize("cards", [["--num_devices", "2"], ["--mesh_model_axis", "2"],
                                   ["--num_devices", "2", "--streaming"]],
                         ids=["dp2", "tp2", "dp2-streaming"])
def test_pseudo_label_on_two_ranks_writes_the_one_card_files(dataset_dir, one_card,
                                                             tmp_path, cards):
    """--streaming with a mesh warns and runs lockstep, as the JAX driver."""
    out = str(tmp_path / "pl")
    said = _cli(*PL, "--dataset_dir", dataset_dir, "--output_dir", out, *cards)[0]
    assert said.count("pseudo-labelled 6 utterances") == 1  # the host's first rank
    assert ("--streaming needs a single device; using lockstep" in said) == (
        "--streaming" in cards)
    assert _read(out) == one_card
    assert sorted(os.listdir(out)) == ["pseudo_labels.csv", "pseudo_labels.jsonl"]


@pytest.mark.parametrize("shard_slice", [None, (0, 2), (1, 2), (0, 3), (2, 3)])
def test_shard_slice_matches_jax(dataset_dir, shard_slice):
    """A host's tar slice (with a chunk range too) names the JAX reader's
    utterances, in its order."""
    from kotoba_whisper_tpu.data import reazon as jax_reazon
    from kotoba_whisper_tpu_torch.data import reazon

    for chunk_range in (None, (0, 2), (1, 2)):
        kw = dict(chunk_range=chunk_range, shard_slice=shard_slice)
        want = [(u.name, u.transcription) for u in jax_reazon.iter_dataset_dir(dataset_dir, **kw)]
        got = [(u.name, u.transcription) for u in reazon.iter_dataset_dir(dataset_dir, **kw)]
        assert got == want


def test_pseudo_label_on_two_hosts_merges_by_name(dataset_dir, one_card, tmp_path):
    """Each host takes one of the two tars and writes rank-{i}/; the first
    host merges the rows sorted by utterance name."""
    out = str(tmp_path / "pl")
    port = _free_port()
    _cli(*PL, "--dataset_dir", dataset_dir, "--output_dir", out, "--coordinator_address",
         f"127.0.0.1:{port}", "--num_processes", "2", n=2,
         per_rank=lambda i: ["--process_id", str(i)])
    rows, text = _read(out)
    want_rows, want_text = one_card
    assert rows == sorted(want_rows, key=lambda r: r["name"])
    assert text == [want_text[0]] + sorted(want_text[1:], key=lambda r: r[0])
    for i in range(2):
        part, _ = _read(os.path.join(out, f"rank-{i}"))
        assert [r["name"] for r in part] == [f"{i:03d}/utt{j}.wav" for j in range(3)]


@pytest.fixture(scope="module")
def distill_dirs(tmp_path_factory):
    """A TINY teacher and its 2-decoder-layer student in HF layout, and a
    split of 8 utterances whose label lengths differ."""
    from kotoba_whisper_tpu_torch.data.shards import ShardWriter
    from kotoba_whisper_tpu_torch.models import whisper as tw
    from kotoba_whisper_tpu_torch.train.checkpoint import export_hf_model

    root = tmp_path_factory.mktemp("distill")
    cfg = WhisperConfig(**TINY)
    teacher = tw.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    export_hf_model(str(root / "teacher"), teacher, cfg)
    student, s_cfg = init_student_from_teacher(teacher, cfg, decoder_layers=2)
    export_hf_model(str(root / "student"), student, s_cfg)
    rng = np.random.default_rng(7)
    w = ShardWriter(str(root / "split"), shard_size=3)
    for i in range(8):
        labels = [2, *rng.integers(3, TINY["vocab_size"], int(rng.integers(3, 10))).tolist(), 1]
        feats = rng.standard_normal((TINY["num_mel_bins"], 2 * TINY["max_source_positions"]))
        w.add({"name": f"utt{i}", "labels": labels}, feats.astype(np.float32))
    w.close()
    return root


def _distill(root, out, max_steps, *extra):
    return ["distill", "--data_dir", str(root / "split"), "--student", str(root / "student"),
            "--teacher", str(root / "teacher"), "--output_dir", out, "--max_steps",
            str(max_steps), "--max_label_length", "12", "--learning_rate", str(LR),
            "--warmup_steps", "1", "--logging_steps", "1", "--save_steps", "100", "--dtype",
            "float32", "--num_train_epochs", "2", "--no_prefetch", "--device", "cpu", *extra]


def test_distill_on_two_ranks_resumes_and_matches_one_card(distill_dirs, tmp_path):
    """Two data ranks of 2 rows (global batch 4), stopped after 2 steps and
    resumed to 3, log the metrics of one card stepping the same global
    batches of 4 and export the same student; only the first rank writes."""
    from kotoba_whisper_tpu_torch.train.checkpoint import import_hf_model

    root = distill_dirs
    whole, split = str(tmp_path / "whole"), str(tmp_path / "split")
    _cli(*_distill(root, whole, 3, "--per_device_train_batch_size", "4"))
    two = ["--per_device_train_batch_size", "2", "--num_devices", "2"]
    said = _cli(*_distill(root, split, 2, *two))[0]
    assert said.count("training done at step 2") == 1
    assert os.path.isdir(os.path.join(split, "checkpoint-2-epoch-1"))
    said = _cli(*_distill(root, split, 3, *two))[0]
    assert "resumed from" in said and "training done at step 3" in said
    assert sorted(os.listdir(split)) == ["checkpoint-3-epoch-1", "final", "metrics.run.jsonl"]

    def logged(d):
        with open(os.path.join(d, "metrics.run.jsonl")) as f:
            return [json.loads(line) for line in f]

    ref, got = logged(whole), logged(split)
    assert [r["step"] for r in got] == [r["step"] for r in ref] == [1, 2, 3]
    for r, g in zip(ref, got):
        for key in ("loss", "ce_loss", "kl_loss", "grad_norm", "learning_rate"):
            np.testing.assert_allclose(g[f"train/{key}"], r[f"train/{key}"], **LOSS_TOL,
                                       err_msg=f"step {g['step']} {key}")
    a, _ = import_hf_model(os.path.join(whole, "final"))
    b, _ = import_hf_model(os.path.join(split, "final"))
    for (name, p), q in zip(a.state_dict().items(), b.state_dict().values()):
        torch.testing.assert_close(q, p, atol=1e-2 * LR, rtol=0, msg=name)


def test_distill_model_axis_needs_cards(distill_dirs, tmp_path):
    """A model axis larger than the ranks raises before any step."""
    from kotoba_whisper_tpu_torch.cli import distill as port_distill

    with pytest.raises(SystemExit, match="--mesh_model_axis 2 needs as many cards"):
        port_distill.main(_distill(distill_dirs, str(tmp_path), 1, "--mesh_model_axis",
                                   "2")[1:])
    with pytest.raises(SystemExit, match="needs --coordinator_address"):
        port_distill.main(_distill(distill_dirs, str(tmp_path), 1, "--num_processes", "2")[1:])


def test_multi_card_tool_on_two_cpu_ranks(monkeypatch, capsys):
    """tools/multi_card with --cards 2 on the CPU: stage 2 on one rank, on
    two data ranks and on a model axis of 2 writes the same utterances in
    the same order (fp32: the same labels), and distill on two data ranks
    logs one rank's losses."""
    from kotoba_whisper_tpu_torch.tools import multi_card

    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    monkeypatch.setenv("PYTHONPATH", REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    monkeypatch.chdir(REPO)
    assert multi_card.main(["--cards", "2", "--model", "preset:test-byte", "--device", "cpu",
                            "--timeout", str(TIMEOUT)]) == 0
    lines = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert [(r.get("stage"), r.get("run")) for r in lines[:-1]] == [
        (2, "1 card"), (2, "DP=2"), (2, "DP=1 x TP=2"), (5, "1 card"), (5, "DP=2")]
    assert all(r["one_card_order"] and r["share_equal_to_one_card"] == 1.0
               for r in lines[:3])
    assert lines[4]["max_rel_to_one_card"] <= 1e-6 and lines[-1]["ok"]
