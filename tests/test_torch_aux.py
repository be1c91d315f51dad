"""The port's auxiliary modules against the JAX package's, on the CPU.

- data/downloader: download, health check, heal and a missing shard over
  file:// URLs, with the JAX package's results; reazon.check_tar_integrity
  on good, corrupt and truncated tars as the JAX package's.
- utils/artifacts: atomic publish, retry, list and delete.
- eval/statistics: data_statistics equal to the JAX package's; parameter
  counts of the port's modules equal to the JAX package's trees
  (large-v3 = 1,543,490,560, distil-large-v3 = 756,405,760).
- utils/debug: tree_checksum as the JAX package's (fp32 sums, rtol 1e-6),
  find_nonfinite's key paths written as JAX's keystr writes them,
  debug_mode raising at a NaN's backward op.
- utils/profiling: trace writes a Chrome trace holding an annotated span;
  StepTimer.
- eval/scaling: scaling_report over two gloo CPU ranks at counts [1, 2].
"""
from __future__ import annotations

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kotoba_whisper_tpu.data import downloader as jdl
from kotoba_whisper_tpu.data import reazon as jreazon
from kotoba_whisper_tpu_torch.data import downloader, reazon


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny CPU tensors: one intra-op thread, so torch's thread pool does
    not spin-wait on cores the parallel test workers oversubscribe."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _remote(tmp_path):
    remote = tmp_path / "remote"
    remote.mkdir()
    for i in range(3):
        reazon.write_tar_shard(str(remote / f"{i:03x}.tar"), [(f"u{i}.wav", b"RIFFxxxx")])
    (remote / "transcript.tsv").write_text("u0.wav\thello\n")
    return remote


def test_downloader_retry_and_health_check_match_jax(tmp_path):
    remote = _remote(tmp_path)
    results = {}
    for name, mod in (("port", downloader), ("jax", jdl)):
        out = tmp_path / name
        cfg = mod.DownloadConfig(base_url=f"file://{remote}", out_dir=str(out), n_shards=3,
                                 n_workers=2, max_retries=2, retry_sleep_s=0.01)
        got = [mod.download_dataset(cfg), mod.health_check(cfg), sorted(os.listdir(out))]
        (out / "001.tar").write_bytes(b"corrupt")
        got += [mod.health_check(cfg), mod.download_dataset(cfg), mod.health_check(cfg)]
        results[name] = got
    assert results["port"] == results["jax"] == [
        [], [], ["000.tar", "001.tar", "002.tar", "transcript.tsv"], [1], [], []]
    os.remove(remote / "002.tar")
    for name, mod in (("port", downloader), ("jax", jdl)):
        os.remove(tmp_path / name / "002.tar")
        cfg = mod.DownloadConfig(base_url=f"file://{remote}", out_dir=str(tmp_path / name),
                                 n_shards=3, n_workers=2, max_retries=2, retry_sleep_s=0.01)
        assert mod.download_dataset(cfg) == [2]
    assert downloader.SIZE_PRESETS == jdl.SIZE_PRESETS


@pytest.mark.parametrize("damage", ["none", "corrupt", "truncated", "missing"])
def test_check_tar_integrity_matches_jax(tmp_path, damage):
    path = tmp_path / "000.tar"
    reazon.write_tar_shard(str(path), [(f"u{i}.wav", os.urandom(4000)) for i in range(3)])
    if damage == "corrupt":
        path.write_bytes(b"corrupt")
    elif damage == "truncated":
        path.write_bytes(path.read_bytes()[:3000])
    elif damage == "missing":
        path.unlink()
    got = reazon.check_tar_integrity(str(path))
    assert got == jreazon.check_tar_integrity(str(path)) == (damage == "none")


def test_safe_publish_atomic(tmp_path):
    from kotoba_whisper_tpu_torch.utils.artifacts import (
        delete_artifacts,
        list_artifacts,
        safe_publish,
    )

    dest = str(tmp_path / "store" / "dataset_v1")
    for version in ("v1", "v2"):  # a republish replaces atomically
        safe_publish(lambda d, v=version: open(os.path.join(d, "data.txt"), "w").write(v), dest)
        assert open(os.path.join(dest, "data.txt")).read() == version

    def bad(d):
        raise OSError("disk on fire")

    with pytest.raises(RuntimeError, match="failed after 2 tries"):
        safe_publish(bad, dest, max_retries=2, retry_sleep_s=0.01)
    assert open(os.path.join(dest, "data.txt")).read() == "v2"
    assert list_artifacts(str(tmp_path / "store")) == ["dataset_v1"]
    delete_artifacts(str(tmp_path / "store"), ["dataset_v1"])
    assert list_artifacts(str(tmp_path / "store")) == []


def test_data_statistics_match_jax():
    from kotoba_whisper_tpu.eval.statistics import data_statistics as jax_stats
    from kotoba_whisper_tpu_torch.eval.statistics import data_statistics

    rng = np.random.default_rng(0)
    utts = [(rng.standard_normal(16000 * (i + 1)).astype(np.float32), [1] * (i + 2))
            for i in range(3)] + [(np.zeros(0, np.float32), None)]
    assert data_statistics(iter(utts)) == jax_stats(iter(utts))
    assert data_statistics(iter(utts))["duration_s_total"] == pytest.approx(6.0)
    assert data_statistics(iter([])) == jax_stats(iter([]))


@pytest.mark.parametrize("preset,count", [("large-v3", 1_543_490_560),
                                          ("distil-large-v3", 756_405_760),
                                          ("test-byte", None)])
def test_model_statistics_match_jax(preset, count):
    from kotoba_whisper_tpu.core.config import PRESETS as JAX_PRESETS
    from kotoba_whisper_tpu.eval.statistics import model_statistics as jax_stats
    from kotoba_whisper_tpu.models import whisper as jw
    from kotoba_whisper_tpu_torch.core.config import PRESETS
    from kotoba_whisper_tpu_torch.eval.statistics import model_statistics
    from kotoba_whisper_tpu_torch.models.whisper import WhisperForConditionalGeneration

    shapes = jax.eval_shape(lambda k: jw.init_params(k, JAX_PRESETS[preset]), jax.random.key(0))
    want = jax_stats(shapes, name=preset)
    with torch.device("meta"):
        model = WhisperForConditionalGeneration(PRESETS[preset])
    got = model_statistics(model, name=preset)
    assert sorted(got) == sorted(want)
    assert {k: got[k] for k in ("model", "n_parameters", "bytes_fp32")} == \
        {k: want[k] for k in ("model", "n_parameters", "bytes_fp32")}
    if count is not None:
        assert got["n_parameters"] == count
    sd = model_statistics({k: np.zeros(v.shape, np.float32) for k, v in
                           model.state_dict().items()} if preset == "test-byte"
                          else model.state_dict())
    assert sd["n_parameters"] == got["n_parameters"]
    assert sd["n_tensors"] == len(model.state_dict())


def _tree(rng):
    return {"encoder": {"layers": [rng.standard_normal((4, 3)).astype(np.float32)
                                   for _ in range(3)],
                        "ln": (np.ones(5, np.float32), np.zeros(5, np.float32))},
            "b": rng.standard_normal(7).astype(np.float32), "a": np.float32(2.5)}


def test_checksum_and_nonfinite_paths_match_jax():
    from kotoba_whisper_tpu.utils import debug as jdebug
    from kotoba_whisper_tpu_torch.utils import debug

    tree = _tree(np.random.default_rng(0))
    want = jdebug.tree_checksum(jax.tree.map(jnp.asarray, tree))
    assert debug.tree_checksum(tree) == pytest.approx(want, rel=1e-6)
    as_tensors = {"encoder": {"layers": [torch.from_numpy(a) for a in tree["encoder"]["layers"]],
                              "ln": tuple(torch.from_numpy(a) for a in tree["encoder"]["ln"])},
                  "b": torch.from_numpy(tree["b"]), "a": 2.5}
    assert debug.tree_checksum(as_tensors) == pytest.approx(want, rel=1e-6)
    assert debug.assert_params_in_sync(tree) == pytest.approx(want, rel=1e-6)
    assert debug.find_nonfinite(tree) == jdebug.find_nonfinite(tree) == []
    bad = _tree(np.random.default_rng(0))
    bad["encoder"]["layers"][1][0, 0] = np.nan
    bad["encoder"]["ln"][1][2] = np.inf
    bad["b"][3] = -np.inf
    paths = debug.find_nonfinite(bad)
    assert paths == jdebug.find_nonfinite(bad) == [
        "['b']", "['encoder']['layers'][1]", "['encoder']['ln'][1]"]


def test_debug_mode_raises_at_a_nan_backward():
    from kotoba_whisper_tpu_torch.utils.debug import debug_mode

    x = torch.tensor([-1.0, 4.0], requires_grad=True)
    with debug_mode(disable_jit=True):
        with pytest.raises(RuntimeError, match="nan"), \
                pytest.warns(UserWarning, match="Error detected in SqrtBackward0"):
            torch.sqrt(x).sum().backward()
    torch.sqrt(x).sum().backward()  # outside the block no check runs


def test_trace_writes_a_chrome_trace(tmp_path):
    from kotoba_whisper_tpu_torch.utils.profiling import StepTimer, annotate, trace

    with trace(str(tmp_path / "prof")):
        with annotate("kwt-span"):
            y = torch.ones(64, 64) @ torch.ones(64, 64)
    (name,) = os.listdir(tmp_path / "prof")
    with open(tmp_path / "prof" / name) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "kwt-span" for e in events)
    timer = StepTimer()
    with timer:
        assert timer.done({"y": [y, y * 2]}) > 0
    assert timer.mean > 0 and len(timer.times) == 1


def _tiny_encoder(dev):
    """scaling_report's make_pipeline: the test-byte preset's encoder in fp32."""
    from kotoba_whisper_tpu_torch.cli.common import load_model
    from kotoba_whisper_tpu_torch.models.whisper import encode

    model, _ = load_model("preset:test-byte", dev, torch.float32)
    return lambda batch: encode(model, batch["mel"], device=dev)


def _tiny_batch(n_ranks):
    """scaling_report's make_batch: one seeded 30 s log-mel row a rank."""
    from kotoba_whisper_tpu_torch.core.config import PRESETS

    cfg = PRESETS["test-byte"]
    return {"mel": np.random.default_rng(0).standard_normal(
        (n_ranks, cfg.num_mel_bins, 2 * cfg.max_source_positions)).astype(np.float32)}


def test_scaling_report_on_two_gloo_ranks(monkeypatch):
    from kotoba_whisper_tpu_torch.eval.scaling import scaling_report

    monkeypatch.setenv("OMP_NUM_THREADS", "1")  # the spawned ranks' threads
    points = scaling_report(_tiny_encoder, _tiny_batch, audio_seconds_per_item=30.0,
                            device_counts=[1, 2], n_trials=1, device="cpu")
    assert [p.n_devices for p in points] == [1, 2]
    assert points[0].efficiency == 1.0
    for p in points:
        assert p.audio_s_per_s > 0 and p.per_chip == pytest.approx(p.audio_s_per_s / p.n_devices)
    assert points[1].efficiency == pytest.approx(points[1].per_chip / points[0].per_chip)
