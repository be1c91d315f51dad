"""The wandb tracker of the port's train/logging.MetricLogger against the
JAX package's, on the CPU.

A stub `wandb` module in sys.modules records every call (the tests need
neither wandb nor a network). Both loggers, fed
the same records at the same clock, make the same `init(project=, name=)`,
`log(record, step=)` and `finish()` calls and write the same JSONL file;
with WANDB_DISABLED set to "1" or "true" they make none; a stub whose
`init` raises leaves both on the JSONL file alone (the port also says so
in one stderr line). cli/distill gives the project to its first rank only.
"""
import json
import sys
import time
import types

import pytest

from kotoba_whisper_tpu.train import logging as jax_logging
from kotoba_whisper_tpu_torch.cli import distill
from kotoba_whisper_tpu_torch.train import logging as port_logging

RECORDS = [({"loss": 1.5, "ce_loss": 1.0, "note": "warm"}, 10, "train"),
           ({"loss": 1.25}, 20, "train"),
           ({"wer": 12.5}, 20, "eval")]


class _Stub:
    """A wandb module: init -> a run object; every call into `calls`."""

    def __init__(self, fail=False):
        self.calls, self.fail = [], fail

    def module(self):
        stub = self

        class Run:
            def log(self, record, step=None):
                stub.calls.append(("log", json.loads(json.dumps(record)), step))

            def finish(self):
                stub.calls.append(("finish",))

        def init(**kw):
            stub.calls.append(("init", kw))
            if stub.fail:
                raise RuntimeError("no network")
            return Run()

        return types.SimpleNamespace(init=init)


def _drive(mod, out_dir, stub, monkeypatch, **kw):
    monkeypatch.setitem(sys.modules, "wandb", stub.module())
    logger = mod.MetricLogger(str(out_dir), run_name="r", wandb_project="proj", **kw)
    for metrics, step, prefix in RECORDS:
        logger.log(metrics, step, prefix=prefix)
    logger.close()
    with open(out_dir / "metrics.r.jsonl") as f:
        return [json.loads(line) for line in f]


@pytest.fixture(autouse=True)
def _fixed_clock(monkeypatch):
    monkeypatch.setattr(time, "time", lambda: 1234.5)
    monkeypatch.delenv("WANDB_DISABLED", raising=False)


def test_port_logger_makes_jax_calls_and_jsonl(tmp_path, monkeypatch):
    port, ref = _Stub(), _Stub()
    got = _drive(port_logging, tmp_path / "port", port, monkeypatch)
    want = _drive(jax_logging, tmp_path / "jax", ref, monkeypatch)
    assert got == want and len(got) == len(RECORDS)
    assert port.calls == ref.calls
    assert port.calls[0] == ("init", {"project": "proj", "name": "r"})
    assert [c[2] for c in port.calls[1:-1]] == [10, 20, 20] and port.calls[-1] == ("finish",)
    assert [c[1] for c in port.calls[1:-1]] == got


@pytest.mark.parametrize("value", ["1", "true", "TRUE"])
def test_wandb_disabled_makes_no_calls(tmp_path, monkeypatch, value):
    monkeypatch.setenv("WANDB_DISABLED", value)
    port, ref = _Stub(), _Stub()
    got = _drive(port_logging, tmp_path / "port", port, monkeypatch)
    assert got == _drive(jax_logging, tmp_path / "jax", ref, monkeypatch)
    assert port.calls == ref.calls == []


def test_failed_init_leaves_the_jsonl(tmp_path, monkeypatch, capsys):
    port, ref = _Stub(fail=True), _Stub(fail=True)
    got = _drive(port_logging, tmp_path / "port", port, monkeypatch)
    assert "wandb tracker did not start" in capsys.readouterr().err
    assert got == _drive(jax_logging, tmp_path / "jax", ref, monkeypatch)
    assert len(got) == len(RECORDS)
    assert port.calls == ref.calls == [("init", {"project": "proj", "name": "r"})]


def test_missing_wandb_leaves_the_jsonl(tmp_path, monkeypatch, capsys):
    monkeypatch.setitem(sys.modules, "wandb", None)  # import wandb raises ModuleNotFoundError
    logger = port_logging.MetricLogger(str(tmp_path), wandb_project="proj")
    logger.log({"loss": 1.0}, 1)
    logger.close()
    assert "ModuleNotFoundError" in capsys.readouterr().err
    assert (tmp_path / "metrics.run.jsonl").read_text().count("\n") == 1


@pytest.mark.parametrize("main", [True, False])
def test_distill_gives_the_project_to_the_first_rank_only(tmp_path, monkeypatch, main):
    stub = _Stub()
    monkeypatch.setitem(sys.modules, "wandb", stub.module())
    args = distill._parser().parse_args(
        ["--data_dir", "d", "--student", "s", "--teacher", "t", "--output_dir", str(tmp_path),
         "--wandb_project", "proj"])
    logger = distill.make_logger(args, main)
    logger.log({"loss": 1.0}, 1)
    logger.close()
    if main:
        assert stub.calls[0] == ("init", {"project": "proj", "name": "run"})
        assert logger.path is not None
    else:
        assert stub.calls == [] and logger.path is None
