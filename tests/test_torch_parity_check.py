"""The port's parity-check stage against the JAX package's, on the CPU.

A tiny HF-layout checkpoint (test-tiny widths, random weights, written by
the port's train/checkpoint.export_hf_model, with a hand-written
vocab.json of the 256 byte tokens padded to whisper's 50257 text ids and
an empty merges.txt) and a 1 s WAV go through `python -m
kotoba_whisper_tpu_torch parity-check --device cpu --max_length 16` and
through the JAX package's parity_check on the same files: the port prints
the three stages, its mel, encoder and logits deviations from
transformers are <= 1e-4, its greedy tokens are the JAX package's, and
its exit code is the JAX package's. With the checkpoint's vocab the
prompt is HF's and both exit 0 on a token-exact match; with `--tokenizer
byte` (specials right above the 256 bytes) the prompt is not HF's and
both exit 1.

Also: the port's CLI has every stage of the JAX package's and no
refusal list, and what the port still refuses is wandb and the streams'
prefetch.
"""
from __future__ import annotations

import json
import pathlib
import re

import numpy as np
import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parent.parent

pytest.importorskip("transformers")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny CPU tensors: one intra-op thread, so torch's thread pool does
    not spin-wait on cores the parallel test workers oversubscribe."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    from kotoba_whisper_tpu_torch.cli import common
    from kotoba_whisper_tpu_torch.data.reazon import wav_bytes
    from kotoba_whisper_tpu_torch.train.checkpoint import export_hf_model

    d = tmp_path_factory.mktemp("parity")
    model, cfg = common.load_model("preset:test-tiny", torch.device("cpu"), torch.float32,
                                   seed=3)
    export_hf_model(str(d / "ckpt"), model, cfg)
    # GPT-2's byte-to-unicode map for the 256 byte tokens, then one filler
    # at 50256, so that the specials sit at whisper's ids (sot 50258)
    printable = [*range(33, 127), *range(161, 173), *range(174, 256)]
    rest = [b for b in range(256) if b not in printable]
    vocab = {chr(b): b for b in printable}
    vocab.update({chr(256 + i): b for i, b in enumerate(rest)})
    vocab["<|filler|>"] = 50256
    (d / "ckpt" / "vocab.json").write_text(json.dumps(vocab))
    (d / "ckpt" / "merges.txt").write_text("#version: 0.2\n")
    t = np.arange(16000) / 16000.0
    audio = 0.2 * np.sin(2 * np.pi * 220 * t) + 0.02 * np.random.default_rng(0).standard_normal(
        16000)
    (d / "a.wav").write_bytes(wav_bytes(audio.astype(np.float32)))
    return ["--checkpoint", str(d / "ckpt"), "--audio", str(d / "a.wav"), "--max_length", "16"]


def _run(main, argv, capsys):
    capsys.readouterr()
    with pytest.raises(SystemExit) as e:
        main(argv)
    return e.value.code, capsys.readouterr().out.splitlines()


@pytest.mark.parametrize("tokenizer, expect", [([], 0), (["--tokenizer", "byte"], 1)],
                         ids=["checkpoint-vocab", "byte"])
def test_parity_check_matches_jax(files, tokenizer, expect, capsys, monkeypatch):
    from kotoba_whisper_tpu.cli import parity_check as jax_parity
    from kotoba_whisper_tpu_torch.__main__ import main

    monkeypatch.setenv("KWT_PLATFORM", "cpu")
    code, said = _run(main, ["parity-check", *files, *tokenizer, "--device", "cpu"], capsys)
    jax_code, jax_said = _run(jax_parity.main, files + tokenizer, capsys)
    assert code == jax_code == expect, said + jax_said
    for stage in ("[mel]", "[encoder]", "[logits]"):
        (line,) = [s for s in said if s.startswith(stage)]
        assert float(line.split("=")[1]) <= 1e-4, line
    greedy = [s for s in said if s.startswith(("[greedy]", "  ours ids"))]
    assert greedy == [s for s in jax_said if s.startswith(("[greedy]", "  ours ids"))]
    assert greedy[1] == f"[greedy] token-exact match: {code == 0}"


def test_parity_check_asks_for_the_card_by_default(files, monkeypatch):
    from kotoba_whisper_tpu_torch.cli import parity_check

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        parity_check.main(files)


def test_cli_has_every_jax_stage():
    import kotoba_whisper_tpu.__main__ as jax_main
    import kotoba_whisper_tpu_torch.__main__ as port_main

    assert not hasattr(port_main, "NOT_PORTED")
    assert list(port_main.STAGES) == list(jax_main.STAGES)


def test_the_port_refuses_only_wandb_and_prefetch():
    hits = sorted(
        f"{p.relative_to(REPO)}:{i}"
        for p in (REPO / "kotoba_whisper_tpu_torch").rglob("*.py")
        for i, line in enumerate(p.read_text().splitlines(), 1)
        if re.search(r"raise .*not ported", line))
    assert [h.split(":")[0] for h in hits] == [
        "kotoba_whisper_tpu_torch/cli/distill.py",
        "kotoba_whisper_tpu_torch/decode/streaming.py",
        "kotoba_whisper_tpu_torch/decode/streaming_beam.py",
        "kotoba_whisper_tpu_torch/train/logging.py"], hits
