"""Port's pseudo-label driver vs the JAX driver on one exported checkpoint.

A synthetic WAV-in-tar dataset (the tests/test_cli_pipeline.py fixture
shape), one tiny random model exported in HF layout, both drivers run on
the CPU in fp32: per-utterance token ids in the jsonl and the csv text
must be identical, in the drivers' default mode (projections fused), with
--no_fuse, with w8a8 projections (--gemm_dtype int8), with continuous
batching (--streaming), with beam search (--num_beams 3) and with beam
search under continuous batching (--streaming --num_beams 2, compute and
int8 KV), and with the int4 KV cache (lockstep, and --streaming
--num_beams 2).
"""
import csv
import json
import struct

import jax
import numpy as np
import pytest
import torch

from kotoba_whisper_tpu.core.config import PRESETS
from kotoba_whisper_tpu.data import reazon
from kotoba_whisper_tpu.models import whisper as jw
from kotoba_whisper_tpu.train.checkpoint import export_hf_model


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
    utts = [
        (f"000/utt{i}.wav", _wav_bytes(rng.standard_normal(8000) * 0.1))
        for i in range(5)
    ]
    reazon.write_tar_shard(str(d / "000.tar"), utts)
    (d / "transcript.tsv").write_text(
        "\n".join(f"000/utt{i}.wav\tutterance number {i}" for i in range(5)),
        encoding="utf-8",
    )
    return str(d)


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    cfg = PRESETS["test-byte"]
    d = str(tmp_path_factory.mktemp("model"))
    export_hf_model(d, jw.init_params(jax.random.key(0), cfg), cfg)
    return d


def _read(out):
    rows = [json.loads(line) for line in open(f"{out}/pseudo_labels.jsonl")]
    with open(f"{out}/pseudo_labels.csv", newline="") as f:
        text = list(csv.reader(f))
    return rows, text


@pytest.mark.parametrize("extra", [
    ["--kv_dtype", "compute", "--no_fuse"],
    ["--kv_dtype", "int8", "--wire_dtype", "int16", "--no_fuse"],
    ["--kv_dtype", "int8"],
    ["--kv_dtype", "int8", "--gemm_dtype", "int8"],
    ["--kv_dtype", "int8", "--streaming"],
    ["--kv_dtype", "int8", "--num_beams", "3"],
    ["--kv_dtype", "compute", "--streaming", "--num_beams", "2"],
    ["--kv_dtype", "int8", "--streaming", "--num_beams", "2"],
    ["--kv_dtype", "int4"],
    ["--kv_dtype", "int4", "--streaming", "--num_beams", "2"],
], ids=["compute", "int8-int16wire", "fused", "fused-w8a8", "streaming", "beam3",
        "streaming-beam2", "streaming-beam2-int8", "int4", "streaming-beam2-int4"])
def test_port_driver_matches_jax_driver(dataset_dir, model_dir, tmp_path, extra):
    from kotoba_whisper_tpu.cli import pseudo_label as jax_driver
    from kotoba_whisper_tpu_torch.cli import pseudo_label as port_driver

    base = [
        "--dataset_dir", dataset_dir, "--model", model_dir,
        "--tokenizer", "byte", "--batch_size", "3",
        "--max_label_length", "20", "--dtype", "float32", *extra,
    ]
    jax_driver.main(base + ["--output_dir", str(tmp_path / "jax")])
    port_driver.main(base + ["--output_dir", str(tmp_path / "port"), "--device", "cpu"])
    ref_rows, ref_csv = _read(tmp_path / "jax")
    got_rows, got_csv = _read(tmp_path / "port")
    assert len(got_rows) == len(ref_rows) == 5
    for r, g in zip(ref_rows, got_rows):
        assert g["name"] == r["name"]
        assert g["transcription"] == r["transcription"]
        assert g["whisper_transcript"] == r["whisper_transcript"], g["name"]
    assert got_csv == ref_csv


def test_tokenizer_matches_jax():
    """The port's tokenizer copy: same special layout, prompt and decoded
    text (with and without specials and timestamps) as the JAX package's."""
    from kotoba_whisper_tpu.tokenizer.whisper_tokenizer import WhisperTokenizer as JaxTok
    from kotoba_whisper_tpu_torch.tokenizer.whisper_tokenizer import WhisperTokenizer

    for vocab in (51865, 51866):
        ref, got = JaxTok.byte_vocab(vocab), WhisperTokenizer.byte_vocab(vocab)
        assert got.special.__dict__ == ref.special.__dict__
        for lang, task, ts in (("ja", "transcribe", True), ("en", "translate", False)):
            assert got.sot_sequence(lang, task, ts) == ref.sot_sequence(lang, task, ts)
        st = got.special
        ids = [st.sot, st.lang_begin + 7, st.transcribe, st.timestamp_begin + 3,
               72, 105, 227, 129, 130, st.timestamp_begin + 40, st.eot]
        for kw in (dict(), dict(skip_special_tokens=False, decode_with_timestamps=True)):
            assert got.decode(ids, **kw) == ref.decode(ids, **kw)
