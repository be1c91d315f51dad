"""The port's ESB corpus preparation against the JAX package's, on the CPU.

For each of the eight corpora, a miniature of its raw distribution layout
(the layouts of tests/test_esb.py, with decodable WAV audio under every
corpus's own file names: the native decoder reads the content, not the
suffix) goes through both packages' `prepare-eval-set --corpus <name>
--to_tar`: the manifests are equal row for row (TEDLIUM's segment paths
under each run's own output dir), TEDLIUM's segment WAVs and every tar
shard and transcript.tsv are byte-identical. The cleanup functions and
the SPHERE reader give the JAX package's results on the same inputs.
"""
from __future__ import annotations

import json
import os

import numpy as np
import pytest

from kotoba_whisper_tpu.cli import prepare_eval_set as jax_prepare
from kotoba_whisper_tpu.data import esb as jesb
from kotoba_whisper_tpu_torch.cli import prepare_eval_set as port_prepare
from kotoba_whisper_tpu_torch.data import esb
from kotoba_whisper_tpu_torch.data.reazon import wav_bytes

RATE = 16000


def _wav(seed: int, seconds: float = 0.25) -> bytes:
    rng = np.random.default_rng(seed)
    return wav_bytes(rng.standard_normal(int(RATE * seconds)) * 0.1)


def _sphere(samples: np.ndarray) -> bytes:
    head = ("NIST_1A\n   1024\nsample_rate -i 16000\nchannel_count -i 1\n"
            "sample_n_bytes -i 2\nsample_coding -s3 pcm\nsample_byte_format -s2 01\n"
            "end_head\n").encode()
    return head + b" " * (1024 - len(head)) + samples.astype("<i2").tobytes()


def _ami(raw):
    d = raw / "EN2001a"
    d.mkdir(parents=True)
    ids = ["AMI_EN2001a_H00_MEE068_0000000_0000100", "AMI_EN2001a_H00_MEE068_0000200_0000300"]
    for i, _id in enumerate(ids):
        (d / f"eval_{_id.lower()}.wav").write_bytes(_wav(i))
    (raw / "eval.txt").write_text("".join(f"{_id} HELLO THERE {i}\n" for i, _id in
                                          enumerate(ids)))
    return "eval"


def _spgispeech(raw):
    d = raw / "test" / "ab12"
    d.mkdir(parents=True)
    (d / "1.wav").write_bytes(_wav(1))
    (d / "2.wav").write_bytes(_wav(2))
    (raw / "meta.csv").write_text("wav_filename|wav_filesize|transcript\n"
                                  "ab12/1.wav|4|Quarterly results.\nab12/2.wav|4|Next, please.\n")
    return None


def _voxpopuli(raw):
    raw.mkdir()
    (raw / "20180101-x.wav").write_bytes(_wav(3))
    (raw / "20180101-y.wav").write_bytes(_wav(4))
    (raw / "meta.tsv").write_text("id\tnormalized_text\n20180101-x\tThe Parliament MET today\n"
                                  "20180101-y\tVOTE now\n")
    return None


def _tedlium(raw):
    d = raw / "test"
    d.mkdir(parents=True)
    samples = (np.random.default_rng(5).standard_normal(RATE * 4) * 3000).astype(np.int16)
    (d / "TalkA.sph").write_bytes(_sphere(samples))
    (d / "TalkA.stm").write_text(
        "TalkA 1 spk1 0.50 1.50 <o,f0,female> Hello it 's WORLD (key)\n"
        "TalkA 1 spk1 2.00 3.00 <o,f0,male> ignore_time_segment_in_scoring\n"
        "TalkA 1 spk2 3.00 3.50 <o,f0,male> second <unk> segment\n")
    return None


def _gigaspeech(raw):
    d = raw / "test_chunks_0000"
    d.mkdir(parents=True)
    for i in (1, 2, 3):
        (d / f"YOU1_S0{i}.wav").write_bytes(_wav(10 + i))
    (raw / "meta.csv").write_text("sid,text_tn\nYOU1_S01,HELLO <COMMA> WORLD <PERIOD>\n"
                                  "YOU1_S02,<SIL>\nYOU1_S03,YES <QUESTIONMARK>\n")
    return None


def _librispeech(raw):
    d = raw / "1089" / "134686"
    d.mkdir(parents=True)
    for i in range(2):
        (d / f"1089-134686-000{i}.flac").write_bytes(_wav(20 + i))
    (d / "1089-134686.trans.txt").write_text(
        "1089-134686-0000 HE HOPED THERE WOULD BE STEW\n1089-134686-0001 STUFF IT INTO YOU\n")
    return "test.clean"


def _common_voice(raw):
    clips = raw / "clips"
    clips.mkdir(parents=True)
    for i, name in enumerate(("a.mp3", "b.mp3", "c.mp3")):
        (clips / name).write_bytes(_wav(30 + i))
    (raw / "test.tsv").write_text("client_id\tpath\tsentence\n"
                                  'u1\ta.mp3\t"Wrapped in quotes"\n'
                                  "u2\tb\tDouble \"\"quoted\"\" word\nu3\tc.mp3\t\n")
    return "test"


def _earnings22(raw):
    raw.mkdir()
    for i in (1, 2, 3):
        (raw / f"4320_chunk_00{i}.wav").write_bytes(_wav(40 + i))
    (raw / "metadata.csv").write_text("file,sentence,source_id\n"
                                      "4320_chunk_001.wav,Revenue <noise> grew,4320\n"
                                      "4320_chunk_002.wav,<inaudible>,4320\n"
                                      "4320_chunk_003.wav,Margins held,4320\n")
    return None


LAYOUTS = {"ami": _ami, "spgispeech": _spgispeech, "voxpopuli": _voxpopuli,
           "tedlium": _tedlium, "gigaspeech": _gigaspeech, "librispeech": _librispeech,
           "common_voice": _common_voice, "earnings22": _earnings22}


def test_every_corpus_has_a_layout():
    assert sorted(LAYOUTS) == sorted(esb.PREPARERS) == sorted(jesb.PREPARERS)


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, n), root)
                  for d, _, names in os.walk(root) for n in names)


@pytest.mark.parametrize("corpus", sorted(LAYOUTS))
def test_prepare_corpus_to_tar_matches_jax(tmp_path, corpus, capsys):
    raw = tmp_path / "raw"
    split = LAYOUTS[corpus](raw)
    outs = {}
    for name, main in (("jax", jax_prepare.main), ("port", port_prepare.main)):
        outs[name] = tmp_path / name
        argv = ["--corpus", corpus, "--input", str(raw), "--output_dir", str(outs[name]),
                "--to_tar", "--shard_size", "2"]
        main(argv + (["--split", split] if split else []))
    said = capsys.readouterr().out
    assert "prepared" in said and "wrote" in said
    rows = {}
    for name, out in outs.items():
        text = (out / "manifest.jsonl").read_text(encoding="utf-8")
        rows[name] = [json.loads(line) for line in text.replace(str(out), "<out>").splitlines()]
    assert rows["port"] == rows["jax"] and len(rows["port"]) >= 1
    assert _files(outs["port"]) == _files(outs["jax"])
    assert "tar/transcript.tsv" in _files(outs["port"])
    for f in _files(outs["port"]):
        if f != "manifest.jsonl":
            assert (outs["port"] / f).read_bytes() == (outs["jax"] / f).read_bytes(), f


def test_manifest_only_without_to_tar(tmp_path):
    raw = tmp_path / "raw"
    _librispeech(raw)
    port_prepare.main(["--corpus", "librispeech", "--input", str(raw), "--output_dir",
                       str(tmp_path / "out")])
    assert _files(tmp_path / "out") == ["manifest.jsonl"]
    with pytest.raises(ValueError, match="unknown ESB corpus"):
        esb.prepare_corpus("switchboard", str(raw), str(tmp_path / "x"))


@pytest.mark.parametrize("fn", ["clean_tedlium", "clean_gigaspeech", "clean_earnings",
                                "clean_common_voice", "maybe_trim_suffix"])
def test_cleanup_functions_match_jax(fn):
    texts = ["hello <unk> it 's FINE  now (key-1)", "ignore_time_segment_in_scoring", "<unk>",
             "HELLO <COMMA> WORLD <PERIOD> <SIL>".lower(), "yes <questionmark>", "<sil>",
             "Revenue <noise> grew  10%", "<crosstalk>", '"Hello there"', 'a ""quoted"" word',
             "", "single", "hello world (key)"]
    for t in texts:
        assert getattr(esb, fn)(t) == getattr(jesb, fn)(t), (fn, t)


@pytest.mark.parametrize("byte_format", ["01", "10"])
def test_read_sphere_matches_jax(tmp_path, byte_format):
    samples = np.asarray([1, -2, 300, -400, 32767], np.int16)
    head = ("NIST_1A\n   1024\nsample_rate -i 8000\nsample_n_bytes -i 2\n"
            f"sample_coding -s3 pcm\nsample_byte_format -s2 {byte_format}\nend_head\n").encode()
    p = tmp_path / "x.sph"
    p.write_bytes(head + b" " * (1024 - len(head))
                  + samples.astype("<i2" if byte_format == "01" else ">i2").tobytes())
    assert esb.read_sphere(str(p)) == jesb.read_sphere(str(p))
    assert np.array_equal(np.frombuffer(esb.read_sphere(str(p))[0], "<i2"), samples)
