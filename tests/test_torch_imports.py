"""Boundary checks of the PyTorch port.

- Importing every module of kotoba_whisper_tpu_torch pulls in neither JAX
  nor the JAX package (checked in a fresh interpreter).
- The port's sources and chip_smoke.py import neither; the port calls no
  library attention (scaled_dot_product_attention) and no torch.compile
  (chip_smoke.py may time SDPA as a yardstick, never through the port).
- Entry points asked for the card on a machine without one raise.
"""
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parent.parent
PORT = REPO / "kotoba_whisper_tpu_torch"
MODULES = sorted(
    ".".join(p.relative_to(REPO).with_suffix("").parts)
    for p in PORT.rglob("*.py") if p.name != "__init__.py"
)
JAX_IMPORT = re.compile(r"^\s*(import jax\b|from jax\b)", re.M)
JAX_PKG_IMPORT = re.compile(r"^\s*(import|from)\s+kotoba_whisper_tpu(?!_torch)\b", re.M)


def test_port_modules_import_without_jax():
    code = (
        "import importlib, sys\n"
        f"for m in {MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "             or m == 'kotoba_whisper_tpu' or m.startswith('kotoba_whisper_tpu.'))\n"
        "print(len(sys.modules)); assert not bad, bad\n"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
    assert len(MODULES) >= 15


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(REPO)))
def test_sources_keep_to_the_port(path):
    text = path.read_text()
    assert not JAX_IMPORT.search(text), "imports jax"
    assert not JAX_PKG_IMPORT.search(text), "imports the JAX package"
    assert "torch.compile" not in text
    if path.name != "chip_smoke.py":
        assert "scaled_dot_product_attention" not in text


def test_port_tools_are_covered():
    """The port's experiment tools are modules of the package, so the
    import check above and the source checks below take them in."""
    assert {f"kotoba_whisper_tpu_torch.tools.{name}" for name in (
        "enc_exp", "stem_exp", "vpu_cal", "matmul_cal", "train_exp", "dec_exp", "beam_exp",
        "stream_exp", "stream_ab", "speed_decomp")} <= set(MODULES)


# where the TPU kernels live: the JAX package's ops, and the calibration
# loop of the JAX experiment tools (K9)
TPU_KERNEL_FILES = re.compile(r"kotoba_whisper_tpu/ops/\w+\.py|tools/vpu_cal\.py")


def test_cuda_sources_have_their_notes():
    """Each kernel source names the TPU kernel it replaces (a file that
    exists) and what bounds it on the card, and every source the build
    compiles is among them."""
    from kotoba_whisper_tpu_torch.ops import _build

    sources = sorted((PORT / "csrc").glob("*.cu"))
    assert {cu.stem for cu in sources} == set(_build.SOURCES)
    # K1 and K4 share flash_attention_sm90.cu (bf16) and flash_attention_f32.cu (fp32);
    # K5 and K7 have an fp32 source of their own
    assert set(_build.SOURCES) == {
        "flash_attention_sm90", "flash_attention_f32", "flash_attention_bwd",
        "flash_attention_bwd_f32", "decode_attention", "decode_attention_ring",
        "decode_attention_beam", "mel", "layer_norm", "conv_stem", "conv_stem_f32",
        "flash_attention_int8", "vpu_cal"}
    for cu in sources:
        head = cu.read_text()[:3000]
        replaced = head[head.index("Replaces:"):] if "Replaces:" in head else ""
        m = TPU_KERNEL_FILES.search(replaced[:300])
        assert m and (REPO / m.group(0)).is_file(), cu.name
        assert "What bounds it on the card" in head, cu.name
        assert "Design:" in head, cu.name


def test_entry_points_raise_without_a_card(monkeypatch, tmp_path):
    from kotoba_whisper_tpu_torch.cli import (
        create_student, distill, eval_short_form, eval_speed, pseudo_label,
    )
    from kotoba_whisper_tpu_torch.core.config import PRESETS, SpecialTokens
    from kotoba_whisper_tpu_torch.decode.greedy import GenerateOptions, generate_greedy
    from kotoba_whisper_tpu_torch.decode.pipeline import AsrPipeline
    from kotoba_whisper_tpu_torch.models.whisper import forward, init_params
    from kotoba_whisper_tpu_torch.ops.mel import log_mel_spectrogram
    from kotoba_whisper_tpu_torch.tokenizer.whisper_tokenizer import WhisperTokenizer
    from kotoba_whisper_tpu_torch.train.distill import DistillConfig, make_train_step

    cfg = PRESETS["test-byte"]
    model = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    st = SpecialTokens.layout(256, 99)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        generate_greedy(model, torch.zeros(1, 80, 3000),
                        GenerateOptions(prompt_ids=(st.sot,), max_length=4), st)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        log_mel_spectrogram(torch.zeros(1, 480000))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pseudo_label.main(["--dataset_dir", str(tmp_path), "--output_dir", str(tmp_path)])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        forward(model, torch.zeros(1, 80, 3000), torch.zeros(1, 4, dtype=torch.long))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_train_step(DistillConfig())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        create_student.main(["--teacher", "preset:test-byte", "--save_dir", str(tmp_path)])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        distill.main(["--data_dir", str(tmp_path), "--student", "preset:test-byte",
                      "--teacher", "preset:test-byte", "--output_dir", str(tmp_path)])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        AsrPipeline(model=model, tok=WhisperTokenizer.byte_vocab())(np.zeros(16000, np.float32))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        eval_short_form.main(["--model", "preset:test-byte", "--dataset_dir", str(tmp_path)])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        eval_speed.main(["--model", "preset:test-byte", "--durations", "1"])
