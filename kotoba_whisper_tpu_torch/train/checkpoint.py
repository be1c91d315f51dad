"""Checkpoint save / rotate / resume, and the HF-layout model export.

  - trainer state: model, optimizer and step in one torch file under
    `checkpoint-{step}-epoch-{epoch}` (the JAX package's directory names),
    with `save_total_limit` rotation of the sorted checkpoints and
    regex-based resume detection; the data loader's position is written
    beside it as data_state.json (train/loader.DataPosition);
  - model export: HF-named state dict (safetensors, npz where safetensors
    is missing) plus config.json and generation_config.json, loadable by
    the JAX package's `import_hf_model` unchanged.
"""
from __future__ import annotations

import dataclasses
import json
import os
import re
import shutil

import numpy as np
import torch

from kotoba_whisper_tpu_torch.core.config import LANG_TO_INDEX, SpecialTokens, WhisperConfig
from kotoba_whisper_tpu_torch.models.whisper import WhisperForConditionalGeneration

_CKPT_RE = re.compile(r"^checkpoint-(\d+)-epoch-(\d+)$")
STATE_NAME = "train_state.pt"


def checkpoint_name(step: int, epoch: int) -> str:
    return f"checkpoint-{step}-epoch-{epoch}"


def sorted_checkpoints(output_dir: str) -> list[str]:
    """Existing checkpoint dirs sorted by step."""
    if not os.path.isdir(output_dir):
        return []
    found = []
    for name in os.listdir(output_dir):
        m = _CKPT_RE.match(name)
        if m and os.path.isdir(os.path.join(output_dir, name)):
            found.append((int(m.group(1)), name))
    return [os.path.join(output_dir, n) for _, n in sorted(found)]


def rotate_checkpoints(output_dir: str, save_total_limit: int | None) -> None:
    """Delete the oldest checkpoints beyond the limit."""
    if save_total_limit is None or save_total_limit <= 0:
        return
    ckpts = sorted_checkpoints(output_dir)
    for path in ckpts[: max(0, len(ckpts) - save_total_limit)]:
        shutil.rmtree(path, ignore_errors=True)


def get_last_checkpoint(output_dir: str) -> tuple[str, int, int] | None:
    """(path, step, epoch) of the newest checkpoint, or None."""
    ckpts = sorted_checkpoints(output_dir)
    if not ckpts:
        return None
    m = _CKPT_RE.match(os.path.basename(ckpts[-1]))
    return ckpts[-1], int(m.group(1)), int(m.group(2))


def save_train_state(output_dir: str, state, epoch: int,
                     save_total_limit: int | None = None) -> str:
    """Save state (train/distill.TrainState: model, optimizer, step) to
    checkpoint-{step}-epoch-{epoch}/train_state.pt; returns the dir."""
    path = os.path.abspath(os.path.join(output_dir, checkpoint_name(state.step, epoch)))
    os.makedirs(path, exist_ok=True)
    tmp = os.path.join(path, STATE_NAME + ".tmp")
    torch.save({"model": state.model.state_dict(), "optimizer": state.optimizer.state_dict(),
                "step": state.step}, tmp)
    os.replace(tmp, os.path.join(path, STATE_NAME))
    rotate_checkpoints(output_dir, save_total_limit)
    return path


def load_train_state(path: str, state) -> None:
    """Restore model weights, optimizer state and step into `state`, in
    place (the tensors keep their device)."""
    dev = next(state.model.parameters()).device
    saved = torch.load(os.path.join(path, STATE_NAME), map_location=dev, weights_only=True)
    state.model.load_state_dict(saved["model"])
    state.optimizer.load_state_dict(saved["optimizer"])
    state.step = int(saved["step"])


# ---------------------------------------------------------------------------
# HF-layout model export / import
# ---------------------------------------------------------------------------

def _generation_config(cfg: WhisperConfig) -> dict:
    gen = {
        "decoder_start_token_id": cfg.decoder_start_token_id,
        "eos_token_id": cfg.eos_token_id,
        "pad_token_id": cfg.pad_token_id,
        "max_length": cfg.max_target_positions,
        "max_initial_timestamp_index": 50,
        "return_timestamps": True,
    }
    if cfg.vocab_size >= 51865:
        st = SpecialTokens.for_vocab(cfg.vocab_size)
        gen["no_timestamps_token_id"] = st.no_timestamps
        gen["is_multilingual"] = True
        gen["lang_to_id"] = {
            f"<|{code}|>": st.lang_begin + idx
            for code, idx in LANG_TO_INDEX.items() if idx < st.n_langs
        }
        gen["task_to_id"] = {"transcribe": st.transcribe, "translate": st.translate}
    return gen


def export_hf_model(path: str, model: WhisperForConditionalGeneration, cfg: WhisperConfig,
                    generation_defaults: dict | None = None) -> None:
    """HF-layout export: model.safetensors (fp32; the tied proj_out is not
    written twice) or model.npz, config.json, generation_config.json."""
    os.makedirs(path, exist_ok=True)
    sd = {k: v.detach().float().cpu().numpy() for k, v in model.state_dict().items()}
    cfg_dict = dataclasses.asdict(cfg)
    cfg_dict["model_type"] = "whisper"
    cfg_dict["architectures"] = ["WhisperForConditionalGeneration"]
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(cfg_dict, f, indent=2)
    gen = _generation_config(cfg)
    gen.update(generation_defaults or {})
    with open(os.path.join(path, "generation_config.json"), "w") as f:
        json.dump(gen, f, indent=2)
    try:
        from safetensors.numpy import save_file
    except ImportError:
        sd["proj_out.weight"] = sd["model.decoder.embed_tokens.weight"]
        np.savez(os.path.join(path, "model.npz"), **sd)
        return
    save_file(sd, os.path.join(path, "model.safetensors"))


def import_hf_model(path: str) -> tuple[WhisperForConditionalGeneration, WhisperConfig]:
    """An export (or an HF checkpoint dir) -> (fp32 model on the CPU, cfg)."""
    from kotoba_whisper_tpu_torch.models.convert import load_checkpoint

    return load_checkpoint(path)
