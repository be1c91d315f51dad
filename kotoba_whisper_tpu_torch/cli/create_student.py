"""Stage-4 driver: initialise a student from a teacher checkpoint.

Maximally spaced layer selection (models/student_init.py), export in HF
layout, then reload the export and run a dummy forward pass (30 s of ones)
as a sanity check, as the JAX driver does. The flags mirror the JAX
driver's; --device and --dtype (the check's compute dtype: bfloat16, or
float32 through the kernels' fp32 forms on the card) are the port's.

Usage:
  python -m kotoba_whisper_tpu_torch.cli.create_student \
      --teacher preset:large-v3 --save_dir student/ --decoder_layers 2
"""
from __future__ import annotations

import argparse

import torch


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--teacher", required=True, help="'preset:<name>' or checkpoint dir")
    ap.add_argument("--save_dir", required=True)
    ap.add_argument("--encoder_layers", type=int, default=None)
    ap.add_argument("--decoder_layers", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--dtype", default="bfloat16", choices=["bfloat16", "float32"],
                    help="compute dtype of the reload check")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; with no card and no --device cpu "
                    "the driver raises")
    arg = ap.parse_args(argv)

    from kotoba_whisper_tpu_torch.cli import common
    from kotoba_whisper_tpu_torch.core.device import resolve_device
    from kotoba_whisper_tpu_torch.models import whisper
    from kotoba_whisper_tpu_torch.models.student_init import init_student_from_teacher
    from kotoba_whisper_tpu_torch.train.checkpoint import export_hf_model, import_hf_model

    dev = resolve_device(arg.device)
    dtype = torch.bfloat16 if arg.dtype == "bfloat16" else torch.float32

    teacher, t_cfg = common.load_model(arg.teacher, dev, torch.float32, seed=arg.seed)
    student, s_cfg = init_student_from_teacher(
        teacher, t_cfg, encoder_layers=arg.encoder_layers, decoder_layers=arg.decoder_layers,
    )
    n_teacher = sum(p.numel() for p in teacher.parameters())
    del teacher
    export_hf_model(arg.save_dir, student, s_cfg)
    del student

    # reload + dummy forward sanity check
    model, cfg = import_hf_model(arg.save_dir)
    model = model.to(dev)
    mel = torch.ones((1, cfg.num_mel_bins, 2 * cfg.max_source_positions), device=dev)
    ids = torch.full((1, 4), cfg.decoder_start_token_id, dtype=torch.long, device=dev)
    with torch.no_grad():
        logits, _ = whisper.forward(model, mel, ids, compute_dtype=dtype, device=dev)
    if not bool(torch.isfinite(logits).all()):
        raise SystemExit("create_student: the dummy forward produced non-finite logits")
    print(
        f"student saved to {arg.save_dir}: "
        f"{t_cfg.encoder_layers}+{t_cfg.decoder_layers} -> "
        f"{cfg.encoder_layers}+{cfg.decoder_layers} layers, "
        f"{sum(p.numel() for p in model.parameters()):,} params (teacher {n_teacher:,})"
    )


if __name__ == "__main__":
    main()
