"""Stage-5 driver (v3): bilingual / multi-task distillation on one card.

N datasets zipped a step, each at its own sub-batch, per-(task, language)
CE, KL only where a dataset asks for it, one student encoder pass per
dataset's audio (train/distill_multitask.py owns the loss). The flags
mirror the JAX driver's; --device cpu runs the plain twins on the CPU in
either --dtype, and --dtype float32 on the card raises (K5, the attention
backward, takes bfloat16; its fp32 form is not ported yet).

Dataset spec syntax (repeatable):
  --dataset name:dir:key1+key2:kl     e.g. ja:/work/ja:transcribe.ja+translate.en:kl
  --dataset name:dir:key1:nokl        e.g. en:/work/en:transcribe.en:nokl
where `dir` holds features.npz + filtered.jsonl with labels/<key> columns
(cli/data_filter.py --label_column with a comma list). `dir` may be a
comma-joined group of such dirs, whose rows and features are
concatenated. Each epoch draws one permutation a dataset from
default_rng(seed), in dataset order; the epoch has as many steps as the
smallest dataset has batches.

Usage:
  python -m kotoba_whisper_tpu_torch distill-bilingual \
      --dataset ja:work/ja:transcribe.ja+translate.en:kl \
      --dataset en:work/en:transcribe.en:nokl \
      --student student/ --teacher teacher/ --output_dir run/
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--dataset", action="append", required=True,
                    help="name:dir:key1+key2:kl|nokl (repeatable)")
    ap.add_argument("--student", required=True)
    ap.add_argument("--teacher", required=True)
    ap.add_argument("--output_dir", required=True)
    ap.add_argument("--tokenizer", default="byte")
    ap.add_argument("--per_dataset_batch_size", type=int, default=4)
    ap.add_argument("--learning_rate", type=float, default=1e-4)
    ap.add_argument("--warmup_steps", type=int, default=500)
    ap.add_argument("--num_train_epochs", type=int, default=1)
    ap.add_argument("--max_steps", type=int, default=-1)
    ap.add_argument("--max_label_length", type=int, default=128)
    ap.add_argument("--temperature", type=float, default=2.0)
    ap.add_argument("--kl_weight", type=float, default=1.0)
    ap.add_argument("--logging_steps", type=int, default=25)
    ap.add_argument("--save_total_limit", type=int, default=1)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--dtype", default="bfloat16", choices=["bfloat16", "float32"])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; with no card and no --device cpu "
                    "the driver raises")
    return ap


def load_datasets(spec_strs: list[str], common):
    """--dataset strings -> (specs, [(rows, features)]) in spec order."""
    from kotoba_whisper_tpu_torch.train.distill_multitask import DatasetSpec

    specs, data = [], []
    for spec_str in spec_strs:
        name, d, keys, kl = spec_str.split(":")
        if kl not in ("kl", "nokl"):
            raise SystemExit(f"--dataset {spec_str}: the last field is kl or nokl")
        rows, feat_parts = [], []
        for part in d.split(","):
            rows.extend(common.read_jsonl(f"{part}/filtered.jsonl"))
            feat_parts.append(np.load(f"{part}/features.npz")["input_features"])
        feats = feat_parts[0] if len(feat_parts) == 1 else np.concatenate(feat_parts, axis=0)
        if len(rows) != feats.shape[0]:
            raise SystemExit(f"{name}: {len(rows)} label rows, {feats.shape[0]} features")
        specs.append(DatasetSpec(name, tuple(keys.split("+")), use_kl=kl == "kl"))
        data.append((rows, feats))
    return tuple(specs), data


def main(argv=None) -> None:
    arg = _parser().parse_args(argv)

    from kotoba_whisper_tpu_torch.cli import common
    from kotoba_whisper_tpu_torch.core.device import resolve_device
    from kotoba_whisper_tpu_torch.data.collator import CollatorConfig, collate_labels
    from kotoba_whisper_tpu_torch.train import checkpoint, distill, optim
    from kotoba_whisper_tpu_torch.train.distill_multitask import make_multitask_train_step
    from kotoba_whisper_tpu_torch.train.logging import MetricLogger

    dev = resolve_device(arg.device)
    if dev.type == "cuda" and arg.dtype != "bfloat16":
        raise SystemExit(f"distill_bilingual: --dtype {arg.dtype} on the card (K5's fp32 "
                         "form) is not ported yet")
    compute_dtype = torch.bfloat16 if arg.dtype == "bfloat16" else torch.float32
    specs, data = load_datasets(arg.dataset, common)
    common.load_tokenizer(arg.tokenizer)  # validates the spec, as the JAX driver does

    student, s_cfg = common.load_model(arg.student, dev, torch.float32)
    teacher, t_cfg = common.load_model(arg.teacher, dev, compute_dtype)
    teacher.requires_grad_(False)
    dc = distill.DistillConfig(
        kl_weight=arg.kl_weight,
        temperature=arg.temperature,
        freeze_encoder=True,
        share_hidden_states=s_cfg.d_model == t_cfg.d_model,
        compute_dtype=compute_dtype,
    )
    distill.freeze_encoder_(student)
    opt, sched = optim.make_optimizer(student, lr=arg.learning_rate,
                                      warmup_steps=arg.warmup_steps)
    state = distill.TrainState(student, opt)
    step_fn = make_multitask_train_step(dc, specs, sched, device=dev)

    ccfg = CollatorConfig(
        max_target_length=arg.max_label_length,
        decoder_start_token_id=s_cfg.decoder_start_token_id,
        pad_token_id=s_cfg.pad_token_id,
    )
    b = arg.per_dataset_batch_size
    steps_per_epoch = min(len(rows) // b for rows, _ in data)
    if steps_per_epoch == 0:
        raise SystemExit("a dataset is smaller than the per-dataset batch")

    def to_dev(a: np.ndarray, dtype=torch.long) -> torch.Tensor:
        return torch.from_numpy(np.asarray(a)).to(dev, dtype)

    logger = MetricLogger(arg.output_dir, run_name="bilingual")
    rng = np.random.default_rng(arg.seed)
    t_last = time.time()
    epoch = 0
    for epoch in range(arg.num_train_epochs):
        orders = [rng.permutation(len(rows)) for rows, _ in data]
        for k in range(steps_per_epoch):
            batches = []
            for (rows, feats), order, spec in zip(data, orders, specs):
                idx = order[k * b:(k + 1) * b]
                tasks = {}
                for key in spec.task_keys:
                    lab = collate_labels([rows[i][f"labels/{key}"] for i in idx], ccfg)
                    tasks[key] = {"labels": to_dev(lab["labels"]),
                                  "decoder_input_ids": to_dev(lab["decoder_input_ids"])}
                batches.append({"input_features": to_dev(feats[idx], compute_dtype),
                                "tasks": tasks})
            metrics = step_fn(state, teacher, batches)
            if state.step % arg.logging_steps == 0:
                m = {k2: float(v) for k2, v in metrics.items()}
                m["epoch"] = epoch
                m["time"] = time.time() - t_last
                t_last = time.time()
                logger.log(m, state.step)
                print(f"step {state.step}: loss={m['loss']:.4g} " + " ".join(
                    f"{k2}={v:.3g}" for k2, v in m.items() if k2.startswith("ce_loss.")))
            if arg.max_steps > 0 and state.step >= arg.max_steps:
                break
        else:
            continue
        break

    checkpoint.save_train_state(arg.output_dir, state, epoch, arg.save_total_limit)
    checkpoint.export_hf_model(f"{arg.output_dir}/final", state.model, s_cfg)
    print(f"bilingual training done at step {state.step} -> {arg.output_dir}/final")


if __name__ == "__main__":
    main()
