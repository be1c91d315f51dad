"""Stage-5 driver: distillation training, on one card or data parallel.

Streams the sharded feature splits (data/shards.py) through the epochs x
splits schedule (train/loader.py), runs the CE + KL distillation step
(train/distill.py: frozen shared encoder, remat student decoder, teacher
decoder without grad, microbatch accumulation, clip + AdamW), saves,
rotates and resumes checkpoints with the exact data position, logs the
JAX driver's metric names (train/loss|ce_loss|kl_loss|grad_norm|
learning_rate|time) and exports the student in HF layout at the end.

The flags mirror the JAX driver's. Not ported (they raise): wandb, and
--dtype float32 on the card (K5, the attention backward, takes bfloat16;
its fp32 form is not ported yet). On the CPU (--device cpu) float32 runs
through the kernels' plain twins.

Parallel runs, one process a card: --num_devices N takes N cards of this
host (default: every card; one process with --device cpu), a mesh of
N / M data ranks by --mesh_model_axis M, the teacher's heads over M cards
and the student replicated; --coordinator_address --num_processes P
--process_id i joins P hosts into one data-parallel job. Each step trains
on per_device_train_batch_size x data ranks rows: each host takes its
slice of every shuffled split, each rank its rows of the host's batch
(train/loader.py), and the step's means and gradients are the global
batch's (train/distill.py). The first rank logs, saves, rotates and
exports; every rank resumes from the same checkpoint and data position.

Usage:
  python -m kotoba_whisper_tpu_torch.cli.distill \
      --train_splits data/ --student student/ --teacher teacher/ \
      --output_dir run/ --per_device_train_batch_size 8
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--data_dir", default=None,
                    help="single split dir (alias for --train_splits with one split)")
    ap.add_argument("--train_splits", default=None,
                    help="a dir holding split_N subdirs, a comma list of dirs, or one dir")
    ap.add_argument("--student", required=True)
    ap.add_argument("--teacher", required=True)
    ap.add_argument("--output_dir", required=True)
    ap.add_argument("--tokenizer", default="byte")
    ap.add_argument("--per_device_train_batch_size", type=int, default=8)
    ap.add_argument("--gradient_accumulation_steps", type=int, default=1)
    ap.add_argument("--learning_rate", type=float, default=1e-4)
    ap.add_argument("--warmup_steps", type=int, default=500)
    ap.add_argument("--lr_scheduler_type", default="constant_with_warmup")
    ap.add_argument("--num_train_epochs", type=int, default=1)
    ap.add_argument("--max_steps", type=int, default=-1)
    ap.add_argument("--max_label_length", type=int, default=128)
    ap.add_argument("--temperature", type=float, default=2.0)
    ap.add_argument("--kl_weight", type=float, default=1.0)
    ap.add_argument("--freeze_encoder", action="store_true", default=True)
    ap.add_argument("--no_freeze_encoder", dest="freeze_encoder", action="store_false")
    ap.add_argument("--save_steps", type=int, default=500)
    ap.add_argument("--save_total_limit", type=int, default=1)
    ap.add_argument("--logging_steps", type=int, default=25)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--dtype", default="bfloat16", choices=["bfloat16", "float32"])
    ap.add_argument("--mesh_model_axis", type=int, default=1,
                    help="tensor-parallel factor for the teacher")
    ap.add_argument("--num_devices", type=int, default=None,
                    help="cards of this host (default: all; 1 with --device cpu)")
    ap.add_argument("--no_prefetch", action="store_true",
                    help="disable the batch-assembly and next-split prefetch threads")
    ap.add_argument("--resume_from_checkpoint", action="store_true", default=True)
    ap.add_argument("--no_resume", dest="resume_from_checkpoint", action="store_false")
    ap.add_argument("--wandb_project", default=None)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; with no card and no --device cpu "
                    "the driver raises")
    from kotoba_whisper_tpu_torch.cli.common import add_distributed_flags

    add_distributed_flags(ap)
    return ap


def _check_ported(arg, dev: torch.device) -> None:
    unported = [
        (arg.wandb_project is not None, "--wandb_project"),
        (dev.type == "cuda" and arg.dtype != "bfloat16",
         f"--dtype {arg.dtype} on the card (K5's fp32 form)"),
    ]
    for bad, what in unported:
        if bad:
            raise SystemExit(f"distill: {what} is not ported yet")


def main(argv=None) -> None:
    ap = _parser()
    arg = ap.parse_args(argv)
    if not (arg.data_dir or arg.train_splits):
        ap.error("one of --data_dir / --train_splits is required")
    from kotoba_whisper_tpu_torch.cli import common

    local = arg.num_devices or (torch.cuda.device_count() if arg.device.startswith("cuda")
                                else 1)
    common.launch(_run, arg, max(local, 1))


def _run(arg, dev: torch.device) -> None:
    """One rank's run (the only one on one card)."""
    from kotoba_whisper_tpu_torch.cli import common
    from kotoba_whisper_tpu_torch.core.mesh import DATA_AXIS, MeshConfig, build_mesh
    from kotoba_whisper_tpu_torch.data.collator import CollatorConfig, collate_labels
    from kotoba_whisper_tpu_torch.data.shards import resolve_split_dirs
    from kotoba_whisper_tpu_torch.parallel import multihost, sharded
    from kotoba_whisper_tpu_torch.train import checkpoint, distill, optim
    from kotoba_whisper_tpu_torch.train.loader import DataPosition, ScheduleLoader
    from kotoba_whisper_tpu_torch.train.logging import MetricLogger

    _check_ported(arg, dev)
    compute_dtype = torch.bfloat16 if arg.dtype == "bfloat16" else torch.float32

    split_dirs = resolve_split_dirs(arg.train_splits or arg.data_dir)
    common.load_tokenizer(arg.tokenizer)  # validates the spec, as the JAX driver does
    student, s_cfg = common.load_model(arg.student, dev, torch.float32)
    teacher, t_cfg = common.load_model(arg.teacher, dev, compute_dtype)
    teacher.requires_grad_(False)

    # the job's mesh: data ranks over every host, the teacher's heads over
    # --mesh_model_axis cards; the student is replicated
    hosts, main = multihost.host_count(), multihost.is_main_process()
    mesh, rank_slice, data_group = None, (0, 1), None
    if multihost.process_count() > 1:
        mesh = build_mesh(MeshConfig(data=-1, model=arg.mesh_model_axis), dev.type)
        teacher = sharded.place_params(mesh, teacher, model_sharded=arg.mesh_model_axis > 1)
        sharded.replicate(student)
        rank_slice, data_group = sharded.data_coords(mesh, hosts), mesh.get_group(DATA_AXIS)
    elif arg.mesh_model_axis > 1:
        raise SystemExit(f"--mesh_model_axis {arg.mesh_model_axis} needs as many cards")
    n_data = multihost.process_count() // arg.mesh_model_axis
    global_batch = arg.per_device_train_batch_size * n_data
    loader = ScheduleLoader(split_dirs, seed=arg.seed, global_batch=global_batch,
                            num_epochs=arg.num_train_epochs, process_index=multihost.host_index(),
                            process_count=hosts, rank_slice=rank_slice,
                            microbatches=arg.gradient_accumulation_steps,
                            prefetch=not arg.no_prefetch)
    for s in range(len(split_dirs)):
        if loader.batches_in_split(s) == 0:
            raise SystemExit(f"split {split_dirs[s]} has {loader.split_size(s)} rows < "
                             f"global batch {global_batch} ({arg.per_device_train_batch_size}"
                             f"/device x {n_data} data ranks); shrink the batch or "
                             f"--num_devices")
    steps_per_epoch = loader.steps_per_epoch()

    dc = distill.DistillConfig(
        kl_weight=arg.kl_weight,
        temperature=arg.temperature,
        freeze_encoder=arg.freeze_encoder,
        share_hidden_states=arg.freeze_encoder and s_cfg.d_model == t_cfg.d_model,
        num_microbatches=arg.gradient_accumulation_steps,
        compute_dtype=compute_dtype,
    )
    if dc.freeze_encoder:
        distill.freeze_encoder_(student)
    opt, sched = optim.make_optimizer(
        student, lr=arg.learning_rate, warmup_steps=arg.warmup_steps,
        schedule=arg.lr_scheduler_type,
        total_steps=arg.max_steps if arg.max_steps > 0 else None,
    )
    state = distill.TrainState(student, opt)
    step_fn = distill.make_train_step(dc, sched, device=dev, data_group=data_group)

    pos = DataPosition()
    last = checkpoint.get_last_checkpoint(arg.output_dir)
    if arg.resume_from_checkpoint and last is not None:
        path, resumed_step, start_epoch = last
        checkpoint.load_train_state(path, state)
        saved = DataPosition.load(path)
        if saved is not None:
            pos = saved
        elif steps_per_epoch > 0:
            # a checkpoint without data_state.json: derive from the step
            pos = DataPosition(start_epoch, 0, resumed_step - start_epoch * steps_per_epoch)
        if main:
            print(f"resumed from {path} (step {resumed_step}, {pos})")

    logger = MetricLogger(arg.output_dir if main else None)
    ccfg = CollatorConfig(
        max_target_length=arg.max_label_length,
        decoder_start_token_id=s_cfg.decoder_start_token_id,
        pad_token_id=s_cfg.pad_token_id,
    )

    def save(pos_next: DataPosition) -> None:
        if main:
            ck = checkpoint.save_train_state(arg.output_dir, state, pos_next.epoch,
                                             arg.save_total_limit)
            pos_next.save(ck)
        multihost.barrier("ckpt_saved")

    t_last = time.time()
    last_pos = pos
    for bpos, rows_b, feats_b in loader.batches(pos):
        lab = collate_labels([r["labels"] for r in rows_b], ccfg)
        batch = {
            "input_features": torch.from_numpy(np.asarray(feats_b)).to(dev, compute_dtype),
            "labels": torch.from_numpy(lab["labels"]).long().to(dev),
            "decoder_input_ids": torch.from_numpy(lab["decoder_input_ids"]).long().to(dev),
        }
        metrics = step_fn(state, teacher, batch)
        last_pos = bpos
        if state.step % arg.logging_steps == 0:
            metrics = {k: float(v) for k, v in metrics.items()}
            metrics["epoch"] = bpos.epoch
            metrics["split"] = bpos.split
            metrics["time"] = time.time() - t_last
            t_last = time.time()
            logger.log(metrics, state.step)
            if main:
                print(f"step {state.step}: "
                      + ", ".join(f"{k}={v:.4g}" for k, v in metrics.items()))
        if state.step % arg.save_steps == 0:
            save(loader.next_position(bpos))
        if arg.max_steps > 0 and state.step >= arg.max_steps:
            break

    save(loader.next_position(last_pos))
    if main:
        checkpoint.export_hf_model(f"{arg.output_dir}/final", state.model, s_cfg)
        print(f"training done at step {state.step}; model exported to {arg.output_dir}/final")
    multihost.barrier("export_done")


if __name__ == "__main__":
    main()
