"""Stage-6 driver: latency benchmark on deterministic dummy audio.

Counterpart of run_speed_eval.py: durations, mean/std over trials with
warmup discard, appended to eval_pipeline/runtime_pipeline.jsonl. The
flags mirror the JAX driver's, less --attn: the device decides what runs
(the kernels on the card, their plain twins on the CPU), and --device is
the port's.

Usage:
  python -m kotoba_whisper_tpu_torch.cli.eval_speed \
      --model preset:distil-large-v3 --tokenizer byte:51866 --max_length 32 \
      --kv_dtype int8 --gemm_dtype int8 --wire_dtype int16
"""
from __future__ import annotations

import argparse


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--model", required=True)
    ap.add_argument("--tokenizer", default="byte")
    ap.add_argument("--durations", default="10,30,60,300")
    ap.add_argument("--n_trials", type=int, default=5)
    ap.add_argument("--chunk_length_s", type=float, default=15.0)
    ap.add_argument("--output", default="eval_pipeline/runtime_pipeline.jsonl")
    ap.add_argument("--dtype", default="bfloat16", choices=["bfloat16", "float32"])
    ap.add_argument("--kv_dtype", default="compute",
                    choices=["compute", "int8", "int4"])
    ap.add_argument("--gemm_dtype", default="compute",
                    choices=["compute", "int8"],
                    help="int8: w8a8 dense projections (models/quantized.py)")
    ap.add_argument("--no_fuse", action="store_true",
                    help="skip the lossless inference projection fusion")
    ap.add_argument("--wire_dtype", default="float32",
                    choices=["float32", "int16"],
                    help="int16: ship PCM samples to the device and "
                    "normalize there (lossless for PCM-sourced audio; see "
                    "decode/pipeline.py)")
    ap.add_argument("--max_length", type=int, default=128,
                    help="decode token budget per 15 s chunk. With random "
                    "weights (preset: models) the decode runs to this "
                    "budget, so it sets the measured decode length; the "
                    "table states it per row")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; with no card and no --device cpu "
                    "the driver raises")
    arg = ap.parse_args(argv)

    from kotoba_whisper_tpu_torch.cli import common
    from kotoba_whisper_tpu_torch.core.device import resolve_device
    from kotoba_whisper_tpu_torch.eval.speed import evaluate_speed

    dev = resolve_device(arg.device)
    pipe = common.serving_pipeline(arg, dev, max_length=arg.max_length,
                                   wire_dtype=arg.wire_dtype)
    records = evaluate_speed(
        pipe.transcribe,
        model_name=arg.model,
        durations=[float(d) for d in arg.durations.split(",")],
        n_trials=arg.n_trials,
        output_path=arg.output,
        device=dev,
        extra={
            "max_length": arg.max_length,
            "kv_dtype": arg.kv_dtype,
            "gemm_dtype": arg.gemm_dtype,
            "chunk_length_s": arg.chunk_length_s,
            **({"wire_dtype": "int16"} if arg.wire_dtype == "int16" else {}),
        },
    )
    for r in records:
        print(r)


if __name__ == "__main__":
    main()
