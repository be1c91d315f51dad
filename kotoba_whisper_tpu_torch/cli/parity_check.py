"""Parity check against the reference stack on real weights.

Given a local HF-format Whisper checkpoint (config.json + safetensors +
vocab.json/merges.txt) and an audio file, runs BOTH stacks offline and
compares:

  1. log-mel features (ours vs WhisperFeatureExtractor),
  2. encoder states and first-step logits (ours vs torch forward),
  3. greedy tokens with timestamps (ours vs generate()),

printing per-stage max deviations and token diffs, and exits 0 on a
token-exact match, 1 otherwise. This is the "token-for-token vs reference
greedy" gate of SURVEY §7.2 packaged as a tool; it runs wherever
checkpoints and `transformers` exist.

"Ours" is the port: ops/mel, models/whisper.encode / forward and
decode/greedy.generate_greedy in fp32 on --device (the card unless
--device cpu), the model loaded through cli/common.load_model. The HF
model runs on the CPU. The printed lines are the JAX package's
parity_check's.

Usage:
  python -m kotoba_whisper_tpu_torch parity-check \\
      --checkpoint /models/whisper-tiny --audio sample.wav --language ja
"""
from __future__ import annotations

import argparse


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--checkpoint", required=True)
    ap.add_argument("--audio", required=True)
    ap.add_argument("--language", default="ja")
    ap.add_argument("--task", default="transcribe")
    ap.add_argument("--max_length", type=int, default=128)
    ap.add_argument("--tokenizer", default=None,
                    help="tokenizer spec (default: the checkpoint dir's "
                    "vocab.json/merges.txt; 'byte' for vocab-free "
                    "rehearsals)")
    ap.add_argument("--device", default="cuda",
                    help="where ours runs: cuda (default) or cpu")
    arg = ap.parse_args(argv)

    import numpy as np
    import torch
    import transformers as trf

    from kotoba_whisper_tpu_torch.cli import common
    from kotoba_whisper_tpu_torch.core.config import FeatureConfig
    from kotoba_whisper_tpu_torch.core.device import resolve_device
    from kotoba_whisper_tpu_torch.decode.greedy import GenerateOptions, generate_greedy
    from kotoba_whisper_tpu_torch.models import whisper
    from kotoba_whisper_tpu_torch.ops.mel import log_mel_spectrogram, pad_or_trim
    from kotoba_whisper_tpu_torch.utils import native

    dev = resolve_device(arg.device)
    with open(arg.audio, "rb") as f:
        audio, _ = native.decode_audio(f.read(), 16000)

    model, cfg = common.load_model(arg.checkpoint, dev, torch.float32)
    tok = common.load_tokenizer(arg.tokenizer or arg.checkpoint)
    st = tok.special
    feat = FeatureConfig(n_mels=cfg.num_mel_bins)

    # --- stage 1: features ---
    hf_fe = trf.WhisperFeatureExtractor(feature_size=cfg.num_mel_bins)
    golden_mel = hf_fe(audio, sampling_rate=16000, return_tensors="np")[
        "input_features"
    ]
    ours_mel = log_mel_spectrogram(
        pad_or_trim(audio[None], feat.n_samples), feat, device=dev
    )
    print(f"[mel] max|Δ| = {np.abs(ours_mel.cpu().numpy() - golden_mel).max():.2e}")

    # --- stage 2: forward logits ---
    hf_model = trf.WhisperForConditionalGeneration.from_pretrained(
        arg.checkpoint
    ).eval()
    prompt = tok.sot_sequence(arg.language, arg.task)
    with torch.no_grad():
        enc_hf = hf_model.model.encoder(
            torch.from_numpy(golden_mel)
        ).last_hidden_state.numpy()
        logits_hf = hf_model(
            input_features=torch.from_numpy(golden_mel),
            decoder_input_ids=torch.tensor([prompt]),
        ).logits.numpy()
        enc_ours = whisper.encode(model, golden_mel, device=dev).cpu().numpy()
        logits_ours, _ = whisper.forward(
            model, golden_mel, torch.tensor([prompt]), device=dev
        )
    print(f"[encoder] max|Δ| = {np.abs(enc_ours - enc_hf).max():.2e}")
    print(f"[logits]  max|Δ| = {np.abs(logits_ours.cpu().numpy() - logits_hf).max():.2e}")

    # --- stage 3: greedy tokens ---
    gen_defaults = common.load_generation_defaults(arg.checkpoint)
    opts = GenerateOptions(
        prompt_ids=tuple(prompt), max_length=arg.max_length, **gen_defaults
    )
    ours_tokens = generate_greedy(model, ours_mel, opts, st, device=dev)[0].tolist()
    if st.eot in ours_tokens:
        ours_tokens = ours_tokens[: ours_tokens.index(st.eot) + 1]
    with torch.no_grad():
        hf_tokens = hf_model.generate(
            torch.from_numpy(golden_mel),
            language=arg.language,
            task=arg.task,
            return_timestamps=True,
            max_length=arg.max_length,
            num_beams=1,
            do_sample=False,
        )[0].tolist()
    ours_gen = ours_tokens[len(prompt):]
    hf_gen = [t for t in hf_tokens if t not in prompt][: len(ours_gen)] \
        if hf_tokens[: len(prompt)] == list(prompt) else hf_tokens
    match = ours_gen == hf_gen[: len(ours_gen)]
    print(f"[greedy] ours: {tok.decode(ours_tokens, decode_with_timestamps=True)!r}")
    print(f"[greedy] token-exact match: {match}")
    if not match:
        print(f"  ours ids: {ours_gen[:40]}")
        print(f"  hf   ids: {hf_gen[:40]}")
    raise SystemExit(0 if match else 1)


if __name__ == "__main__":
    main()
