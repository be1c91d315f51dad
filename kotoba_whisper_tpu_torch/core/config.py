"""Model / feature configuration tree.

The port's own copy of the architecture hyper-parameters, the Whisper
special-token layout and the log-mel frontend settings. Field names follow
HF WhisperConfig so checkpoint metadata ports over directly.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass


@dataclass(frozen=True)
class WhisperConfig:
    """Architecture hyper-parameters for a Whisper encoder-decoder."""

    vocab_size: int = 51865
    num_mel_bins: int = 80
    d_model: int = 384
    encoder_layers: int = 4
    encoder_attention_heads: int = 6
    decoder_layers: int = 4
    decoder_attention_heads: int = 6
    encoder_ffn_dim: int = 1536
    decoder_ffn_dim: int = 1536
    max_source_positions: int = 1500   # encoder frames after conv stem (30 s)
    max_target_positions: int = 448    # learned decoder positions
    activation_function: str = "gelu"

    # Special token ids (multilingual layout; see SpecialTokens below).
    pad_token_id: int = 50256
    bos_token_id: int = 50257
    eos_token_id: int = 50257
    decoder_start_token_id: int = 50258

    layer_norm_eps: float = 1e-5

    def replace(self, **kw) -> "WhisperConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class SpecialTokens:
    """Whisper multilingual special-token layout, derived from vocab size.

      0..n_text-1      byte-BPE text tokens (50257 for the real vocab)
      n_text           <|endoftext|>
      n_text+1         <|startoftranscript|>
      +1..+n_langs     <|en|>..<|yue|>  (99 langs for vocab 51865,
                                         100 for v3 vocab 51866)
      then             <|translate|>, <|transcribe|>, <|startoflm|>,
                       <|startofprev|>, <|nospeech|>, <|notimestamps|>
      last 1501        <|0.00|> .. <|30.00|> step 0.02
    """

    vocab_size: int
    eot: int
    sot: int
    lang_begin: int
    n_langs: int
    translate: int
    transcribe: int
    startoflm: int
    startofprev: int
    nospeech: int
    no_timestamps: int
    timestamp_begin: int
    n_timestamps: int = 1501

    @classmethod
    def for_vocab(cls, vocab_size: int) -> "SpecialTokens":
        # vocab = 50257 text + eot + sot + n_langs + 6 specials + 1501 ts
        n_langs = vocab_size - 1501 - 6 - 2 - 50257
        if n_langs <= 0:
            raise ValueError(f"vocab_size {vocab_size} too small for whisper layout")
        return cls.layout(n_text=50257, n_langs=n_langs)

    @classmethod
    def layout(cls, n_text: int = 50257, n_langs: int = 99) -> "SpecialTokens":
        """Special-token layout on top of an arbitrary text vocab
        (n_text=50257 reproduces the official ids; smaller values give
        synthetic test vocabs with identical structure)."""
        eot = n_text
        sot = n_text + 1
        lang_begin = sot + 1
        translate = lang_begin + n_langs
        vocab_size = translate + 6 + 1501
        return cls(
            vocab_size=vocab_size,
            eot=eot,
            sot=sot,
            lang_begin=lang_begin,
            n_langs=n_langs,
            translate=translate,
            transcribe=translate + 1,
            startoflm=translate + 2,
            startofprev=translate + 3,
            nospeech=translate + 4,
            no_timestamps=translate + 5,
            timestamp_begin=translate + 6,
        )


# Language code -> index in the multilingual token block. First 99 are shared
# by v2/v3; "yue" (index 99) exists only in v3 (vocab 51866).
WHISPER_LANGS = (
    "en zh de es ru ko fr ja pt tr pl ca nl ar sv it id hi fi vi he uk el ms "
    "cs ro da hu ta no th ur hr bg lt la mi ml cy sk te fa lv bn sr az sl kn "
    "et mk br eu is hy ne mn bs kk sq sw gl mr pa si km sn yo so af oc ka be "
    "tg sd gu am yi lo uz fo ht ps tk nn mt sa lb my bo tl mg as tt haw ln ha "
    "ba jw su yue"
).split()
LANG_TO_INDEX = {code: i for i, code in enumerate(WHISPER_LANGS)}


def _preset(mels, d, layers, heads, vocab=51865) -> WhisperConfig:
    return WhisperConfig(
        vocab_size=vocab,
        num_mel_bins=mels,
        d_model=d,
        encoder_layers=layers,
        encoder_attention_heads=heads,
        decoder_layers=layers,
        decoder_attention_heads=heads,
        encoder_ffn_dim=4 * d,
        decoder_ffn_dim=4 * d,
    )


PRESETS: dict[str, WhisperConfig] = {
    "tiny": _preset(80, 384, 4, 6),
    "base": _preset(80, 512, 6, 8),
    "small": _preset(80, 768, 12, 12),
    "medium": _preset(80, 1024, 24, 16),
    "large-v2": _preset(80, 1280, 32, 20),
    "large-v3": _preset(128, 1280, 32, 20, vocab=51866),
    # kotoba-whisper student: full 32-layer encoder, 2-layer decoder
    "distil-large-v3": _preset(128, 1280, 32, 20, vocab=51866).replace(
        decoder_layers=2
    ),
    "distil-large-v2": _preset(80, 1280, 32, 20).replace(decoder_layers=2),
    # test-sized config matching WhisperTokenizer.byte_vocab()'s id layout
    # (256 byte text tokens + whisper specials + 1501 timestamps = 1864)
    "test-byte": WhisperConfig(
        vocab_size=1864,
        num_mel_bins=80,
        d_model=64,
        encoder_layers=2,
        encoder_attention_heads=4,
        decoder_layers=2,
        decoder_attention_heads=4,
        encoder_ffn_dim=128,
        decoder_ffn_dim=128,
        max_source_positions=1500,
        max_target_positions=448,
        pad_token_id=255,
        bos_token_id=256,
        eos_token_id=256,
        decoder_start_token_id=257,
    ),
    # test-sized config: tiny dims, full token layout semantics
    "test-tiny": WhisperConfig(
        vocab_size=51865,
        num_mel_bins=80,
        d_model=64,
        encoder_layers=2,
        encoder_attention_heads=4,
        decoder_layers=2,
        decoder_attention_heads=4,
        encoder_ffn_dim=128,
        decoder_ffn_dim=128,
        max_source_positions=1500,
        max_target_positions=448,
    ),
}


@dataclass(frozen=True)
class FeatureConfig:
    """Log-mel frontend parameters (WhisperFeatureExtractor semantics)."""

    sampling_rate: int = 16000
    n_fft: int = 400
    hop_length: int = 160
    n_mels: int = 80
    chunk_length_s: float = 30.0
    fmin: float = 0.0
    fmax: float = 8000.0

    @property
    def n_samples(self) -> int:
        return int(self.chunk_length_s * self.sampling_rate)  # 480000

    @property
    def n_frames(self) -> int:
        return self.n_samples // self.hop_length  # 3000
