"""Port's long-form chunking and merge (decode/longform.py) and the
tokenizer's segment helpers vs the JAX package's copies, exactly.

chunk_audio at 4 / 15 / 20 / 31.7 / 60 s (the JAX test's lengths, held
there to HF's chunk_iter), the longest-common-sequence merge on noisy
overlaps, segments_from_tokens and merge_chunk_segments on timestamped
rows (closed and open segments, eot, midpoints on both sides of a
chunk's core; an open last segment that starts past the audio, whose pair
both packages reverse), and transcribe_long_form in both merge modes with a fake
generate_fn that writes each chunk's own content.
"""
import numpy as np
import pytest

from kotoba_whisper_tpu.decode import longform as jl
from kotoba_whisper_tpu.tokenizer.whisper_tokenizer import WhisperTokenizer as JaxTokenizer
from kotoba_whisper_tpu.tokenizer.whisper_tokenizer import segments_from_tokens as jax_segments
from kotoba_whisper_tpu_torch.decode import longform as tl
from kotoba_whisper_tpu_torch.tokenizer.whisper_tokenizer import WhisperTokenizer
from kotoba_whisper_tpu_torch.tokenizer.whisper_tokenizer import segments_from_tokens

TOK, JTOK = WhisperTokenizer.byte_vocab(), JaxTokenizer.byte_vocab()
ST = TOK.special
TB = ST.timestamp_begin


def _rows(n_chunks, seed):
    """Prompt, then timestamped segments of bytes, some left open, eot, pads."""
    rng = np.random.default_rng(seed)
    prompt = TOK.sot_sequence("ja", "transcribe")
    rows = []
    for i in range(n_chunks):
        row, t = list(prompt), int(rng.integers(0, 40))
        for _ in range(int(rng.integers(1, 4))):
            end = t + int(rng.integers(20, 300))
            row += [TB + t] + rng.integers(65, 91, int(rng.integers(1, 6))).tolist() + [TB + end]
            t = end
        if i % 2:  # an open segment
            row += [TB + t] + [ord("z")] * 3
        rows.append(row + [ST.eot])
    out = np.full((n_chunks, max(map(len, rows)) + 3), 0, np.int32)
    for i, r in enumerate(rows):
        out[i, : len(r)] = r
    return out


@pytest.mark.parametrize("dur_s", [4.0, 15.0, 20.0, 31.7, 60.0])
@pytest.mark.parametrize("chunk_length_s", [15.0, 30.0])
def test_chunk_audio_matches_jax(dur_s, chunk_length_s):
    audio = np.random.default_rng(0).standard_normal(int(16000 * dur_s)).astype(np.float32)
    got = tl.chunk_audio(audio, tl.ChunkingConfig(chunk_length_s=chunk_length_s))
    ref = jl.chunk_audio(audio, jl.ChunkingConfig(chunk_length_s=chunk_length_s))
    assert len(got) == len(ref) >= 1
    for g, r in zip(got, ref):
        assert (g.start_sample, g.stride_left, g.stride_right, g.is_last) == (
            r.start_sample, r.stride_left, r.stride_right, r.is_last)
        np.testing.assert_array_equal(g.audio, r.audio)


@pytest.mark.parametrize("trial", range(4))
def test_longest_common_sequence_matches_jax(trial):
    rng = np.random.default_rng(trial)
    base = rng.integers(5, 50, 40).tolist()
    seqs = [base[:18], base[12:30], base[24:40]]
    if trial % 2:
        seqs[1][2] = 99  # corrupt one overlap token
    if trial == 3:
        seqs.append(rng.integers(60, 70, 5).tolist())  # no overlap at all
    assert tl.find_longest_common_sequence(seqs) == jl.find_longest_common_sequence(seqs)


def test_segments_and_chunk_merge_match_jax():
    tokens = _rows(4, seed=1)
    for row in tokens:
        assert segments_from_tokens(TOK, row) == jax_segments(JTOK, row)
    audio = np.zeros(int(16000 * 37.3), np.float32)
    got = tl.merge_chunk_segments(TOK, tokens, tl.chunk_audio(audio, tl.ChunkingConfig()),
                                  tl.ChunkingConfig())
    ref = jl.merge_chunk_segments(JTOK, tokens, jl.chunk_audio(audio, jl.ChunkingConfig()),
                                  jl.ChunkingConfig())
    assert got == ref and got


def test_an_open_tail_past_the_audio_ends_before_it_starts():
    """A JAX fault the port copies (ROADMAP.md, Queue 3): merge_chunk_segments
    ends a segment opened and never closed at its chunk's end, so where the
    last chunk's open segment starts past the audio, its pair is reversed.
    Both packages give the same reversed final pair."""
    audio = np.zeros(int(16000 * 37.3), np.float32)  # the last chunk holds 30-37.3 s
    tokens = _rows(4, seed=1)
    tail = TOK.sot_sequence("ja", "transcribe") + [TB + 400] + [ord("z")] * 3 + [ST.eot]
    tokens[-1] = 0
    tokens[-1, : len(tail)] = tail  # opens at 8.0 s into a 7.3 s chunk
    got = tl.merge_chunk_segments(TOK, tokens, tl.chunk_audio(audio, tl.ChunkingConfig()),
                                  tl.ChunkingConfig())
    ref = jl.merge_chunk_segments(JTOK, tokens, jl.chunk_audio(audio, jl.ChunkingConfig()),
                                  jl.ChunkingConfig())
    assert got == ref
    assert got[-1] == {"timestamp": (38.0, 37.3), "text": "zzz"}
    assert all(a <= b for a, b in (c["timestamp"] for c in got[:-1]))


@pytest.mark.parametrize("return_timestamps", [True, False])
@pytest.mark.parametrize("dur_s", [0.0, 9.0, 31.0, 47.5])
def test_transcribe_long_form_matches_jax(return_timestamps, dur_s):
    audio = np.random.default_rng(2).standard_normal(int(16000 * dur_s)).astype(np.float32)

    def fake_generate(batch):
        # each chunk's rows from its own first sample, so a chunk mix-up shows
        rows = _rows(batch.shape[0], seed=int(abs(batch[0, 0]) * 1e6))
        if not return_timestamps:
            rows = np.where(rows >= TB, 0, rows)
        return rows

    got = tl.transcribe_long_form(audio, TOK, fake_generate, tl.ChunkingConfig(),
                                  return_timestamps=return_timestamps)
    ref = jl.transcribe_long_form(audio, JTOK, fake_generate, jl.ChunkingConfig(),
                                  return_timestamps=return_timestamps)
    assert got == ref
    assert bool(got["text"]) == (dur_s > 0)
