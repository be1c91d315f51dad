"""Every kernel launches on the card its tensors are on, with that card's set-up.

A kernel's dynamic shared-memory opt-in, a card's SM count and a grid sized
by occupancy hold for one card, so the C host entries (csrc/*.cu) keep them
in tables indexed by the card (csrc/card.cuh), and every wrapper hands its
tensors' card index to the entry, which enters that card for the launch.

On the CPU: the sources are read for the first half; for the second each
wrapper runs on tensors that report themselves on card 1 (CPU memory under
a subclass), with the C entry, the stream lookup and the card's SM count
stubbed, and the stub records the card and stream it was given.
"""
import pathlib
import re
import types

import pytest
import torch

from kotoba_whisper_tpu_torch.core.config import FeatureConfig
from kotoba_whisper_tpu_torch.decode import streaming
from kotoba_whisper_tpu_torch.ops import _build
from kotoba_whisper_tpu_torch.ops import conv_stem as cs
from kotoba_whisper_tpu_torch.ops import decode_attention as da
from kotoba_whisper_tpu_torch.ops import flash_attention as fa
from kotoba_whisper_tpu_torch.ops import layer_norm as ln
from kotoba_whisper_tpu_torch.ops import mel
from kotoba_whisper_tpu_torch.tools import vpu_cal

CSRC = pathlib.Path(_build.CSRC_DIR)
CARD = 1  # not the current device (0): a wrapper must pass it on

# a scalar static: `static int n = 0;`, `static bool ready;` (an array, a
# constexpr, a thread_local or a function is not one)
SCALAR_STATIC = re.compile(
    r"^\s*static\s+(?:const\s+)?(?:unsigned\s+)?(?:int|bool|long(?:\s+long)?|size_t|float)"
    r"\s+\w+\s*(?:=[^;\[]*)?;", re.M)


@pytest.mark.parametrize("name", _build.SOURCES)
def test_host_entries_keep_set_up_per_card(name):
    """No set-up state in a scalar static; every C entry takes the card
    first and enters it before anything else."""
    src = (CSRC / f"{name}.cu").read_text()
    assert not SCALAR_STATIC.findall(src), SCALAR_STATIC.findall(src)
    assert '#include "card.cuh"' in src
    entries = re.findall(r'extern "C" int (\w+)\(([^)]*)\)\s*\{(.*?)\n\}', src, re.S)
    assert {e[0] for e in entries} == set(_build.SIGNATURES[name])
    for fn, params, body in entries:
        assert re.match(r"\s*int card,", params), fn
        assert "kwt_card::CardScope scope(card);" in body, fn
        assert "cudaGetDevice" not in body, fn
        assert _build.SIGNATURES[name][fn][0] is _build.ctypes.c_int, fn
    for table in re.findall(r"static\s+(?:int|bool)\s+\w+\[([^\]]+)\]", src):
        assert table == "kwt_card::kMaxCards", name


def test_card_header_switches_only_when_needed():
    src = (CSRC / "card.cuh").read_text()
    assert "prev_ != card" in src and "cudaSetDevice(prev_)" in src
    assert not SCALAR_STATIC.findall(src)


class OnCard(torch.Tensor):
    """CPU memory that reports itself on card CARD, as a wrapper sees a
    tensor of another card than the current one."""

    @property
    def is_cpu(self):
        return False

    @property
    def is_cuda(self):
        return True

    @property
    def device(self):
        return torch.device("cuda", CARD)

    def get_device(self):
        return CARD


def on_card(t):
    return t.as_subclass(OnCard)


@pytest.fixture
def launches(monkeypatch):
    """Stubs the C entries, the stream lookup, the SM count and the
    allocations a wrapper makes on its card; -> the list of (entry, card,
    stream) the stubs were called with."""
    calls = []

    def function(name, fn):
        def entry(*args):
            calls.append((fn, args[0], args[-1]))
            return 0
        return entry

    real_empty = torch.empty

    def empty(*shape, device=None, **kw):
        out = real_empty(*shape, **kw)
        return on_card(out) if device is not None and torch.device(device).type == "cuda" else out

    monkeypatch.setattr(_build, "function", function)
    monkeypatch.setattr(_build, "stream_handle", lambda card: 1000 + card)
    monkeypatch.setattr(da, "_n_sms", lambda card: 132)
    monkeypatch.setattr(torch, "empty", empty)
    monkeypatch.setattr(mel, "_device_tables", lambda cfg, dev: tuple(
        on_card(t) for t in (torch.zeros(8), torch.zeros(8), torch.zeros(8, dtype=torch.int32),
                             torch.zeros(8, dtype=torch.int32))))
    return calls


def _bf16(*shape, dtype=torch.bfloat16):
    return on_card(torch.randn(*shape).to(dtype))


def _k1(c):
    fa.flash_attention_fwd(_bf16(1, 64, 2, 64), _bf16(1, 64, 2, 64), _bf16(1, 64, 2, 64))


def _k4(c):
    fa.flash_attention_fwd(_bf16(1, 64, 2, 64), _bf16(1, 64, 2, 64), _bf16(1, 64, 2, 64),
                           causal=True)


def _k5(c):
    q = _bf16(1, 64, 2, 64)
    fa.flash_attention_bwd(q, q, q, q, on_card(torch.zeros(1, 2, 64)), q, causal=True)


def _k8(c):
    q = _bf16(1, 64, 2, 64)
    fa.flash_attention_int8(q, q, q, mode="qk")


def _k2(c):  # a cache past SELF_MAX_SLOTS: the prefix form's clusters (the cross call)
    kv = _bf16(2, da.SELF_MAX_SLOTS + 1, 128)
    da.decode_attention(_bf16(2, 2, 64), kv, kv, 5, n_heads=2)


def _k2_self(c):  # a self cache: the self form, the ring kernel without ring_pos
    kv = _bf16(2, 16, 128)
    da.decode_attention(_bf16(2, 2, 64), kv, kv, 5, n_heads=2)


def _k2_ring(c):
    kv = _bf16(2, 16, 128)
    da.decode_attention(_bf16(2, 2, 64), kv, kv, on_card(torch.tensor([3, 4], dtype=torch.int32)),
                        n_heads=2, ring_pos=on_card(torch.tensor(7, dtype=torch.int32)))


def _k2_beam(c):
    kv = _bf16(2, 64, 128)
    da.decode_attention_beam(_bf16(2, 3, 2, 64), kv, kv, n_heads=2)


def _k2_int4(c, dtype=torch.bfloat16):  # packed int4: the prefix form's head kernel
    kv = on_card(torch.zeros(2, 64, 2 * 32, dtype=torch.uint8))
    scale = _bf16(2, 64, 2)
    da.decode_attention(_bf16(2, 2, 64, dtype=dtype), kv, kv, 5, n_heads=2, k_scale=scale,
                        v_scale=scale)


def _k2_int4_f32(c):
    _k2_int4(c, torch.float32)


def _k2_int8_f32(c):  # int8 with row scales under fp32 q, a cross cache: the head kernel
    kv = on_card(torch.zeros(2, da.SELF_MAX_SLOTS + 1, 128, dtype=torch.int8))
    scale = on_card(torch.ones(2, da.SELF_MAX_SLOTS + 1, 1))
    da.decode_attention(_bf16(2, 2, 64, dtype=torch.float32), kv, kv, 5, n_heads=2,
                        k_scale=scale, v_scale=scale)


def _k1_f32(c):
    x = _bf16(1, 64, 2, 64, dtype=torch.float32)
    fa.flash_attention_fwd(x, x, x)


def _k4_f32(c):
    x = _bf16(1, 64, 2, 64, dtype=torch.float32)
    fa.flash_attention_fwd(x, x, x, causal=True)


def _k2_f32(c):
    kv = _bf16(2, da.SELF_MAX_SLOTS + 1, 128, dtype=torch.float32)
    da.decode_attention(_bf16(2, 2, 64, dtype=torch.float32), kv, kv, 5, n_heads=2)


def _k2_self_f32(c):
    kv = _bf16(2, 16, 128, dtype=torch.float32)
    da.decode_attention(_bf16(2, 2, 64, dtype=torch.float32), kv, kv, 5, n_heads=2)


def _k2_ring_f32(c):
    kv = _bf16(2, 16, 128, dtype=torch.float32)
    da.decode_attention(_bf16(2, 2, 64, dtype=torch.float32), kv, kv,
                        on_card(torch.tensor([3, 4], dtype=torch.int32)), n_heads=2,
                        ring_pos=on_card(torch.tensor(7, dtype=torch.int32)))


def _k2_beam_f32(c):
    kv = _bf16(2, 64, 128, dtype=torch.float32)
    da.decode_attention_beam(_bf16(2, 3, 2, 64, dtype=torch.float32), kv, kv, n_heads=2)


def _k5_f32(c):
    q = _bf16(1, 64, 2, 64, dtype=torch.float32)
    fa.flash_attention_bwd(q, q, q, q, on_card(torch.zeros(1, 2, 64)), q, causal=True)


def _k5_f32_split(c):
    q = _bf16(1, 70, 2, 64, dtype=torch.float32)
    kv = _bf16(1, 300, 2, 64, dtype=torch.float32)
    fa.flash_attention_bwd(q, kv, kv, q, on_card(torch.zeros(1, 2, 70)), q, causal=False)


def _k8_f32(c):
    q = _bf16(1, 64, 2, 64, dtype=torch.float32)
    fa.flash_attention_int8(q, q, q, mode="qkpv")


def _k1_nomax(c):
    x = _bf16(1, 64, 2, 64)
    fa.flash_attention_fwd(x, x, x, no_max=True)


def _k1_f32_nomax(c):
    x = _bf16(1, 64, 2, 64, dtype=torch.float32)
    fa.flash_attention_fwd(x, x, x, no_max=True)


def _k8_nomax(c):
    x = _bf16(1, 64, 2, 64)
    fa.flash_attention_int8(x, x, x, mode="qkpv", no_max=True)


def _k8_f32_nomax(c):
    x = _bf16(1, 64, 2, 64, dtype=torch.float32)
    fa.flash_attention_int8(x, x, x, mode="qk", no_max=True)


def _k3(c):
    mel.log_mel_frames(on_card(torch.zeros(1, 480000)), FeatureConfig())


def _k6(c):
    w = _bf16(64, dtype=torch.float32)
    ln.layer_norm(_bf16(4, 64), w, w)


def _k6_add(c):
    w = _bf16(64, dtype=torch.float32)
    ln.add_layer_norm(_bf16(4, 64), _bf16(4, 64), w, w)


def _k6_f32(c):
    ln.layer_norm(_bf16(4, 64, dtype=torch.float32), _bf16(64), _bf16(64))


def _k6_add_f32(c):
    w = _bf16(64, dtype=torch.float32)
    ln.add_layer_norm(_bf16(4, 64, dtype=torch.float32), _bf16(4, 64, dtype=torch.float32), w, w)


def _k7_f32(c):
    conv = [types.SimpleNamespace(weight=_bf16(64, c_in, 3, dtype=torch.float32),
                                  bias=_bf16(64, dtype=torch.float32)) for c_in in (80, 64)]
    cs.conv_stem(conv[0], conv[1], _bf16(1, 80, 256, dtype=torch.float32))


def _k7(c):
    conv = [types.SimpleNamespace(weight=_bf16(64, c_in, 3), bias=_bf16(64))
            for c_in in (80, 64)]
    cs.conv_stem(conv[0], conv[1], _bf16(1, 80, 256))


def _k9(c):
    vpu_cal.vpu_cal(_bf16(4, 128, dtype=torch.float32), 2, "exp")


WRAPPERS = {
    "K1": (_k1, "kwt_flash_attention_sm90_fwd"),
    "K4": (_k4, "kwt_flash_attention_sm90_fwd"),
    "K5": (_k5, "kwt_flash_attention_bwd"),
    "K8": (_k8, "kwt_flash_attention_int8"),
    "K2 prefix": (_k2, "kwt_decode_attention"),
    "K2 prefix int4": (_k2_int4, "kwt_decode_attention_heads"),
    "K2 prefix int4 fp32": (_k2_int4_f32, "kwt_decode_attention_heads"),
    "K2 prefix int8 fp32": (_k2_int8_f32, "kwt_decode_attention_heads"),
    "K2 ring": (_k2_ring, "kwt_decode_attention_ring"),
    "K2 self": (_k2_self, "kwt_decode_attention_ring"),
    "K2 beam": (_k2_beam, "kwt_decode_attention_beam"),
    "K1 fp32": (_k1_f32, "kwt_flash_attention_f32"),
    "K4 fp32": (_k4_f32, "kwt_flash_attention_f32"),
    "K2 prefix fp32": (_k2_f32, "kwt_decode_attention"),
    "K2 ring fp32": (_k2_ring_f32, "kwt_decode_attention_ring_f32"),
    "K2 self fp32": (_k2_self_f32, "kwt_decode_attention_ring_f32"),
    "K2 beam fp32": (_k2_beam_f32, "kwt_decode_attention_beam_f32"),
    "K3": (_k3, "kwt_log_mel"),
    "K6": (_k6, "kwt_layer_norm"),
    "K6 add": (_k6_add, "kwt_layer_norm"),
    "K7": (_k7, "kwt_conv_stem"),
    "K5 fp32": (_k5_f32, "kwt_flash_attention_bwd_f32"),
    "K5 fp32 split": (_k5_f32_split, "kwt_flash_attention_bwd_f32"),
    "K8 fp32": (_k8_f32, "kwt_flash_attention_int8"),
    "K6 fp32": (_k6_f32, "kwt_layer_norm"),
    "K6 add fp32": (_k6_add_f32, "kwt_layer_norm"),
    "K7 fp32": (_k7_f32, "kwt_conv_stem_f32"),
    "K9": (_k9, "kwt_vpu_cal"),
    "K1 no-max": (_k1_nomax, "kwt_flash_attention_sm90_fwd_nomax"),
    "K1 fp32 no-max": (_k1_f32_nomax, "kwt_flash_attention_f32_nomax"),
    "K8 no-max": (_k8_nomax, "kwt_flash_attention_int8_nomax"),
    "K8 fp32 no-max": (_k8_f32_nomax, "kwt_flash_attention_int8_nomax"),
}


@pytest.mark.parametrize("kernel", list(WRAPPERS))
def test_wrapper_launches_on_the_tensors_card(launches, kernel):
    call, entry = WRAPPERS[kernel]
    call(None)
    assert launches == [(entry, CARD, 1000 + CARD)]


def test_every_entry_has_a_wrapper_case():
    entries = {fn for fns in _build.SIGNATURES.values() for fn in fns}
    assert entries == {entry for _, entry in WRAPPERS.values()}


def test_stream_read_back_waits_on_the_tensors_card(monkeypatch):
    """The streams' read-back (decode/streaming._read_back, which
    decode/streaming_beam.py shares) records the event the host waits on
    on the stream of the tensors' card, where the non-blocking copies are
    queued, not on the current card's."""
    recorded = []

    class Event:
        def record(self, stream=None):
            recorded.append(stream)

    real_empty = torch.empty
    monkeypatch.setattr(torch.cuda, "Event", Event)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: ("stream", torch.device(device or "cuda:0").index))
    monkeypatch.setattr(torch, "empty", lambda *shape, pin_memory=False, **kw: real_empty(
        *shape, **kw))
    tensors = [on_card(torch.arange(6)), on_card(torch.tensor([True, False]))]
    host, done = streaming._read_back(tensors)
    assert done is not None and recorded == [("stream", CARD)]
    assert [h.tolist() for h in host] == [list(range(6)), [True, False]]
