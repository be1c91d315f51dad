"""K2's cross call over int8 K/V under fp32 q on the head kernel, on the CPU
(csrc/decode_attention.cu `head_kernel`).

An fp32 model's int8 cross cache (int8 codes with one fp32 scale a row,
(B, T, 1)) takes the head kernel that packed int4 takes: one CTA per
(share of the cache rows, group of heads, batch row) of `head_plan`'s
grid, the shares of a (row, group) one cluster. Held here:
- `head_plan` over int8: every valid row read by exactly one share of one
  (row, head group), with per-row lengths on and beside each share
  boundary and a valid length of 1; a CTA's shared memory within
  SMEM_LIMIT; a ring of at least 4 boxes; a raise where a share's rows
  cannot fit;
- `head_walk`, the kernel's arithmetic in its order, over int8 codes with
  fp32 row scales against the JAX package's `decode_attention_reference`
  with fp32 q to 1e-6, and against the port's plain twin;
- the dispatch, through a stubbed C entry on CPU tensors that report a
  card: fp32-q int8 cross calls reach the head entry with the plan's grid
  and ring, and bf16-q int8, bf16, fp32 K/V and int8 with per-head scales
  reach the row entry; int8 self and ring calls stay on the ring kernel.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kotoba_whisper_tpu.models import whisper as jw
from kotoba_whisper_tpu.ops import decode_attention as jda
from kotoba_whisper_tpu_torch.ops import _build
from kotoba_whisper_tpu_torch.ops import decode_attention as tda

T = 1500  # the cross call's rows (the encoder's positions)
TOL = dict(atol=1e-6, rtol=1e-5)
CARD = 1


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny CPU tensors: one intra-op thread, so torch's thread pool does
    not spin-wait on cores the parallel test workers oversubscribe."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _kv(seed, b, h, t=T):
    """fp32 q, and K/V quantized to int8 per row by JAX: the port's codes
    and (B, T, 1) fp32 scales as torch tensors, JAX's as arrays."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, h, 64)).astype(np.float32)
    out = [q]
    for _ in range(2):
        x = rng.standard_normal((b, t, h * 64)).astype(np.float32)
        codes, s = jw.quantize_kv_rows(jnp.asarray(x))
        out.append((torch.from_numpy(np.array(codes)), torch.from_numpy(np.array(s)),
                    codes, s))
    return out


def _boundary_lengths(b, h):
    """Per-row valid lengths on and beside the shares' boundaries of the
    plan an int8 (b, T) cache takes, a full row and one valid slot."""
    plan = tda.head_plan(b, T, h, kv_dtype=torch.int8)
    edges = [plan.rows * x + d for x in range(1, plan.shares) for d in (-1, 0, 1)]
    lengths = [T, 1, *edges]
    return np.array([lengths[i % len(lengths)] for i in range(b)], np.int32)


@pytest.mark.parametrize("b, span, h", [(16, 1500, 20), (16, 1500, 10), (4, 1500, 20),
                                        (1, 1500, 20), (48, 1500, 20), (3, 1, 3),
                                        (2, 63, 4), (16, 3000, 20)])
def test_int8_shares_cover_each_valid_row_once(b, span, h):
    """Share x of head group y of row z reads rows [x * rows, min((x + 1) *
    rows, valid)): over the grid every valid (row, head, slot) exactly
    once, nothing past valid, for valid 1, half the span, the span and the
    lengths on each share boundary; a portable cluster, no empty share."""
    plan = tda.head_plan(b, span, h, kv_dtype=torch.int8)
    assert plan.grid == (plan.shares, h // plan.heads, b) and h % plan.heads == 0
    assert 1 <= plan.shares <= tda.MAX_CLUSTER
    assert plan.shares * plan.rows >= span > (plan.shares - 1) * plan.rows
    edges = [plan.rows * x + d for x in range(1, plan.shares) for d in (-1, 0, 1)]
    for valid in sorted({1, span // 2 + 1, span, *(e for e in edges if 1 <= e <= span)}):
        seen = np.zeros((h, span), int)
        for y in range(plan.grid[1]):
            for x in range(plan.shares):
                rows = slice(x * plan.rows, max(min((x + 1) * plan.rows, valid), x * plan.rows))
                seen[y * plan.heads:(y + 1) * plan.heads, rows] += 1
        assert (seen[:, :valid] == 1).all() and (seen[:, valid:] == 0).all(), valid


@pytest.mark.parametrize("heads", [4, 2, 1])
def test_int8_ring_and_shared_memory(heads):
    """The int8 ring holds at least 4 boxes of HEAD_BOX rows at every head
    count, and the cross call's CTAs fit SMEM_LIMIT; the count is the
    kernel's layout (ring, raw scores, one fp32 scale word a row and
    tensor, max and sum, the cluster's slices, maxima and sums, barriers)."""
    stages = tda.HEAD_INT8_STAGES
    assert stages >= 4
    for rows in (375, 188, 1):
        parts = (stages * tda.HEAD_BOX * heads * 64 + 4 * rows * heads + 8 * rows + 8 * heads
                 + 4 * (heads * 64 + tda.MAX_CLUSTER) + 8 * tda.MAX_CLUSTER * heads)
        smem = tda.head_smem_bytes(rows, heads, torch.int8)
        assert smem == ((parts + 7) & ~7) + 8 * (2 * stages + 1) <= tda.SMEM_LIMIT


def test_int8_plan_at_the_cross_call():
    """B=16 over T=1500: 4 heads a CTA at 20 heads, 2 at a TP=2 rank's 10,
    each 4 shares of 375 rows (320 CTAs), a ring of at least 4 boxes, three
    CTAs an SM within the SM's shared memory; valid 1 (a scalar span of
    one row) takes one share of one row."""
    for h, heads in ((20, 4), (10, 2)):
        p = tda.head_plan(16, T, h, kv_dtype=torch.int8)
        assert (p.heads, p.shares, p.rows, p.grid) == (heads, 4, 375, (4, h // heads, 16))
        assert 3 * (p.smem + 1024) <= tda.SM_SMEM
    one = tda.head_plan(16, 1, 20, kv_dtype=torch.int8)
    assert (one.shares, one.rows) == (1, 1)


def test_int8_plan_raises_where_a_share_cannot_fit():
    """A share's scores and scale words live in shared memory: rows past
    what a CTA holds raise rather than launch; K/V the head kernel does not
    take raise too."""
    with pytest.raises(ValueError, match="head kernel"):
        tda.head_plan(1, 200_000, 1, kv_dtype=torch.int8)
    with pytest.raises(ValueError, match="head kernel"):
        tda.head_smem_bytes(375, 4, torch.bfloat16)


@pytest.mark.parametrize("valid", ["scalar", "rows", "one"])
@pytest.mark.parametrize("h", [20, 10], ids=["D1280", "D640"])
def test_walk_matches_jax(h, valid):
    """The head kernel's order over int8 with fp32 row scales and fp32 q
    against JAX's reference to 1e-6, and against the port's plain twin."""
    b = 6 if valid != "rows" else 16
    q, (k, ks, jk, jks), (v, vs, jv, jvs) = _kv(h + b, b, h)
    lengths = {"scalar": 1200, "one": 1, "rows": _boundary_lengths(b, h)}[valid]
    ref = jda.decode_attention_reference(
        jnp.asarray(q), jk, jv, jnp.asarray(lengths), n_heads=h, k_scale=jks, v_scale=jvs)
    valid_len = torch.from_numpy(lengths) if valid == "rows" else lengths
    got = tda.head_walk(torch.from_numpy(q), k, v, valid_len, n_heads=h, k_scale=ks,
                        v_scale=vs)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    twin = tda.decode_attention(torch.from_numpy(q), k, v, valid_len, n_heads=h, k_scale=ks,
                                v_scale=vs)
    np.testing.assert_allclose(got.numpy(), twin.numpy(), **TOL)


class OnCard(torch.Tensor):
    """CPU memory that reports itself on card CARD (as in
    tests/test_torch_devices.py)."""

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


def _on_card(t):
    return t.as_subclass(OnCard)


@pytest.fixture
def entries(monkeypatch):
    """Stubs the C entries, the stream and the SM count -> the list of
    (library, entry, args) the wrappers called."""
    calls = []

    def function(name, fn):
        def entry(*args):
            calls.append((name, fn, args))
            return 0
        return entry

    real_empty = torch.empty

    def empty(*shape, device=None, **kw):
        out = real_empty(*shape, **kw)
        return _on_card(out) if device is not None and torch.device(device).type == "cuda" else out

    monkeypatch.setattr(_build, "function", function)
    monkeypatch.setattr(_build, "stream_handle", lambda card: 1000 + card)
    monkeypatch.setattr(tda, "_n_sms", lambda card: 132)
    monkeypatch.setattr(torch, "empty", empty)
    return calls


def _call(mode, q_dtype, t=T, ring_pos=None, b=2, h=4):
    d = h * 64
    q = _on_card(torch.zeros(b, h, 64, dtype=q_dtype))
    if mode == "int8":
        kv, s = torch.zeros(b, t, d, dtype=torch.int8), torch.ones(b, t, 1)
    elif mode == "int8h":
        kv, s = torch.zeros(b, t, d, dtype=torch.int8), torch.ones(b, t, h, dtype=torch.bfloat16)
    elif mode == "int4":
        kv = torch.zeros(b, t, d // 2, dtype=torch.uint8)
        s = torch.ones(b, t, h, dtype=torch.bfloat16)
    else:
        kv, s = torch.zeros(b, t, d, dtype=mode), None
    kv = _on_card(kv)
    s = None if s is None else _on_card(s)
    valid = _on_card(torch.tensor([t, 1], dtype=torch.int32)) if ring_pos is not None else t
    ring = None if ring_pos is None else _on_card(torch.tensor(ring_pos, dtype=torch.int32))
    tda.decode_attention(q, kv, kv, valid, n_heads=h, k_scale=s, v_scale=s, ring_pos=ring)


def test_fp32_q_int8_cross_call_reaches_the_head_entry(entries):
    """fp32 q over int8 K/V with fp32 row scales at T=1500: the head entry,
    with the plan's heads, shares and rows, mode KV_INT8, fp32 q; one
    launch counted on the prefix form's counter."""
    before = tda.decode_attention.launches
    _call("int8", torch.float32)
    plan = tda.head_plan(2, T, 4, 132, kv_dtype=torch.int8)
    (lib, fn, args), = entries
    assert (lib, fn) == ("decode_attention", "kwt_decode_attention_heads")
    assert args[0] == CARD and args[-1] == 1000 + CARD
    assert args[10:18] == (2, T, 4, plan.heads, plan.shares, plan.rows, tda.KV_INT8, 1)
    assert tda.decode_attention.launches == before + 1


@pytest.mark.parametrize("mode, q_dtype", [
    ("int8", torch.bfloat16), (torch.bfloat16, torch.bfloat16), (torch.float32, torch.float32),
    ("int8h", torch.bfloat16), ("int8h", torch.float32)],
    ids=["bf16q-int8", "bf16", "fp32", "bf16q-int8-heads", "fp32q-int8-heads"])
def test_other_cross_modes_reach_the_row_entry(entries, mode, q_dtype):
    """Every other mode of the cross call (T=1500) stays on the row kernel:
    bf16-q int8, bf16 and fp32 K/V, and int8 with per-head scales (mode 2)
    under either q."""
    _call(mode, q_dtype)
    (lib, fn, args), = entries
    assert (lib, fn) == ("decode_attention", "kwt_decode_attention")
    assert args[-2] == int(q_dtype == torch.float32)


def test_int4_keeps_the_head_entry(entries):
    """Packed int4 takes the head entry as before."""
    _call("int4", torch.bfloat16)
    (lib, fn, args), = entries
    plan = tda.head_plan(2, T, 4, 132)
    assert fn == "kwt_decode_attention_heads"
    assert args[13:18] == (plan.heads, plan.shares, plan.rows, tda.KV_INT4, 0)


@pytest.mark.parametrize("form", ["self", "ring"])
def test_fp32_q_int8_self_and_ring_calls_stay_on_the_ring_kernel(entries, form):
    """fp32 q over int8 self caches (T <= SELF_MAX_SLOTS) and the stream's
    ring take the ring kernel's fp32 form, not the head kernel."""
    _call("int8", torch.float32, t=51, ring_pos=7 if form == "ring" else None)
    (lib, fn, _), = entries
    assert (lib, fn) == ("decode_attention_ring", "kwt_decode_attention_ring_f32")
