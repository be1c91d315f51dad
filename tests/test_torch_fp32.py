"""The port's fp32 forms on the CPU (fp32, tiny shapes, numpy seeds).

K1/K4's and K2's fp32 kernels run only on the card; here:
- `ring_walk` and `beam_walk` in their fp32 mode (`q_dtype=torch.float32`:
  the fp32 ring kernel's boxes with an online softmax, the fp32 beam
  kernel's warps over 32-key chunks) against the JAX package's
  `decode_attention_reference` and `decode_attention_reference_beam` in
  fp32 to 1e-6, with fp32, int8 and int4 K/V;
- the plans for fp32 K/V and fp32 q: within a CTA's shared memory, two
  CTAs an SM where the kernels ask for it, and the ring form at T=448 (the
  decoder's most positions) walking its keys in boxes instead of raising;
- the drivers: stage 2 (also under KWT_FA_INT8), stage 6, create-student,
  distill and distill-bilingual take --dtype float32 on a CUDA device and
  get past their checks (stubs stop them before any card work);
- `embed_audio` and the encoder turning TF32 off for fp32 inside the call
  only, and a mixed-dtype call of K2's wrappers raising before any launch.
The whole fp32 path against JAX is held by tests/test_torch_pipeline.py,
test_torch_greedy.py, test_torch_beam.py and test_torch_streaming.py.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kotoba_whisper_tpu.models import whisper as jw
from kotoba_whisper_tpu.ops import decode_attention as jda
from kotoba_whisper_tpu_torch.cli import common, create_student, distill, distill_bilingual
from kotoba_whisper_tpu_torch.cli import pseudo_label
from kotoba_whisper_tpu_torch.core.config import PRESETS
from kotoba_whisper_tpu_torch.models import whisper as tw
from kotoba_whisper_tpu_torch.ops import decode_attention as tda

H, HD = 4, 64
TOL = dict(atol=1e-6, rtol=1e-6)
CUDA = torch.device("cuda")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny CPU tensors: one intra-op thread, so torch's thread pool does
    not spin-wait on cores the parallel test workers oversubscribe."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _kv(rng, b, t, kv):
    """K/V of mode `kv` from numpy normals: fp32; int8 with fp32 row scales
    (JAX's quantize_kv_rows); int8 or int4 with bf16 per-head scales (JAX's
    quantize_kv_heads). -> ((port k, k_scale), (port v, v_scale), (jax k,
    k_scale), (jax v, v_scale))."""
    port, jax_side = [], []
    for _ in range(2):
        x = rng.standard_normal((b, t, H * HD)).astype(np.float32)
        if kv == "fp32":
            port.append((torch.from_numpy(x), None))
            jax_side.append((jnp.asarray(x), None))
        elif kv == "int8":
            codes, s = (np.asarray(a) for a in jw.quantize_kv_rows(jnp.asarray(x)))
            port.append((torch.from_numpy(codes), torch.from_numpy(s)))
            jax_side.append((jnp.asarray(codes), jnp.asarray(s)))
        else:
            bits = 4 if kv == "int4" else 8
            codes, s = jw.quantize_kv_heads(jnp.asarray(x), H, jnp.int4 if bits == 4 else jnp.int8)
            c8 = torch.from_numpy(np.asarray(codes).astype(np.int8))
            s_t = torch.from_numpy(np.asarray(s, np.float32)).bfloat16()
            port.append((tw.pack_int4(c8) if bits == 4 else c8, s_t))
            jax_side.append((codes, s))
    return port[0], port[1], jax_side[0], jax_side[1]


@pytest.mark.parametrize("t, ring_pos", [(70, 9), (70, 69), (448, 300)])
@pytest.mark.parametrize("kv", ["fp32", "int8", "int8h"])
def test_ring_walk_f32_matches_jax(kv, t, ring_pos):
    """The fp32 ring kernel's order: one CTA a (row, head), its keys in
    boxes of `ring_plan`'s chunk (one box at T=70; 192-slot boxes with
    fp32 K/V at T=448), the running max raised box by box with the sum and
    P V rescaled; rows of every slot, one slot, a wrap."""
    rng = np.random.default_rng(t + ring_pos + len(kv))
    b = 4
    q = rng.standard_normal((b, H, HD)).astype(np.float32)
    (k, ks), (v, vs), (jk, jks), (jv, jvs) = _kv(rng, b, t, kv)
    valid = np.array([t, 1, ring_pos + 1, t - 3], np.int32)
    ref = jda.decode_attention_reference(jnp.asarray(q), jk, jv, jnp.asarray(valid), n_heads=H,
                                         k_scale=jks, v_scale=jvs, ring_pos=jnp.int32(ring_pos))
    got = tda.ring_walk(torch.from_numpy(q), k, v, torch.from_numpy(valid), ring_pos, n_heads=H,
                        k_scale=ks, v_scale=vs, out_dtype=torch.float32,
                        q_dtype=torch.float32)
    plan = tda.ring_plan(b, t, H, k.dtype, per_head=kv == "int8h", q_dtype=torch.float32)
    assert (plan.chunk < t) == (kv == "fp32" and t == 448)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("n_sms", [1, 132], ids=["one-share", "key-shares"])
@pytest.mark.parametrize("beams", [1, 5, 8, 17])
@pytest.mark.parametrize("kv", ["fp32", "int8", "int4"])
def test_beam_walk_f32_matches_jax(kv, beams, n_sms):
    """The fp32 beam kernel's order: `beam_plan`'s tiles of up to 8 beams
    and key shares, warp w chunks w, w + 4, ... of 32 keys with a running
    state of its own in log2 units, P * v_scale in fp32, the warps' and
    shares' states merged; T=583 (19 chunks) and a ragged last chunk."""
    rng = np.random.default_rng(beams + n_sms + len(kv))
    g, t = 3, 600 - 17
    q = rng.standard_normal((g, beams, H, HD)).astype(np.float32)
    (k, ks), (v, vs), (jk, jks), (jv, jvs) = _kv(rng, g, t, kv)
    ref = jda.decode_attention_reference_beam(jnp.asarray(q), jk, jv, n_heads=H, k_scale=jks,
                                              v_scale=jvs)
    got = tda.beam_walk(torch.from_numpy(q), k, v, n_heads=H, k_scale=ks, v_scale=vs,
                        n_sms=n_sms, q_dtype=torch.float32)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def test_f32_plans_fit_the_card():
    """The fp32 forms' plans at large-v3's shapes: the prefix CTA over 188
    rows of 5120-byte fp32 rows (4 rows a stage) within a CTA's shared
    memory, two an SM; the ring at the stream's T=176 in one box, two CTAs
    an SM; the beam CTA two an SM in its three K/V modes; int8 K/V under
    fp32 q take the fp32 forms' plans too; the fp32 beam grid is its own
    (tiles of up to 8 beams, as even as they can be, key shares over a
    cluster: one wave at the CTAs an SM its registers allow, 1 x 20 x 12
    CTAs over fp32 K/V, 2 x 20 x 12 over int8 and int4, 6 x 20 x 1 for one
    group over int4)."""
    prefix = tda.prefix_smem_bytes(188, 20, torch.float32)
    assert 2 * (prefix + 1024) <= tda.SM_SMEM
    assert tda.PREFIX_STAGE_BYTES // (20 * tda._head_bytes(torch.float32)) == 4
    for kv, per_head in ((torch.float32, False), (torch.int8, False), (torch.int8, True)):
        plan = tda.ring_plan(48, 176, 20, kv, per_head=per_head, q_dtype=torch.float32)
        assert plan.chunk == 176 and plan.heads == 1 and plan.grid == (20, 48)
        assert 2 * (plan.smem + 1024) <= tda.SM_SMEM
    for kv in (torch.float32, torch.int8, torch.uint8):
        plan = tda.beam_plan(12, 1500, 20, 5, kv, q_dtype=torch.float32)
        assert plan.grid == ((1 if kv == torch.float32 else 2), 20, 12)
        per_sm = tda.BEAM_F32_CTAS_PER_SM[kv]
        assert per_sm * (plan.smem + 1024) <= tda.SM_SMEM
        assert math.prod(plan.grid) <= per_sm * tda.N_SMS < 2 * math.prod(plan.grid)  # one wave
    assert tda.beam_plan(1, 1500, 20, 5, torch.uint8, q_dtype=torch.float32).grid == (6, 20, 1)
    assert [tda.beam_f32_rows(k) for k in (1, 5, 8, 9, 16, 17, 24, 25)] == [1, 5, 8, 5, 8, 6, 8,
                                                                            7]
    # fp32 K/V always take the fp32 forms
    assert (tda.beam_plan(12, 1500, 20, 5, torch.float32)
            == tda.beam_plan(12, 1500, 20, 5, torch.float32, q_dtype=torch.float32))


@pytest.mark.parametrize("t", [224, 300, 448])
def test_f32_ring_plan_walks_in_boxes(t):
    """Past what one CTA can hold two an SM, the fp32 ring plan does not
    raise: its boxes are whole 32-slot boxes, as many as fit (192 slots of
    fp32 K/V), and they cover every key of a row once."""
    plan = tda.ring_plan(48, t, 20, torch.float32)
    assert plan.smem <= tda.SMEM_LIMIT and 2 * (plan.smem + 1024) <= tda.SM_SMEM
    assert plan.chunk == 192 and plan.chunk % tda.RING_BOX == 0
    assert tda.ring_f32_smem_bytes(plan.chunk + tda.RING_BOX, torch.float32) > tda.RING_F32_BUDGET
    for valid in (1, plan.chunk, plan.chunk + 1, t):
        boxes = [(j0, min(plan.chunk, valid - j0)) for j0 in range(0, valid, plan.chunk)]
        assert sum(n for _, n in boxes) == valid and all(n >= 1 for _, n in boxes)
    # the bf16 form still raises where one head cannot fit
    with pytest.raises(ValueError, match="shared memory"):
        tda.ring_plan(48, 1500, 20, torch.bfloat16)


class _OnCard(torch.Tensor):
    """CPU memory that reports itself on card 0: the wrappers' checks run
    as on the card, and any launch would fail."""

    @property
    def is_cpu(self):
        return False

    @property
    def is_cuda(self):
        return True

    @property
    def device(self):
        return CUDA

    def get_device(self):
        return 0


@pytest.mark.parametrize("bad", ["f32q-bf16kv", "bf16q-f32kv", "f32q-bf16kv-ring",
                                 "f32q-bf16kv-beam", "bf16q-f32kv-beam"])
def test_mixed_dtypes_raise(bad, monkeypatch):
    """A K2 call that mixes bfloat16 and fp32 raises ValueError, before
    any launch (the C entry is never looked up)."""
    from kotoba_whisper_tpu_torch.ops import _build

    monkeypatch.setattr(_build, "function", lambda *a: pytest.fail("launched"))
    monkeypatch.setattr(tda, "_n_sms", lambda card: 132)
    q_dtype = torch.float32 if bad.startswith("f32q") else torch.bfloat16
    kv_dtype = torch.bfloat16 if q_dtype == torch.float32 else torch.float32
    kv = torch.zeros(2, 64, H * HD, dtype=kv_dtype).as_subclass(_OnCard)
    with pytest.raises(ValueError, match="does not mix"):
        if bad.endswith("beam"):
            q = torch.zeros(2, 3, H, HD, dtype=q_dtype).as_subclass(_OnCard)
            tda.decode_attention_beam(q, kv, kv, n_heads=H)
        else:
            q = torch.zeros(2, H, HD, dtype=q_dtype).as_subclass(_OnCard)
            kw = {}
            if bad.endswith("ring"):
                kw["ring_pos"] = torch.tensor(3, dtype=torch.int32).as_subclass(_OnCard)
            tda.decode_attention(q, kv, kv, 5, n_heads=H, **kw)


def test_kv_args_names_the_fp32_mode():
    kv = torch.zeros(2, 5, 2 * HD)
    assert tda._kv_args(-1, kv, kv.clone(), None, None, 2, torch.float32)[0] == tda.KV_F32
    int8 = torch.zeros(2, 5, 2 * HD, dtype=torch.int8)
    assert tda._kv_args(-1, int8, int8.clone(), torch.ones(2, 5, 1), torch.ones(2, 5, 1), 2,
                        torch.float32)[0] == tda.KV_INT8
    with pytest.raises(ValueError, match="no scales"):
        tda._kv_args(-1, kv, kv.clone(), torch.ones(2, 5, 1), torch.ones(2, 5, 1), 2,
                     torch.float32)


class _Reached(Exception):
    """Raised by a stub past an entry point's checks: it did not refuse."""


def _reach(*args, **kwargs):
    raise _Reached


@pytest.mark.parametrize("int8_mode", ["", "qk", "qkpv"])
def test_serving_and_stage2_take_fp32_on_the_card(monkeypatch, int8_mode):
    """eval / speed's pipeline and stage 2's rank body take --dtype float32
    for a CUDA device, also under KWT_FA_INT8 (K8's fp32-q form): both get
    past their checks to loading the tokenizer (a stub; no card needed)."""
    monkeypatch.setenv("KWT_FA_INT8", int8_mode)
    monkeypatch.setattr(common, "load_tokenizer", _reach)
    args = pseudo_label._parser().parse_args(
        ["--dataset_dir", "d", "--output_dir", "o", "--dtype", "float32"])
    with pytest.raises(_Reached):
        pseudo_label._run(args, CUDA)
    eval_args = type("Args", (), {"dtype": "float32", "tokenizer": "byte"})()
    with pytest.raises(_Reached):
        common.serving_pipeline(eval_args, CUDA)
    assert not hasattr(common, "refuse_unported_fp32")


def test_create_student_takes_fp32_on_the_card(monkeypatch, tmp_path):
    """create-student --dtype float32 on a CUDA device gets past its checks
    to loading the teacher (a stub here; torch reports a card)."""
    monkeypatch.delenv("KWT_FA_INT8", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(common, "load_model", _reach)
    with pytest.raises(_Reached):
        create_student.main(["--teacher", "preset:test-tiny", "--save_dir", str(tmp_path),
                             "--dtype", "float32"])


def test_distill_still_refuses_fp32_naming_k5(monkeypatch):
    """Training in fp32 on the card runs through K5's fp32 form now: both
    trainers take --dtype float32 for a CUDA device and get past their
    checks (distill to loading the student, distill-bilingual to loading
    its datasets: stubs, no card needed), --wandb_project included."""
    from kotoba_whisper_tpu_torch.data import shards

    args = distill._parser().parse_args(
        ["--data_dir", "d", "--student", "s", "--teacher", "t", "--output_dir", "o",
         "--dtype", "float32"])
    monkeypatch.setattr(shards, "resolve_split_dirs", lambda spec: [spec])
    monkeypatch.setattr(common, "load_tokenizer", lambda spec: None)
    monkeypatch.setattr(common, "load_model", _reach)
    for project in (None, "p"):
        args.wandb_project = project
        with pytest.raises(_Reached):
            distill._run(args, CUDA)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(distill_bilingual, "load_datasets", _reach)
    with pytest.raises(_Reached):
        distill_bilingual.main(["--dataset", "ja:d:transcribe.ja:kl", "--student", "s",
                                "--teacher", "t", "--output_dir", "o", "--dtype", "float32"])


def _tiny(dtype):
    cfg = PRESETS["test-tiny"]
    model = tw.init_params(cfg, torch.Generator().manual_seed(0), device="cpu", dtype=dtype)
    feats = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (1, cfg.num_mel_bins, 2 * cfg.max_source_positions)).astype(np.float32))
    return model, feats


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_embed_audio_turns_tf32_off_locally(dtype, monkeypatch):
    """For fp32 the stem's convolutions run inside cudnn.flags(allow_tf32=
    False), the caller's other cuDNN flags passed through; bf16 leaves the
    flags alone."""
    seen = []
    real = torch.backends.cudnn.flags

    def flags(**kw):
        seen.append(kw)
        return real(**kw)

    monkeypatch.setattr(torch.backends.cudnn, "flags", flags)
    model, feats = _tiny(dtype)
    with torch.no_grad():
        tw.embed_audio(model, feats, dtype)
    if dtype == torch.bfloat16:
        assert seen == []
        return
    assert seen == [dict(enabled=torch.backends.cudnn.enabled,
                         benchmark=torch.backends.cudnn.benchmark,
                         deterministic=torch.backends.cudnn.deterministic, allow_tf32=False)]


def test_fp32_encoder_and_decoder_run_with_tf32_off(monkeypatch):
    """Inside an fp32 model's encoder, decoder and decode step every
    projection sees both TF32 flags off, whatever the caller set; after the
    call the caller's flags are back."""
    matmul, cudnn = torch.backends.cuda.matmul, torch.backends.cudnn
    saved = (matmul.allow_tf32, cudnn.allow_tf32)
    seen = []
    real_dense = tw.dense

    def dense(lin, x):
        seen.append((matmul.allow_tf32, cudnn.allow_tf32))
        return real_dense(lin, x)

    monkeypatch.setattr(tw, "dense", dense)
    model, feats = _tiny(torch.float32)
    try:
        matmul.allow_tf32, cudnn.allow_tf32 = True, True
        enc = tw.encode(model, feats, device="cpu")
        cache = tw.init_cache(model, enc, 8, device="cpu")
        tw.decode(model, torch.tensor([[1, 2]]), cache=cache, device="cpu")
        tw.decode(model, torch.tensor([[1, 2]]), enc, device="cpu")
        assert seen and set(seen) == {(False, False)}
        assert (matmul.allow_tf32, cudnn.allow_tf32) == (True, True)
    finally:
        matmul.allow_tf32, cudnn.allow_tf32 = saved
