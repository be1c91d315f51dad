"""The port's distillation training vs the JAX package's, fp32 on the CPU.

A tiny teacher with head dim 64 (d_model 128, 2 heads, 2+4 layers) from the
JAX `init_params` with perturbed biases and LayerNorm terms, bridged into
the port by `params_from_jax`; the student keeps decoder layers {0, 3}.
Inputs are seeded numpy. The JAX side runs with attn_impl "xla" and
"pallas" (its flash kernels in interpret mode); the port takes its kernels'
plain twins on the CPU.

Tolerances (fp32 sums in different orders): losses rtol 1e-5 + atol 1e-6
(the KL of a student drawn from its teacher is ~1e-2, and differs by
~1e-7); gradients atol 1e-6 + rtol 1e-4 (their largest entries are ~1e-1);
parameters after three AdamW steps at lr 1e-3 atol 1e-2 x lr, a hundredth
of one step's update (Adam's m/sqrt(v) turns the rounding of gradients
near zero into ~6e-4 x lr here).
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from kotoba_whisper_tpu.core.config import WhisperConfig as JaxConfig
from kotoba_whisper_tpu.models import student_init as jsi
from kotoba_whisper_tpu.models import whisper as jw
from kotoba_whisper_tpu.train import distill as jd
from kotoba_whisper_tpu.train import optim as jo
from kotoba_whisper_tpu_torch.core.config import WhisperConfig
from kotoba_whisper_tpu_torch.models import whisper as tw
from kotoba_whisper_tpu_torch.models.convert import params_from_jax
from kotoba_whisper_tpu_torch.models.student_init import init_student_from_teacher
from kotoba_whisper_tpu_torch.train import distill as td
from kotoba_whisper_tpu_torch.train import optim as to

TINY = dict(
    vocab_size=300, num_mel_bins=16, d_model=128, encoder_layers=2,
    encoder_attention_heads=2, decoder_layers=4, decoder_attention_heads=2,
    encoder_ffn_dim=192, decoder_ffn_dim=192, max_source_positions=24,
    max_target_positions=16, pad_token_id=0, bos_token_id=1, eos_token_id=1,
    decoder_start_token_id=2,
)
LOSS_TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_TOL = dict(atol=1e-6, rtol=1e-4)
LR = 1e-3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny CPU tensors: one intra-op thread, so torch's thread pool does
    not spin-wait on cores the parallel test workers oversubscribe."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def teachers():
    jcfg = JaxConfig(**TINY)
    params = jw.init_params(jax.random.key(0), jcfg)
    leaves, treedef = jax.tree.flatten(params)
    rng = np.random.default_rng(1)
    leaves = [np.asarray(x) + rng.standard_normal(x.shape).astype(np.float32) * 0.02
              for x in leaves]
    params = jax.tree.unflatten(treedef, [jnp.asarray(x) for x in leaves])
    return jcfg, params, params_from_jax(jax.tree.map(np.asarray, params), WhisperConfig(**TINY))


def _students(teachers):
    jcfg, jteacher, tteacher = teachers
    jstudent, js_cfg = jsi.init_student_from_teacher(jteacher, jcfg, decoder_layers=2)
    tstudent, ts_cfg = init_student_from_teacher(tteacher, WhisperConfig(**TINY), decoder_layers=2)
    return jstudent, js_cfg, tstudent, ts_cfg


def _batch(seed, b=4, t=10):
    """Every row has the same -100 tail, so microbatch halves hold equal
    numbers of valid tokens and their mean equals the full batch's."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(3, TINY["vocab_size"], (b, t)).astype(np.int32)
    labels[:, -3:] = -100
    feats = rng.standard_normal(
        (b, TINY["num_mel_bins"], 2 * TINY["max_source_positions"])).astype(np.float32)
    dii = np.array(jw.shift_labels_right(jnp.asarray(labels), 2, 0))
    return {"input_features": feats, "labels": labels, "decoder_input_ids": dii}


def _jax_batch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _torch_batch(batch):
    return {"input_features": torch.from_numpy(batch["input_features"]),
            "labels": torch.from_numpy(batch["labels"]).long(),
            "decoder_input_ids": torch.from_numpy(batch["decoder_input_ids"]).long()}


def _jax_dc(attn_impl, **kw):
    return jd.DistillConfig(compute_dtype=jnp.float32, attn_impl=attn_impl, remat=True, **kw)


def _port_dc(**kw):
    return td.DistillConfig(compute_dtype=torch.float32, remat=True, **kw)


def _as_state_dict(jax_tree, cfg):
    return params_from_jax(jax.tree.map(np.asarray, jax_tree), cfg).state_dict()


def test_student_init_matches_jax(teachers):
    """Exact weights, and fresh tensors: writing the student leaves the
    teacher alone."""
    jstudent, js_cfg, tstudent, ts_cfg = _students(teachers)
    assert ts_cfg == WhisperConfig(**{**TINY, "decoder_layers": 2})
    ref = _as_state_dict(jstudent, ts_cfg)
    got = tstudent.state_dict()
    assert set(got) == set(ref)
    for name in got:
        torch.testing.assert_close(got[name], ref[name], rtol=0, atol=0, msg=name)
    teacher = teachers[2]
    before = teacher.model.decoder.layers[3].fc1.weight.clone()
    with torch.no_grad():
        tstudent.model.decoder.layers[1].fc1.weight.add_(1.0)
    torch.testing.assert_close(teacher.model.decoder.layers[3].fc1.weight, before)


@pytest.mark.parametrize("attn_impl", ["xla", "pallas"])
def test_forward_matches_jax(teachers, attn_impl):
    """`forward` (encoder + full-sequence decoder, remat on) against the JAX
    forward, and with the encoder output handed in; atol/rtol 1e-4 as
    tests/test_torch_whisper.py."""
    jcfg, jteacher, tteacher = teachers
    batch = _batch(6)
    jlogits, jenc = jw.forward(jteacher, jcfg, jnp.asarray(batch["input_features"]),
                               jnp.asarray(batch["decoder_input_ids"]),
                               attn_impl=attn_impl, remat=True)
    tb = _torch_batch(batch)
    logits, enc = tw.forward(tteacher, tb["input_features"], tb["decoder_input_ids"],
                             compute_dtype=torch.float32, remat=True, device="cpu")
    np.testing.assert_allclose(enc.detach().numpy(), np.asarray(jenc), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits), atol=1e-4, rtol=1e-4)
    again, same = tw.forward(tteacher, None, tb["decoder_input_ids"], encoder_out=enc,
                             device="cpu")
    assert same is enc
    torch.testing.assert_close(again, logits, rtol=0, atol=0)


def test_losses_and_shift_match_jax():
    rng = np.random.default_rng(3)
    s = rng.standard_normal((2, 6, 40)).astype(np.float32)
    t = rng.standard_normal((2, 6, 40)).astype(np.float32)
    labels = rng.integers(0, 40, (2, 6)).astype(np.int32)
    labels[0, -2:] = -100
    np.testing.assert_allclose(
        float(td.kl_divergence(torch.from_numpy(s), torch.from_numpy(t),
                               torch.from_numpy(labels), 2.0)),
        float(jd.kl_divergence(jnp.asarray(s), jnp.asarray(t), jnp.asarray(labels), 2.0)),
        **LOSS_TOL)
    np.testing.assert_allclose(
        float(tw.ce_loss(torch.from_numpy(s), torch.from_numpy(labels))),
        float(jw.ce_loss(jnp.asarray(s), jnp.asarray(labels))), **LOSS_TOL)
    np.testing.assert_array_equal(
        tw.shift_labels_right(torch.from_numpy(labels), 7, 5).numpy(),
        np.asarray(jw.shift_labels_right(jnp.asarray(labels), 7, 5)))


@pytest.mark.parametrize("attn_impl", ["xla", "pallas"])
def test_distill_loss_and_grads_match_jax(teachers, attn_impl):
    jcfg, jteacher, tteacher = teachers
    jstudent, js_cfg, tstudent, _ = _students(teachers)
    batch = _batch(4)
    (jloss, jm), jgrads = jax.value_and_grad(jd.distill_loss, has_aux=True)(
        jstudent, jteacher, js_cfg, jcfg, _jax_dc(attn_impl), _jax_batch(batch))
    td.freeze_encoder_(tstudent)
    loss, m = td.distill_loss(tstudent, tteacher, _port_dc(), _torch_batch(batch))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), **LOSS_TOL)
    np.testing.assert_allclose(float(m["ce_loss"]), float(jm["ce_loss"]), **LOSS_TOL)
    np.testing.assert_allclose(float(m["kl_loss"]), float(jm["kl_loss"]), **LOSS_TOL)
    ref = _as_state_dict(jgrads, js_cfg)
    n_dec = 0
    for name, p in tstudent.named_parameters():
        if name.startswith("model.encoder."):
            assert p.grad is None and float(ref[name].abs().max()) == 0.0, name
            continue
        torch.testing.assert_close(p.grad, ref[name], **GRAD_TOL, msg=name)
        n_dec += 1
    assert n_dec == 2 * 24 + 2 + 2  # 2 decoder layers, embeddings, final LayerNorm


@pytest.mark.parametrize("attn_impl", ["xla", "pallas"])
def test_three_train_steps_match_jax(teachers, attn_impl):
    """make_train_step at lr 1e-3, warmup 1 (the first step runs at lr 0):
    metrics every step, parameters after the third."""
    jcfg, jteacher, tteacher = teachers
    jstudent, js_cfg, tstudent, _ = _students(teachers)
    tx, jsched = jo.make_optimizer(jstudent, lr=LR, warmup_steps=1)
    jstate = jd.init_train_state(jstudent, tx)
    jstep = jax.jit(jd.make_train_step(js_cfg, jcfg, _jax_dc(attn_impl), tx, jsched))

    td.freeze_encoder_(tstudent)
    opt, sched = to.make_optimizer(tstudent, lr=LR, warmup_steps=1)
    state = td.TrainState(tstudent, opt)
    step = td.make_train_step(_port_dc(), sched, device="cpu")
    enc_before = {k: v.clone() for k, v in tstudent.model.encoder.state_dict().items()}
    for i in range(3):
        batch = _batch(10 + i)
        jstate, jm = jstep(jstate, jteacher, _jax_batch(batch))
        m = step(state, tteacher, _torch_batch(batch))
        for key in ("loss", "ce_loss", "kl_loss", "grad_norm", "learning_rate"):
            np.testing.assert_allclose(float(m[key]), float(jm[key]), **LOSS_TOL,
                                       err_msg=f"step {i} {key}")
    assert state.step == int(jstate.step) == 3
    ref = _as_state_dict(jstate.params, js_cfg)
    for name, p in tstudent.state_dict().items():
        torch.testing.assert_close(p, ref[name], atol=1e-2 * LR, rtol=0, msg=name)
    for name, p in tstudent.model.encoder.state_dict().items():
        assert torch.equal(p, enc_before[name]), name


def test_microbatches_match_one_batch(teachers):
    """num_microbatches=2 takes the mean of the halves' gradients: with
    equal valid-token counts per half, the gradients and metrics of one
    batch. The optimizer is a recorder of the gradients it is handed."""

    class Recorder:
        def step(self, count):
            self.grads = {n: p.grad.clone() for n, p in model.named_parameters()
                          if p.grad is not None}
            return torch.zeros(())

    runs = []
    for mb in (1, 2):
        _, _, model, _ = _students(teachers)
        td.freeze_encoder_(model)
        state = td.TrainState(model, Recorder())
        m = td.make_train_step(_port_dc(num_microbatches=mb), device="cpu")(
            state, teachers[2], _torch_batch(_batch(20)))
        runs.append((m, state.optimizer.grads))
    (m1, g1), (m2, g2) = runs
    for key in ("loss", "ce_loss", "kl_loss"):
        np.testing.assert_allclose(float(m2[key]), float(m1[key]), **LOSS_TOL, err_msg=key)
    assert set(g1) == set(g2) and not any(n.startswith("model.encoder.") for n in g1)
    for name in g1:
        torch.testing.assert_close(g2[name], g1[name], **GRAD_TOL, msg=name)


def test_optimizer_pieces_match_optax(teachers):
    """Schedules at every count, the decay mask, and the global-norm clip
    (above and below max_norm) against optax."""
    for kind, total in (("constant_with_warmup", None), ("linear", 12)):
        jsched = jo.lr_schedule(kind, 3e-4, 4, total)
        sched = to.lr_schedule(kind, 3e-4, 4, total)
        for c in range(15):
            np.testing.assert_allclose(sched(c), float(jsched(c)), rtol=1e-6, atol=1e-12)
    jcfg, jteacher, tteacher = teachers
    ref = _as_state_dict(
        jax.tree.map(lambda m, p: np.full(p.shape, m, np.float32), jo.decay_mask(jteacher),
                     jteacher), WhisperConfig(**TINY))
    mask = to.decay_mask(tteacher)
    jax_mask = {name: bool(ref[name].flatten()[0]) for name in mask}
    # The JAX mask tests ndim on scan-stacked (L, d) leaves, so it decays the
    # layers' projection biases against its own rule ("False for biases");
    # the port keeps the rule. Everything else agrees.
    differ = {n for n in mask if mask[n] != jax_mask[n]}
    assert differ == {n for n in mask if ".layers." in n and n.endswith(".bias")
                      and "layer_norm" not in n}
    assert not any(mask[n] for n in differ)
    rng = np.random.default_rng(5)
    grads = [rng.standard_normal(s).astype(np.float32) for s in ((3, 4), (5,))]
    for max_norm in (0.5, 100.0):
        jclip = optax.clip_by_global_norm(max_norm)
        want, _ = jclip.update([jnp.asarray(g) for g in grads], jclip.init(None))
        params = [torch.zeros(g.shape, requires_grad=True) for g in grads]
        for p, g in zip(params, grads):
            p.grad = torch.from_numpy(g.copy())
        norm = to.clip_by_global_norm_(params, max_norm)
        np.testing.assert_allclose(float(norm), float(optax.global_norm(grads)), rtol=1e-6)
        for p, w in zip(params, want):
            np.testing.assert_allclose(p.grad.numpy(), np.asarray(w), rtol=1e-6)


def test_loader_reraises_producer_error(tmp_path):
    """A batch that fails to assemble (a truncated shard) raises in the
    training loop. (The JAX ScheduleLoader's producer ends the split
    silently instead; the port does not copy that.)"""
    from kotoba_whisper_tpu_torch.data.shards import ShardWriter, shard_path
    from kotoba_whisper_tpu_torch.train.loader import ScheduleLoader

    w = ShardWriter(str(tmp_path), shard_size=4)
    for i in range(8):
        w.add({"labels": [2, 3, 4]}, np.zeros((16, 48), np.float32))
    w.close()
    with open(shard_path(str(tmp_path), 1), "r+b") as f:
        f.truncate(200)
    loader = ScheduleLoader([str(tmp_path)], seed=0, global_batch=4, num_epochs=1)
    with pytest.raises(ValueError):
        list(loader.batches())


def test_trainer_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        td.make_train_step(_port_dc())
