"""KWT_FA_NOMAX and KWT_FA_EXP2 in the port against the JAX package.

The twins (`flash_attention_reference(..., no_max, exp2)`,
`flash_attention_int8_reference(..., no_max)`) and the wrappers' CPU path
against the JAX package's `_flash_fwd(..., no_max=True, interpret=True)`
and its `flash_attention` with the variables set. KWT_FA_EXP2 is read while
the JAX package traces `_flash_fwd`, so every case that sets or clears it
calls `jax.clear_caches()` before and after (the `exp2_env` fixture);
otherwise a trace made before would keep the other branch.

Bounds: fp32 O atol 2e-5 / rtol 1e-4 and LSE atol 1e-5
(test_torch_flash_attention.py's); K8 1e-4 (test_torch_flash_int8.py's:
the integer products are exact on both sides); bf16 O within two bf16 ulps
of the larger output (2^-7 relative, atol 2^-7 times the largest |O|): both
sides compute the same fp32 scores and p, in other summation orders, and P
and O are each rounded to bf16 once, so an output near a rounding boundary
may land one ulp apart, and a p that flips its own bf16 rounding moves O
by less than another.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kotoba_whisper_tpu.core.config import PRESETS as JAX_PRESETS
from kotoba_whisper_tpu.core.config import SpecialTokens as JaxSpecialTokens
from kotoba_whisper_tpu.decode import greedy as jg
from kotoba_whisper_tpu.models import whisper as jw
from kotoba_whisper_tpu.ops import flash_attention as jfa
from kotoba_whisper_tpu_torch.core.config import PRESETS, SpecialTokens
from kotoba_whisper_tpu_torch.decode import greedy as tg
from kotoba_whisper_tpu_torch.models import whisper as tw
from kotoba_whisper_tpu_torch.models.convert import params_from_jax
from kotoba_whisper_tpu_torch.ops import flash_attention as tfa

F32_TOL = dict(atol=2e-5, rtol=1e-4)
K8_TOL = dict(atol=1e-4, rtol=1e-4)
SWITCHES = [(True, False), (False, True), (True, True)]
IDS = ["nomax", "exp2", "nomax+exp2"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny CPU tensors: one intra-op thread, so torch's thread pool does
    not spin-wait on cores the parallel test workers oversubscribe."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def exp2_env(monkeypatch):
    """Sets KWT_FA_EXP2 (and KWT_FA_NOMAX) for one case, with the JAX
    package's traces dropped before and after it."""
    jax.clear_caches()

    def set_switches(no_max, exp2):
        for name, on in (("KWT_FA_NOMAX", no_max), ("KWT_FA_EXP2", exp2)):
            if on:
                monkeypatch.setenv(name, "1")
            else:
                monkeypatch.delenv(name, raising=False)

    yield set_switches
    monkeypatch.delenv("KWT_FA_EXP2", raising=False)
    jax.clear_caches()


def _qkv(seed, b, tq, tk, h=2, d=64):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, tq, h, d)).astype(np.float32),
            rng.standard_normal((b, tk, h, d)).astype(np.float32),
            rng.standard_normal((b, tk, h, d)).astype(np.float32))


def _to_bh(x):
    b, t, h, d = x.shape
    return jnp.asarray(x).transpose(0, 2, 1, 3).reshape(b * h, t, d)


def _jax_fwd(q, k, v, no_max, int8_mode="", dtype=jnp.float32):
    """The JAX package's `_flash_fwd` in interpret mode at the blocks its
    `_fwd_call` picks -> (O (B, Tq, H, D), LSE (B, H, Tq)) as numpy fp32."""
    b, tq, h, d = q.shape
    block_q, block_k = jfa._blocks(tq, k.shape[1])
    o, lse = jfa._flash_fwd(*(_to_bh(x).astype(dtype) for x in (q, k, v)), causal=False,
                            block_q=block_q, block_k=block_k, interpret=True,
                            int8_mode=int8_mode, no_max=no_max)
    o = np.asarray(o.astype(jnp.float32)).reshape(b, h, tq, d).transpose(0, 2, 1, 3)
    return o, np.asarray(lse)[..., 0].reshape(b, h, tq)


def _t(*xs, dtype=torch.float32):
    return [torch.from_numpy(x).to(dtype) for x in xs]


def _rel(a, b):
    a, b = (torch.as_tensor(np.array(x)).double() for x in (a, b))
    return float((a - b).norm() / b.norm())


@pytest.mark.parametrize("tq, tk", [(150, 150), (37, 200)])
@pytest.mark.parametrize("no_max, exp2", SWITCHES, ids=IDS)
def test_k1_twin_matches_jax_fp32(exp2_env, no_max, exp2, tq, tk):
    """O and LSE of the twin, and of the wrapper's CPU path with the
    variables set, against JAX's one-shot kernel under the same switches."""
    q, k, v = _qkv(tq + 7 * tk, 2, tq, tk)
    exp2_env(no_max, exp2)
    ref_o, ref_lse = _jax_fwd(q, k, v, no_max)
    o, lse = tfa.flash_attention_reference(*_t(q, k, v), no_max=no_max, exp2=exp2)
    np.testing.assert_allclose(o.numpy(), ref_o, **F32_TOL)
    np.testing.assert_allclose(lse.numpy(), ref_lse, atol=1e-5)
    wo, wlse = tfa.flash_attention_fwd(*_t(q, k, v))  # the switches from the environment
    assert torch.equal(wo, o) and torch.equal(wlse, lse)


@pytest.mark.parametrize("no_max, exp2", SWITCHES, ids=IDS)
def test_k1_twin_matches_jax_bf16(exp2_env, no_max, exp2):
    """bf16 inputs: JAX's interpret-mode bf16 kernel against the bf16 twin,
    O within two bf16 ulps of the largest output (module docstring), the
    fp32 LSE within 1e-4 (its scores are exact products of bf16 values in
    both, summed in other orders)."""
    q, k, v = _qkv(5, 2, 130, 130)
    exp2_env(no_max, exp2)
    ref_o, ref_lse = _jax_fwd(q, k, v, no_max, dtype=jnp.bfloat16)
    o, lse = tfa.flash_attention_reference(*_t(q, k, v, dtype=torch.bfloat16), no_max=no_max,
                                           exp2=exp2)
    assert o.dtype == torch.bfloat16
    bound = 2.0 ** -7 * float(np.abs(ref_o).max())
    np.testing.assert_allclose(o.float().numpy(), ref_o, atol=bound, rtol=2.0 ** -7)
    np.testing.assert_allclose(lse.numpy(), ref_lse, atol=1e-4)


@pytest.mark.parametrize("no_max, exp2", SWITCHES, ids=IDS)
def test_public_flash_attention_matches_jax(exp2_env, no_max, exp2):
    """Both packages' `flash_attention` with the variables set."""
    q, k, v = _qkv(9, 1, 70, 90)
    exp2_env(no_max, exp2)
    ref = np.asarray(jfa.flash_attention(*map(jnp.asarray, (q, k, v))))
    got = tfa.flash_attention(*_t(q, k, v))
    np.testing.assert_allclose(got.detach().numpy(), ref, **F32_TOL)


@pytest.mark.parametrize("mode", ["qk", "qkpv"])
def test_k8_no_max_matches_jax(monkeypatch, mode):
    """K8's no-max twin and the wrapper under KWT_FA_INT8 and KWT_FA_NOMAX
    against JAX's int8 kernel with no_max, and the public paths."""
    q, k, v = _qkv(1234, 2, 300, 300, h=4)
    ref_o, ref_lse = _jax_fwd(q, k, v, True, int8_mode=mode)
    k8, ks = tfa.quantize_k_rows(torch.from_numpy(k))
    v_in, vs = tfa.quantize_v_cols(torch.from_numpy(v)) if mode == "qkpv" else (
        torch.from_numpy(v), None)
    o, lse = tfa.flash_attention_int8_reference(torch.from_numpy(q), k8, ks, v_in, vs,
                                                mode == "qkpv", True)
    np.testing.assert_allclose(o.numpy(), ref_o, **K8_TOL)
    np.testing.assert_allclose(lse.numpy(), ref_lse, **K8_TOL)
    monkeypatch.setenv("KWT_FA_INT8", mode)
    monkeypatch.setenv("KWT_FA_NOMAX", "1")
    wo, wlse = tfa.flash_attention_fwd(*_t(q, k, v))
    assert torch.equal(wo, o) and torch.equal(wlse, lse)
    np.testing.assert_allclose(
        tfa.flash_attention(*_t(q, k, v)).detach().numpy(),
        np.asarray(jfa.flash_attention(*map(jnp.asarray, (q, k, v)))), **K8_TOL)


@pytest.mark.parametrize("form", ["K1", "K8 qk", "K8 qkpv"])
def test_underflow_witness_matches_jax(form):
    """Rows whose bound exceeds the row max by >= 110 come out exactly zero
    in the port as in JAX (the JAX fault the port copies), their LSE the
    bound + ln 1e-30 within 1e-4 relative; the max-based twin reads
    rel-L2 >= 0.5 away; the tight rows agree with it."""
    q, k, v = (x.numpy() for x in tfa.no_max_witness(1, 200, 2, seed=3))
    slack = tfa.no_max_slack(*_t(q, k))
    assert float(slack[..., 1::2].min()) >= 110 and float(slack[..., 0::2].max()) <= 60
    mode = "" if form == "K1" else form.split()[1]
    ref_o, ref_lse = _jax_fwd(q, k, v, True, int8_mode=mode)
    o, lse = tfa.flash_attention_fwd(*_t(q, k, v), int8_mode=mode, no_max=True)
    max_o, _ = tfa.flash_attention_fwd(*_t(q, k, v), int8_mode=mode, no_max=False)
    assert np.all(ref_o[:, 1::2] == 0) and torch.all(o[:, 1::2] == 0)
    np.testing.assert_allclose(o.numpy(), ref_o, **(F32_TOL if form == "K1" else K8_TOL))
    np.testing.assert_allclose(lse.numpy(), ref_lse, rtol=1e-4)
    assert _rel(max_o, o) >= 0.5 and _rel(max_o, ref_o) >= 0.5
    np.testing.assert_allclose(max_o[:, 0::2].numpy(), o[:, 0::2].numpy(),
                               **(F32_TOL if form == "K1" else K8_TOL))


@pytest.mark.parametrize("no_max, exp2", SWITCHES, ids=IDS)
@pytest.mark.parametrize("call", ["causal", "long"])
def test_switches_leave_causal_and_long_calls(exp2_env, no_max, exp2, call):
    """Causal calls and calls over more than SINGLE_STEP_MAX_K keys run the
    default twin bit for bit under either switch, and K4 matches JAX's
    online-softmax kernel with the variables set."""
    if call == "causal":
        q, k, v = _qkv(21, 1, 100, 100)
    else:
        q, k, v = _qkv(22, 1, 4, tfa.SINGLE_STEP_MAX_K + 4, h=1)
    exp2_env(no_max, exp2)
    causal = call == "causal"
    o, lse = tfa.flash_attention_fwd(*_t(q, k, v), causal=causal)
    ro, rlse = tfa.flash_attention_reference(*_t(q, k, v), causal)
    assert torch.equal(o, ro) and torch.equal(lse, rlse)
    if causal:
        ref = np.asarray(jfa.flash_attention(*map(jnp.asarray, (q, k, v)), causal=True))
        np.testing.assert_allclose(o.numpy(), ref, **F32_TOL)


@pytest.mark.parametrize("mode", ["qk", "qkpv"])
def test_exp2_does_not_apply_under_an_int8_mode(exp2_env, monkeypatch, mode):
    """JAX's int8 kernel takes no exp2: with KWT_FA_EXP2 set, K8's output
    is its output without, and JAX's under both variables."""
    q, k, v = _qkv(31, 1, 90, 90)
    monkeypatch.setenv("KWT_FA_INT8", mode)
    base = tfa.flash_attention_fwd(*_t(q, k, v))
    exp2_env(False, True)
    got = tfa.flash_attention_fwd(*_t(q, k, v))
    assert torch.equal(got[0], base[0]) and torch.equal(got[1], base[1])
    ref = np.asarray(jfa.flash_attention(*map(jnp.asarray, (q, k, v))))
    np.testing.assert_allclose(got[0].numpy(), ref, **K8_TOL)


@pytest.mark.parametrize("value, on", [("0", False), ("1", True), ("true", True),
                                       ("false", True), ("", True), (None, False)])
def test_a_switch_is_off_only_at_0_or_unset(monkeypatch, value, on):
    """As the JAX package reads them: `os.environ.get(name, "0") != "0"`;
    off, the wrappers give the default twin's output bit for bit."""
    for name in ("KWT_FA_NOMAX", "KWT_FA_EXP2"):
        if value is None:
            monkeypatch.delenv(name, raising=False)
        else:
            monkeypatch.setenv(name, value)
    assert tfa.read_switches() == (on, on)
    q, k, v = _t(*_qkv(41, 1, 20, 20))
    o, lse = tfa.flash_attention_fwd(q, k, v)
    ro, rlse = tfa.flash_attention_reference(q, k, v, no_max=on, exp2=on)
    assert torch.equal(o, ro) and torch.equal(lse, rlse)


def test_no_max_gradients_match_jax(monkeypatch):
    """KWT_FA_NOMAX: gradients of q, k and v through the no-max forward's O
    and LSE and the backward (K5's twin; JAX's Pallas backward on its
    no-max LSE) against jax.grad, fp32, 1e-4."""
    q, k, v = _qkv(51, 1, 130, 150)
    g = np.random.default_rng(52).standard_normal(q.shape).astype(np.float32)
    monkeypatch.setenv("KWT_FA_NOMAX", "1")
    ref = jax.grad(lambda q, k, v: jnp.vdot(jfa.flash_attention(q, k, v), g),
                   argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    tq, tk, tv = (x.requires_grad_() for x in _t(q, k, v))
    tfa.flash_attention(tq, tk, tv).backward(torch.from_numpy(g))
    for name, got, r in zip("qkv", (tq.grad, tk.grad, tv.grad), ref):
        np.testing.assert_allclose(got.numpy(), np.asarray(r), atol=1e-4, rtol=1e-4,
                                   err_msg=f"d{name}")


ST = SpecialTokens.layout(256, 99)
JST = JaxSpecialTokens.layout(256, 99)


@pytest.fixture(scope="module")
def tiny():
    """test-greedy's tiny model (weights x4, far from ties), its port copy
    through the weight bridge, and three mel inputs."""
    jcfg = JAX_PRESETS["test-byte"].replace(max_source_positions=64)
    tcfg = PRESETS["test-byte"].replace(max_source_positions=64)
    params = jax.tree.map(lambda x: x * 4.0, jw.init_params(jax.random.key(3), jcfg))
    model = params_from_jax(jax.tree.map(np.asarray, params), tcfg)
    mel = np.random.default_rng(0).standard_normal((3, 80, 128)).astype(np.float32)
    return jcfg, params, model, mel


@pytest.mark.parametrize("no_max, exp2", SWITCHES, ids=IDS)
def test_encoder_and_greedy_tokens_match_jax(exp2_env, tiny, no_max, exp2):
    """The slice: the tiny model's encoder (1e-4) and 24 greedy tokens
    (exact) under each switch, the port's default path against JAX's
    flash-attention encoder (attn_impl="pallas", where the JAX package reads
    the switches)."""
    jcfg, params, model, mel = tiny
    exp2_env(no_max, exp2)
    ref = np.asarray(jw.encode(params, jcfg, jnp.asarray(mel), attn_impl="pallas"))
    got = tw.encode(model, torch.from_numpy(mel), device="cpu").numpy()
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=1e-4)
    prompt = tg.transcribe_prompt(ST, ST.lang_begin + 7)
    opts = dict(prompt_ids=prompt, max_length=24)
    ref_tokens = np.asarray(jg.generate_greedy(params, jcfg, jnp.asarray(mel),
                                               jg.GenerateOptions(**opts), JST,
                                               attn_impl="pallas"))
    tokens = tg.generate_greedy(model, torch.from_numpy(mel), tg.GenerateOptions(**opts), ST,
                                device="cpu").numpy()
    np.testing.assert_array_equal(tokens, ref_tokens)
