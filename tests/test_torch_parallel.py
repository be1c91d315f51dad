"""The port's parallel layer (core/mesh.py, parallel/sharded.py and the
tensor-parallel forward) vs the JAX package's, on the CPU.

Without a process group: the sharding rules against the JAX
`params_pspec_tree` on the same plain, fused and w8a8 trees; the mesh
layouts against the JAX `build_mesh`; `MeshConfig.resolve`'s error; each
rank's rows (`rank_rows`, the loader's rank slice) against the JAX
`split_order` / `ScheduleLoader` and the JAX step's sharded microbatch
reshape, for one host and for two.

With two gloo ranks (spawned processes, one torch thread each, a file
store under the test's tmp dir, a 120 s timeout): the test-byte model of
tests/test_torch_inference_transforms.py (weights x4 with noise on every
term, fp32) split over a model axis of 2 (2 of its 4 heads a rank) gives
tokens identical on both ranks, to the unsharded port and to the JAX
package's single-process run, in lockstep greedy, lockstep beam, the
greedy stream and the beam stream, each with compute and int8 KV, fused,
and fused + w8a8 (the JAX reference op by op under jax.disable_jit(), as
in the w8a8 tests there); a data axis of 2 gives the greedy tokens of one
process; shards gathered back equal the whole model exactly.
"""
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kotoba_whisper_tpu.core import mesh as jmesh
from kotoba_whisper_tpu.core.config import PRESETS as JAX_PRESETS
from kotoba_whisper_tpu.core.config import SpecialTokens as JaxSpecialTokens
from kotoba_whisper_tpu.decode import beam as jb
from kotoba_whisper_tpu.decode import greedy as jg
from kotoba_whisper_tpu.decode import streaming as js
from kotoba_whisper_tpu.decode import streaming_beam as jsb
from kotoba_whisper_tpu.models import optimized as jopt
from kotoba_whisper_tpu.models import quantized as jq
from kotoba_whisper_tpu.models import whisper as jw
from kotoba_whisper_tpu_torch.core import mesh as tmesh
from kotoba_whisper_tpu_torch.core.config import PRESETS, SpecialTokens
from kotoba_whisper_tpu_torch.models.convert import params_from_jax
from kotoba_whisper_tpu_torch.models.optimized import fuse_for_inference
from kotoba_whisper_tpu_torch.models.quantized import quantize_for_inference
from kotoba_whisper_tpu_torch.parallel.sharded import rank_rows

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ST = SpecialTokens.layout(256, 99)
JST = JaxSpecialTokens.layout(256, 99)
JCFG = JAX_PRESETS["test-byte"].replace(max_source_positions=64)
TCFG = PRESETS["test-byte"].replace(max_source_positions=64)
MAX_LEN = 16
PROMPT = (ST.sot, ST.lang_begin + 7, ST.transcribe)
# case -> (decode mode, KV dtype, transform)
CASES = {
    "greedy-compute": ("greedy", "compute", "plain"),
    "greedy-int8": ("greedy", "int8", "plain"),
    "beam-compute": ("beam", "compute", "plain"),
    "beam-int8": ("beam", "int8", "plain"),
    "stream-compute": ("stream", "compute", "plain"),
    "stream-int8": ("stream", "int8", "plain"),
    "beam_stream-compute": ("beam_stream", "compute", "plain"),
    "beam_stream-int8": ("beam_stream", "int8", "plain"),
    "greedy-int4": ("greedy", "int4", "plain"),
    "beam-int4": ("beam", "int4", "plain"),
    "stream-int4": ("stream", "int4", "plain"),
    "beam_stream-int4": ("beam_stream", "int4", "plain"),
    "greedy-fused-int8": ("greedy", "int8", "fused"),
    "beam-fused-int8": ("beam", "int8", "fused"),
    "greedy-w8a8-compute": ("greedy", "compute", "w8a8"),
    "greedy-w8a8-int8": ("greedy", "int8", "w8a8"),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny CPU tensors: one intra-op thread, so torch's thread pool does
    not spin-wait on cores the parallel test workers oversubscribe."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_params(scale=4.0):
    params = jw.init_params(jax.random.key(3), JCFG)
    leaves, treedef = jax.tree.flatten(jax.tree.map(lambda x: x * scale, params))
    rng = np.random.default_rng(1)
    leaves = [np.asarray(x) + rng.standard_normal(x.shape).astype(np.float32) * 0.02
              for x in leaves]
    return jax.tree.unflatten(treedef, [jnp.asarray(x) for x in leaves])


def _transform_jax(params, transform):
    if transform == "plain":
        return params
    params = jopt.fuse_for_inference(params)
    return jq.quantize_for_inference(params) if transform == "w8a8" else params


def _transform_port(model, transform):
    if transform == "plain":
        return model
    model = fuse_for_inference(model)
    return quantize_for_inference(model) if transform == "w8a8" else model


# ---------------------------------------------------------------------------
# Rules, meshes and rows (no process group)
# ---------------------------------------------------------------------------

_PORT_LEAF = {"weight": "kernel", "weight_q": "kernel_q", "weight_scale": "kernel_scale",
              "bias": "bias"}


def _jax_spec_for(jspecs, name):
    """The JAX spec of the leaf a port state-dict name maps to, in the
    port's dim order (per layer, (out, in) weights)."""
    parts = name.split(".")[1:]  # drop "model"
    if "layers" in parts:
        i = parts.index("layers")
        path = parts[:i + 1] + parts[i + 2:]
    else:
        path = parts
    leaf = path[-1]
    node = jspecs
    if path[-2] == "embed_positions":
        return tuple(node[path[0]]["pos_embedding"])
    for p in path[:-1]:
        node = node[p]
    if path[-2].endswith("layer_norm"):
        spec = node[{"weight": "scale", "bias": "bias"}[leaf]]
    elif path[-2] == "embed_tokens":
        spec = node["embedding"]
    else:
        spec = node[_PORT_LEAF[leaf]]
    spec = tuple(spec)
    if "layers" in parts:
        spec = spec[1:]
    if leaf in ("weight", "weight_q") and len(spec) == 2:
        spec = spec[::-1]  # (in, out) -> (out, in)
    while spec and spec[-1] is None:
        spec = spec[:-1]
    return spec


@pytest.mark.parametrize("transform", ["plain", "fused", "w8a8"])
def test_sharding_rules_match_jax(transform):
    """Every weight, int8 weight and scale follows the JAX rule in the
    port's dim order; the only differences are the column-parallel biases
    (split with their outputs here, whole in JAX, where GSPMD slices the
    add) and the conv stem (whole here, output channels split in JAX)."""
    jparams = _transform_jax(_jax_params(), transform)
    jspecs = jmesh.params_pspec_tree(jparams)
    model = _transform_port(params_from_jax(jax.tree.map(np.asarray, _jax_params()), TCFG),
                            transform)
    specs = {name: tmesh.param_spec(name) for name in model.state_dict()}
    differ = {}
    for name, spec in specs.items():
        want = _jax_spec_for(jspecs, name)
        while spec and spec[-1] is None:  # P("model", None) == P("model")
            spec = spec[:-1]
        if spec != want:
            differ[name] = (spec, want)
    col_bias = {n for n in specs if ".layers." in n and n.endswith(".bias")
                and n.split(".")[-2] in tmesh.COLUMN_PARALLEL}
    conv = {n for n in specs if ".conv" in n and n.endswith(".weight")}
    assert set(differ) == col_bias | conv
    assert all(differ[n] == (("model",), ()) for n in col_bias)
    assert all(differ[n][0] == () and "model" in differ[n][1] for n in conv)
    n_col = sum(1 for s in specs.values() if s[:1] == ("model",))
    n_row = sum(1 for s in specs.values() if s == (None, "model"))
    assert n_col and n_row


def test_mesh_config_resolve_matches_jax():
    for cfg in ((-1, 2, 8), (4, 2, 8), (2, 1, 2), (-1, 1, 1)):
        data, model, n = cfg
        assert tmesh.MeshConfig(data, model).resolve(n) == jmesh.MeshConfig(data, model).resolve(n)
    for data, model, n in ((3, 2, 8), (-1, 3, 8), (4, 4, 8)):
        with pytest.raises(ValueError) as want:
            jmesh.MeshConfig(data, model).resolve(n)
        with pytest.raises(ValueError, match=str(want.value)):
            tmesh.MeshConfig(data, model).resolve(n)


@pytest.mark.parametrize("data, model, across", [(4, 2, False), (2, 4, False), (4, 2, True),
                                                 (2, 4, True), (8, 1, False)])
def test_mesh_layout_matches_jax(data, model, across):
    """Rank r stands where the JAX mesh puts device r (devices ordered by
    process, as the port's ranks are by host)."""
    cfg = dict(data=data, model=model, model_across_processes=across)
    want = jmesh.build_mesh(jmesh.MeshConfig(**cfg), jax.devices()[:8]).devices
    got = tmesh.mesh_ranks(tmesh.MeshConfig(**cfg), 8)
    np.testing.assert_array_equal(got, np.vectorize(lambda d: d.id)(want))


@pytest.fixture(scope="module")
def split_dir(tmp_path_factory):
    from kotoba_whisper_tpu_torch.data.shards import ShardWriter

    d = str(tmp_path_factory.mktemp("split"))
    w = ShardWriter(d, shard_size=7)
    for i in range(27):
        w.add({"name": f"u{i}", "labels": [2, i, 1]}, np.full((4, 6), i, np.float32))
    w.close()
    return d


@pytest.mark.parametrize("hosts", [1, 2])
@pytest.mark.parametrize("microbatches", [1, 2])
def test_rank_rows_match_jax_loader(split_dir, hosts, microbatches):
    """Two data ranks a host, global batch 8: each rank's rows are its
    block of each microbatch of its host's JAX local batch (the JAX
    ScheduleLoader's order[host::hosts] slice, split as the JAX step's
    sharded reshape hands it to the host's devices), the features follow
    the rows, and resume positions agree."""
    from kotoba_whisper_tpu.train.loader import ScheduleLoader as JaxLoader
    from kotoba_whisper_tpu.train.loader import split_order as jax_order
    from kotoba_whisper_tpu_torch.train.loader import ScheduleLoader, split_order

    n_local, batch = 2, 8
    for p in range(hosts):
        np.testing.assert_array_equal(split_order(5, 1, 0, 27, p, hosts),
                                      jax_order(5, 1, 0, 27, p, hosts))
        ref = list(JaxLoader([split_dir], seed=5, global_batch=batch, num_epochs=2,
                             process_index=p, process_count=hosts, prefetch=False).batches())
        local = batch // hosts
        for d in range(n_local):
            loader = ScheduleLoader([split_dir], seed=5, global_batch=batch, num_epochs=2,
                                    process_index=p, process_count=hosts,
                                    rank_slice=(d, n_local), microbatches=microbatches,
                                    prefetch=False)
            got = list(loader.batches())
            assert [vars(g[0]) for g in got] == [vars(r[0]) for r in ref]
            assert loader.steps_per_epoch() == len(ref) // 2
            for (_, rows, feats), (_, jrows, _) in zip(got, ref):
                blocks = np.arange(local).reshape(microbatches, n_local, -1)[:, d].reshape(-1)
                assert [r["name"] for r in rows] == [jrows[i]["name"] for i in blocks]
                np.testing.assert_array_equal(feats[:, 0, 0],
                                              [int(r["name"][1:]) for r in rows])


def test_rank_rows_blocks():
    np.testing.assert_array_equal(rank_rows(8, 1, 2), [4, 5, 6, 7])
    np.testing.assert_array_equal(rank_rows(8, 1, 2, microbatches=2), [2, 3, 6, 7])
    np.testing.assert_array_equal(rank_rows(6, 2, 3), [4, 5])
    with pytest.raises(ValueError, match="does not split"):
        rank_rows(8, 0, 3)


# ---------------------------------------------------------------------------
# Two gloo ranks
# ---------------------------------------------------------------------------

WORKER = r"""
import json, os, sys
import numpy as np
import torch

torch.set_num_threads(1)
rank, root = int(sys.argv[1]), sys.argv[2]
from kotoba_whisper_tpu_torch.core.config import PRESETS, SpecialTokens
from kotoba_whisper_tpu_torch.core.mesh import MeshConfig, build_mesh
from kotoba_whisper_tpu_torch.decode import greedy as tg
from kotoba_whisper_tpu_torch.decode.beam import generate_beam
from kotoba_whisper_tpu_torch.decode.streaming import StreamConfig, generate_greedy_streaming
from kotoba_whisper_tpu_torch.decode.streaming_beam import (
    BeamStreamConfig, generate_beam_streaming)
from kotoba_whisper_tpu_torch.models.convert import model_from_state_dict
from kotoba_whisper_tpu_torch.models.optimized import fuse_for_inference
from kotoba_whisper_tpu_torch.models.quantized import quantize_for_inference
from kotoba_whisper_tpu_torch.parallel import multihost, sharded

cases = json.load(open(os.path.join(root, "cases.json")))
multihost.initialize("file://" + os.path.join(root, "store"), 2, rank, device="cpu")
tp = build_mesh(MeshConfig(data=1, model=2))
dp = build_mesh(MeshConfig(data=2, model=1))
cfg = PRESETS["test-byte"].replace(max_source_positions=64)
ST = SpecialTokens.layout(256, 99)
sd = dict(np.load(os.path.join(root, "model.npz")))
mel = torch.from_numpy(np.load(os.path.join(root, "mel.npy")))
opts = tg.GenerateOptions(prompt_ids=tuple(cases["prompt"]), max_length=cases["max_len"])

def model(transform):
    m = model_from_state_dict(sd, cfg)
    if transform != "plain":
        fuse_for_inference(m)
    if transform == "w8a8":
        quantize_for_inference(m)
    return m

def run(m, mode, kv, x):
    if mode == "greedy":
        return tg.generate_greedy(m, x, opts, ST, kv_dtype=kv, device="cpu").numpy()
    if mode == "beam":
        return generate_beam(m, x, opts, ST, num_beams=3, kv_dtype=kv, device="cpu")[0].numpy()
    if mode == "stream":
        return generate_greedy_streaming(m, x.numpy(), opts, ST, kv_dtype=kv, device="cpu",
            stream=StreamConfig(batch=2, encode_batch=2, steps_per_round=4))
    return generate_beam_streaming(m, x.numpy(), opts, ST, kv_dtype=kv, device="cpu",
        stream=BeamStreamConfig(groups=2, num_beams=3, encode_batch=2, steps_per_round=4))[0]

out = {}
for name, (mode, kv, transform) in cases["cases"].items():
    m = sharded.place_params(tp, model(transform), model_sharded=True)
    assert m.model.decoder.layers[0].fc2.weight_q.shape[1] * 2 == cfg.decoder_ffn_dim \
        if transform == "w8a8" else m.model.decoder.layers[0].fc2.weight.shape[1] * 2 == \
        cfg.decoder_ffn_dim
    out[name] = run(m, mode, kv, mel)
    if name in ("greedy-compute", "greedy-fused-int8", "greedy-w8a8-int8"):
        whole = model(transform).state_dict()
        back = sharded.gather_params(tp, m)
        out["roundtrip-" + name] = np.array(
            [set(back) == set(whole)] + [torch.equal(back[k], whole[k]) for k in whole])
m = sharded.place_params(dp, model("plain"), model_sharded=False)
mine = sharded.place_batch(dp, mel)
toks = tg.generate_greedy(m, mine, opts, ST, kv_dtype="int8", device="cpu").numpy()
out["dp-greedy-int8"] = multihost.all_gather_host(toks)
out["dp-rows"] = multihost.all_gather_host(np.asarray([mine.shape[0]]))
np.savez(os.path.join(root, f"out{rank}.npz"), **out)
multihost.barrier()
multihost.shutdown()
print(f"WORKER_{rank}_OK", flush=True)
"""


def spawn_ranks(script: str, root, n: int = 2, timeout: int = 120, args=()):
    """Run `script` as n ranks (argv: rank, root, *args), each with one
    torch thread; raise with their output unless all exit 0."""
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""),
               OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-c", script, str(r), str(root), *args],
                              cwd=REPO, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(n)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            p.kill()
    for r, (p, o) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r}:\n{o[-4000:]}"
    return outs


@pytest.fixture(scope="module")
def tp_runs(tmp_path_factory):
    """The JAX references, the unsharded port's tokens, and both ranks'
    outputs of one two-rank run of every case."""
    root = tmp_path_factory.mktemp("tp")
    params = _jax_params()
    plain = params_from_jax(jax.tree.map(np.asarray, params), TCFG)
    np.savez(root / "model.npz", **{k: v.numpy() for k, v in plain.state_dict().items()})
    mel = np.random.default_rng(0).standard_normal((4, 80, 128)).astype(np.float32)
    np.save(root / "mel.npy", mel)
    (root / "cases.json").write_text(json.dumps(
        {"cases": CASES, "prompt": PROMPT, "max_len": MAX_LEN}))
    outs = spawn_ranks(WORKER, root)
    assert all(f"WORKER_{r}_OK" in o for r, o in enumerate(outs))
    ranks = [dict(np.load(root / f"out{r}.npz")) for r in range(2)]
    return params, mel, ranks


def _jax_tokens(params, mel, mode, kv, transform):
    from contextlib import nullcontext

    opts = jg.GenerateOptions(prompt_ids=PROMPT, max_length=MAX_LEN)
    p = _transform_jax(params, transform)
    with jax.disable_jit() if transform == "w8a8" else nullcontext():
        if mode == "greedy":
            return np.asarray(jg.generate_greedy(p, JCFG, jnp.asarray(mel), opts, JST,
                                                 kv_dtype=kv))
        if mode == "beam":
            return np.asarray(jb.generate_beam(p, JCFG, jnp.asarray(mel), opts, JST,
                                               num_beams=3, kv_dtype=kv)[0])
        if mode == "stream":
            return np.asarray(js.generate_greedy_streaming(
                p, JCFG, mel, opts, JST, kv_dtype=kv,
                stream=js.StreamConfig(batch=2, encode_batch=2, steps_per_round=4)))
        return np.asarray(jsb.generate_beam_streaming(
            p, JCFG, mel, opts, JST, kv_dtype=kv,
            stream=jsb.BeamStreamConfig(groups=2, num_beams=3, encode_batch=2,
                                        steps_per_round=4))[0])


def _port_tokens(params, mel, mode, kv, transform):
    from kotoba_whisper_tpu_torch.decode import greedy as tg
    from kotoba_whisper_tpu_torch.decode.beam import generate_beam
    from kotoba_whisper_tpu_torch.decode.streaming import StreamConfig, generate_greedy_streaming
    from kotoba_whisper_tpu_torch.decode.streaming_beam import (
        BeamStreamConfig,
        generate_beam_streaming,
    )

    m = _transform_port(params_from_jax(jax.tree.map(np.asarray, params), TCFG), transform)
    opts = tg.GenerateOptions(prompt_ids=PROMPT, max_length=MAX_LEN)
    x = torch.from_numpy(mel)
    if mode == "greedy":
        return tg.generate_greedy(m, x, opts, ST, kv_dtype=kv, device="cpu").numpy()
    if mode == "beam":
        return generate_beam(m, x, opts, ST, num_beams=3, kv_dtype=kv, device="cpu")[0].numpy()
    if mode == "stream":
        return generate_greedy_streaming(m, mel, opts, ST, kv_dtype=kv, device="cpu",
                                         stream=StreamConfig(batch=2, encode_batch=2,
                                                             steps_per_round=4))
    return generate_beam_streaming(m, mel, opts, ST, kv_dtype=kv, device="cpu",
                                   stream=BeamStreamConfig(groups=2, num_beams=3,
                                                           encode_batch=2,
                                                           steps_per_round=4))[0]


@pytest.mark.parametrize("case", list(CASES))
def test_tp2_tokens_match_unsharded_and_jax(tp_runs, case):
    params, mel, ranks = tp_runs
    mode, kv, transform = CASES[case]
    want = _jax_tokens(params, mel, mode, kv, transform)
    np.testing.assert_array_equal(_port_tokens(params, mel, mode, kv, transform), want)
    for r in ranks:
        np.testing.assert_array_equal(r[case], want)


@pytest.mark.parametrize("case", ["greedy-compute", "greedy-fused-int8", "greedy-w8a8-int8"])
def test_tp2_shards_gather_to_the_whole_model(tp_runs, case):
    """gather_params(place_params(model)) is the model's state dict, bit
    for bit, on both ranks (plain, fused, fused + w8a8)."""
    for r in tp_runs[2]:
        assert r["roundtrip-" + case].all()


def test_dp2_greedy_matches_one_process(tp_runs):
    """Each data rank decodes its 2 of the 4 rows; gathered in rank order
    they are the one-process tokens."""
    params, mel, ranks = tp_runs
    want = _port_tokens(params, mel, "greedy", "int8", "plain")
    for r in ranks:
        np.testing.assert_array_equal(r["dp-rows"], [2, 2])
        np.testing.assert_array_equal(r["dp-greedy-int8"], want)


def test_tp_refuses_a_model_axis_that_does_not_divide():
    from kotoba_whisper_tpu_torch.parallel.sharded import check_divides

    check_divides(TCFG, 2)
    with pytest.raises(ValueError, match="does not divide encoder_attention_heads=4"):
        check_divides(TCFG, 3)
    with pytest.raises(ValueError, match="encoder_ffn_dim=128"):
        check_divides(TCFG.replace(encoder_attention_heads=6, decoder_attention_heads=6), 3)
