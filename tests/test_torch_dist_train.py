"""Training on a device mesh (the port's ``optim.compression``,
``runtime.dp_step``, ``runtime.pipeline_parallel`` and the sharded
``train.step.make_train_step(mesh=)``) against the JAX reference, on
gloo process groups on the CPU.

One spawn of four ranks runs every case (the port's meshes over one
process group: ``('data',)`` 4, ``('pipe',)`` 4, ``(data, model)`` (2, 2),
(1, 4) and (1, 2)), while one JAX subprocess with four fake devices runs
the reference's side of every case; a module fixture shares both.  The
ranks import this module to find their work: it imports no JAX at
module level.

  * ``quantize_int8`` / ``dequantize_int8`` and ``compressed_psum`` over
    4 ranks bit for bit the reference's (its ``compressed_psum`` under
    ``jax.vmap(axis_name='dp')``, as ``tests/test_quant.py`` runs it),
    and the bytes its collectives carry (the int32 sum as many as fp32);
  * ``compress_tree_psum``'s small-leaf rule;
  * the reference suite's toy regression (``tests/test_distributed.py``)
    below loss 1e-2 in 150 steps of ``make_compressed_dp_step``; five
    steps of a 64 x 64 regression, compressed and plain, against the
    reference's ``make_compressed_dp_step`` on its 4-device mesh;
  * ``pipeline_apply`` over 4 stages against the reference's, and its
    gradients against the sequential ones (the port's and the
    reference's ``jax.grad``);
  * the sharded train step on (2, 2), reduced qwen2-1.5b at N=2, against
    the reference's unsharded jitted step (``tests/test_distributed.py::
    test_pjit_train_step_matches_single_device``'s): the loss, Σ|params|
    and every leaf;
  * the mesh path's gradients against the unsharded ones where its other
    layouts run: sequence-sharded attention (reduced qwen2-1.5b on (1,
    4)) and expert parallelism (reduced granite-moe-3b-a800m on (1, 2)).
"""
import functools
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch import interop
from repro_torch.configs import get_config
from repro_torch.core import MuxSpec
from repro_torch.core import quant
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import TransformerLM
from repro_torch.optim import (AdamW, compress_tree_psum, compressed_psum,
                               reference_leaves)
from repro_torch.runtime import (init_dp_state, local_batch,
                                 make_compressed_dp_step, pipeline_apply,
                                 stack_stages)
from repro_torch.runtime.sharding import shard_params
from repro_torch.train import causal_lm_loss, make_train_step
from repro_torch.train.step import _map, mesh_mean, value_and_grad

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
RANKS = 4
SPAWN_TIMEOUT = 120
REF_TIMEOUT = 300
TOY_STEPS = 150
TRAJ_STEPS = 5
TRAJ_LR = 0.01
LM_LR = 1e-3
# pipeline: the stages applied in turn, the same fp32 ops; the
# reference suite's tolerance (measured 3.0e-7 from the reference's)
PIPE_TOL = 1e-5
# the pipeline's gradients against the sequential ones (the port's in
# the same process and the reference's jax.grad), against the largest
# |grad|: fp32 summation order (measured 1.7e-7 and 4.4e-7)
PIPE_GRAD_TOL = 1e-6
# five DP steps against the reference's (measured 1.2e-8 compressed and
# plain: no int8 rounding of the two packages' gradients fell apart)
TRAJ_TOL = 1e-6
# the sharded step against the reference's unsharded one: the reference
# suite's bars
LOSS_TOL = 1e-4
PSUM_RTOL = 1e-5
# one AdamW step at LM_LR, each leaf: Adam moves an element by about lr
# * g / |g|, so a gradient near zero in fp32 moves it by fp32 noise times
# lr / |g|.  Every element within LEAF_MAX (measured 4.5e-5, an ffn down
# weight; the port's unsharded step is 4.2e-5 from the reference there)
# and LEAF_SHARE of them within LEAF_TOL (measured: 15 of 104704 past)
LEAF_TOL = 1e-6
LEAF_MAX = 1e-4
LEAF_SHARE = 0.999
# a mesh layout's gradients against the unsharded path's, each leaf
# against the tree's largest |grad| (measured 2.7e-7 sequence-sharded,
# 3.8e-7 expert-parallel)
MESH_GRAD_TOL = 1e-6
# the sharded step's grad norm against the unsharded path's, relative:
# fp32 sums of squares in another order (measured 0; the (2, 2)
# gradients are 2.3e-7 of the largest from the unsharded ones)
NORM_RTOL = 1e-5


# ------------------------------------------------------------ inputs

def _qwen_cfg():
    return get_config("qwen2-1.5b", reduced=True).replace(n_layers=2,
                                                          remat=False)


@functools.lru_cache(maxsize=None)
def _inputs():
    """Every case's inputs, seeded numpy."""
    f32 = np.float32
    rng = np.random.default_rng(11)
    psum = (rng.standard_normal((RANKS, 64, 64), f32),
            0.01 * np.random.default_rng(12).standard_normal((RANKS, 64, 64),
                                                             f32))
    rng = np.random.default_rng(13)
    tree = {"big": rng.standard_normal((RANKS, 64, 64), f32),
            "vec": rng.standard_normal((RANKS, 5000), f32),
            "small": rng.standard_normal((RANKS, 8, 8), f32)}
    rng = np.random.default_rng(14)
    w_true = rng.standard_normal((64, 64), f32) / 8
    b_true = rng.standard_normal((64,), f32)
    batches = []
    for i in range(TRAJ_STEPS):
        x = np.random.default_rng(100 + i).standard_normal((16, 64), f32)
        batches.append({"x": x, "y": x @ w_true + b_true})
    pipe = {"w": [0.3 * np.random.default_rng(20 + i).standard_normal(
                (16, 16), f32) for i in range(RANKS)],
            "x": np.random.default_rng(30).standard_normal((5, 4, 16), f32),
            "r": np.random.default_rng(31).standard_normal((5, 4, 16), f32)}
    tokens = np.random.default_rng(40).integers(
        4, _qwen_cfg().vocab_size, (8, 16)).astype(np.int64)
    return {"psum": psum, "tree": tree, "traj": batches, "pipe": pipe,
            "tokens": tokens}


# ------------------------------------------------------------ the ranks

def _np(t):
    """A copy (a step updates the params in place)."""
    return t.detach().cpu().numpy().copy()


def _toy_loss(params, batch, generator):
    pred = batch["x"] @ params["w"]
    return ((pred - batch["y"]) ** 2).mean(), {}


def _affine_loss(params, batch, generator):
    pred = batch["x"] @ params["w"] + params["b"]
    return ((pred - batch["y"]) ** 2).mean(), {}


def _stage_fn(p, x):
    return torch.tanh(x @ p["w"])


def _lm_loss(cfg, mux, mesh):
    ctx = None if mesh is None else {"mesh": mesh}

    def loss_fn(params, batch, generator):
        out = TransformerLM.apply(params, cfg, batch["tokens"], mux=mux,
                                  dtype=torch.float32, use_kernels=False,
                                  extra_ctx=ctx)
        loss = causal_lm_loss(out["logits"], batch["tokens"])
        if cfg.moe is not None:
            loss = loss + cfg.moe.router_aux_weight * out["aux"]
        return loss, {}
    return loss_fn


def _compression(mesh, inp):
    r = mesh.coords["data"]
    g, e = inp["psum"]
    mesh.bytes.clear()
    mean, err = compressed_psum(torch.as_tensor(g[r]), torch.as_tensor(e[r]),
                                mesh, "data")
    wire = dict(mesh.bytes)
    grads = {k: torch.as_tensor(v[r]) for k, v in inp["tree"].items()}
    errs = {k: torch.full_like(v, 0.5) for k, v in grads.items()}
    means, res = compress_tree_psum(grads, errs, mesh, "data")
    big = compressed_psum(grads["big"], errs["big"], mesh, "data")
    return {"mean": _np(mean), "err": _np(err), "wire": wire,
            "tree": ({k: _np(v) for k, v in means.items()},
                     {k: _np(v) for k, v in res.items()}),
            "big": tuple(map(_np, big))}


def _toy(mesh):
    """The reference suite's toy regression on the port's DP step."""
    w_true = np.random.default_rng(0).normal(size=(8, 1)).astype(np.float32)
    opt = AdamW(lr=0.05, weight_decay=0.0)
    state = init_dp_state({"w": torch.zeros(8, 1)}, opt)
    step = make_compressed_dp_step(_toy_loss, opt, mesh=mesh)
    for i in range(TOY_STEPS):
        x = np.random.default_rng(i).normal(size=(16, 8)).astype(np.float32)
        batch = local_batch({"x": torch.as_tensor(x),
                             "y": torch.as_tensor(x @ w_true)}, mesh)
        state, m = step(state, batch, torch.Generator().manual_seed(i))
    return float(m["loss"])


def _trajectory(mesh, batches, compress):
    opt = AdamW(lr=TRAJ_LR, weight_decay=0.0)
    state = init_dp_state({"w": torch.zeros(64, 64), "b": torch.zeros(64)},
                          opt)
    step = make_compressed_dp_step(_affine_loss, opt, mesh=mesh,
                                   compress=compress)
    out = []
    for i, b in enumerate(batches):
        state, m = step(state, local_batch(
            {k: torch.as_tensor(v) for k, v in b.items()}, mesh),
            torch.Generator().manual_seed(i))
        out.append(({k: _np(v) for k, v in state["params"].items()},
                    float(m["loss"])))
    return out


def _pipeline(mesh, case):
    """This stage's output and gradients of sum(y * r), the pipeline's and
    the sequential blocks' in this process; the pipeline also over the
    whole stack."""
    s = mesh.coords["pipe"]
    x = torch.as_tensor(case["x"]).requires_grad_()
    mine = {"w": torch.as_tensor(case["w"][s])[None].requires_grad_()}
    y = pipeline_apply(_stage_fn, mine, x, mesh=mesh)
    r = torch.as_tensor(case["r"])
    gw, gx = torch.autograd.grad((y * r).sum(), [mine["w"], x])
    whole = stack_stages([{"w": torch.as_tensor(w)} for w in case["w"]])
    with torch.no_grad():
        y_whole = pipeline_apply(_stage_fn, whole, x, mesh=mesh)
    ws = [torch.as_tensor(w).requires_grad_() for w in case["w"]]
    xs = torch.as_tensor(case["x"]).requires_grad_()
    h = xs
    for w in ws:
        h = _stage_fn({"w": w}, h)
    seq = torch.autograd.grad((h * r).sum(), [ws[s], xs])
    return {"y": _np(y), "y_whole": _np(y_whole), "gw": _np(gw[0]),
            "gx": _np(gx), "seq_y": _np(h), "seq_gw": _np(seq[0]),
            "seq_gx": _np(seq[1]), "counts": dict(mesh.counts)}


def _whole(mesh, shards, tree):
    """``tree`` (the shards' params or their gradients) whole on every
    rank: each leaf of a param split over ``model`` gathered along its
    ``model_axis``, a vocab-split table's zero row dropped first."""
    out = []
    for (_, _, p, t) in reference_leaves(shards, tree):
        a = getattr(p, "model_axis", None)
        if a is not None:
            if hasattr(p, "vocab_rows"):
                t = t[:p.vocab_rows]
            t = mesh.gather(t.detach().contiguous(), "model", a)
        out.append(t)
    return out


def _sharded_step(mesh, tokens):
    """One sharded AdamW step of reduced qwen2-1.5b at N=2 from the seeded
    init; before it, the step's gradients (averaged over ``data``,
    gathered) and grad norm against the unsharded path's on the whole
    batch; the whole params (reference layout) from the first rank."""
    cfg, mux = _qwen_cfg(), MuxSpec(n=2)
    pat = len(cfg.block_pattern)
    full = TransformerLM.init(torch.Generator().manual_seed(0), cfg, mux)
    _, _, want = value_and_grad(_lm_loss(cfg, mux, None), full,
                                {"tokens": torch.as_tensor(tokens)},
                                torch.Generator().manual_seed(0))
    want = [g for _, _, g in reference_leaves(want)]
    want_norm = float(torch.sqrt(sum(g.square().sum() for g in want)))
    params = shard_params(full, mesh, pattern=pat)
    loss_fn = _lm_loss(cfg, mux, mesh)
    batch = local_batch({"tokens": torch.as_tensor(tokens)}, mesh, n_mux=2)
    loss, _, got = value_and_grad(loss_fn, params, batch,
                                  torch.Generator().manual_seed(0))
    _, got, norm = mesh_mean(mesh, loss, got, params)
    gmax = max(float(g.abs().max()) for g in want)
    grad_err = max(float((g - w).abs().max()) / gmax
                   for g, w in zip(_whole(mesh, params, got), want))
    opt = AdamW(lr=LM_LR, pattern=pat)
    step = make_train_step(loss_fn, opt, mesh=mesh)
    mesh.counts.clear()
    params, _, m = step(params, opt.init(params), batch,
                        torch.Generator().manual_seed(0))
    out = {"loss": float(m["loss"]), "counts": dict(mesh.counts),
           "rows": batch["tokens"].shape[0], "grad_err": grad_err,
           "norm": (float(norm), float(m["grad_norm"])),
           "want_norm": want_norm}
    whole = dict(zip((id(p) for _, _, p in reference_leaves(params)),
                     _whole(mesh, params, params)))
    if not any(mesh.coords.values()):
        out["params"] = interop.params_to_reference(
            _map(lambda p: whole[id(p)], params), cfg)
    return out


def _mesh_grads(mesh, arch, tokens):
    """The largest difference of any gradient of the mesh path (gathered)
    from the unsharded path's, over the largest |grad|; None on a rank
    past the mesh."""
    if mesh is None:
        return None
    cfg, mux = get_config(arch, reduced=True), MuxSpec(n=2)
    pat = len(cfg.block_pattern)
    full = TransformerLM.init(torch.Generator().manual_seed(1), cfg, mux)
    batch = {"tokens": torch.as_tensor(tokens)}
    gen = torch.Generator().manual_seed(0)
    want_loss, _, want = value_and_grad(_lm_loss(cfg, mux, None), full,
                                        batch, gen)
    shards = shard_params(full, mesh, pattern=pat)
    loss, _, got = value_and_grad(_lm_loss(cfg, mux, mesh), shards, batch,
                                  gen)
    gmax = max(float(g.abs().max()) for _, _, g in reference_leaves(want))
    err = max(float((g - w).abs().max()) / gmax for g, (_, _, w) in
              zip(_whole(mesh, shards, got), reference_leaves(want)))
    return {"err": err, "loss": abs(float(loss) - float(want_loss)),
            "split": sum(hasattr(p, "model_axis")
                         for _, _, p in reference_leaves(shards))}


def _rank(mesh, inp):
    """Every case on this rank (``mesh``: the spawn's (4, 1))."""
    torch.set_num_threads(1)
    out = {"compression": _compression(mesh, inp), "toy": _toy(mesh),
           "traj": {c: _trajectory(mesh, inp["traj"], c)
                    for c in (True, False)}}
    out["pipe"] = _pipeline(mesh_lib.make_mesh({"pipe": RANKS},
                                               device="cpu"), inp["pipe"])
    out["sharded"] = _sharded_step(mesh_lib.make_serve_mesh(2, 2,
                                                            device="cpu"),
                                   inp["tokens"])
    out["seq_grads"] = _mesh_grads(mesh_lib.make_serve_mesh(
        1, 4, device="cpu"), "qwen2-1.5b", inp["tokens"])
    out["ep_grads"] = _mesh_grads(mesh_lib.make_serve_mesh(
        1, 2, device="cpu"), "granite-moe-3b-a800m", inp["tokens"])
    return out


# ------------------------------------------------------------ the reference

REF_SCRIPT = r"""
import pickle, sys
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import Mesh
from repro.configs import get_config
from repro.core import MuxSpec
from repro.core.quant import dequantize_int8, quantize_int8
from repro.models import TransformerLM
from repro.optim import AdamW
from repro.optim.compression import compressed_psum
from repro.runtime import (init_dp_state, make_compressed_dp_step,
                           pipeline_apply, stack_stages)
from repro.train.losses import causal_lm_loss

with open(sys.argv[1], "rb") as f:
    inp = pickle.load(f)
out = {}
g, e = (jnp.asarray(a) for a in inp["psum"])
mean, err = jax.vmap(lambda g, e: compressed_psum(g, e, "dp"),
                     axis_name="dp")(g, e)
out["psum"] = (np.asarray(mean), np.asarray(err))
q, s = quantize_int8(g[0])
out["quant"] = (np.asarray(q), np.asarray(s),
                np.asarray(dequantize_int8(q, s)))

mesh = Mesh(np.array(jax.devices()[:4]).reshape(4), ("data",))
def loss_fn(params, batch, rng):
    pred = batch["x"] @ params["w"] + params["b"]
    return jnp.mean((pred - batch["y"]) ** 2), {}
for compress in (True, False):
    opt = AdamW(lr=inp["traj_lr"], weight_decay=0.0)
    state = init_dp_state({"w": jnp.zeros((64, 64)), "b": jnp.zeros(64)},
                          opt)
    step = make_compressed_dp_step(loss_fn, opt, mesh=mesh,
                                   compress=compress)
    traj = []
    for i, b in enumerate(inp["traj"]):
        state, m = step(state, {k: jnp.asarray(v) for k, v in b.items()},
                        jax.random.PRNGKey(i))
        traj.append(({k: np.asarray(v) for k, v in state["params"].items()},
                     float(m["loss"])))
    out["traj", compress] = traj

pipe = inp["pipe"]
pmesh = Mesh(np.array(jax.devices()[:4]).reshape(4), ("pipe",))
def stage_fn(p, x):
    return jnp.tanh(x @ p["w"])
stages = [{"w": jnp.asarray(w)} for w in pipe["w"]]
x, r = jnp.asarray(pipe["x"]), jnp.asarray(pipe["r"])
out["pipe_y"] = np.asarray(pipeline_apply(stage_fn, stack_stages(stages), x,
                                          mesh=pmesh))
def seq(ws, x):
    for w in ws:
        x = stage_fn({"w": w}, x)
    return jnp.sum(x * r)
gws, gx = jax.grad(seq, argnums=(0, 1))([s["w"] for s in stages], x)
out["pipe_grads"] = ([np.asarray(w) for w in gws], np.asarray(gx))

cfg = get_config("qwen2-1.5b", reduced=True).replace(n_layers=2, remat=False)
mux = MuxSpec(n=2)
params = jax.tree.map(jnp.asarray, inp["qwen"])
opt = AdamW(lr=inp["lm_lr"])
toks = jnp.asarray(inp["tokens"], jnp.int32)
def lm_step(params, opt_state, tokens):
    def loss_fn(p):
        o = TransformerLM.apply(p, cfg, tokens, mux=mux, dtype=jnp.float32)
        return causal_lm_loss(o["logits"], tokens)
    loss, grads = jax.value_and_grad(loss_fn)(params)
    upd, opt_state, _ = opt.update(grads, opt_state, params)
    return opt.apply_updates(params, upd), loss
p2, loss = jax.jit(lm_step)(params, opt.init(params), toks)
out["lm"] = (float(loss),
             float(sum(jnp.sum(jnp.abs(x)) for x in jax.tree.leaves(p2))),
             jax.tree.map(np.asarray, p2))
with open(sys.argv[2], "wb") as f:
    pickle.dump(out, f)
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The four ranks' results and the reference's, run side by side."""
    tmp = tmp_path_factory.mktemp("dist_train")
    inp = _inputs()
    cfg = _qwen_cfg()
    qwen = interop.params_to_reference(TransformerLM.init(
        torch.Generator().manual_seed(0), cfg, MuxSpec(n=2)), cfg)
    ref_in, ref_out = tmp / "ref_in.pkl", tmp / "ref_out.pkl"
    with open(ref_in, "wb") as f:
        pickle.dump({**inp, "qwen": qwen, "traj_lr": TRAJ_LR,
                     "lm_lr": LM_LR}, f)
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    proc = subprocess.Popen([sys.executable, "-c", REF_SCRIPT, str(ref_in),
                             str(ref_out)], env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    try:
        ranks = mesh_lib.spawn(_rank, RANKS, 1, device="cpu", args=(inp,),
                               timeout=SPAWN_TIMEOUT, tmpdir=str(tmp))
        _, err = proc.communicate(timeout=REF_TIMEOUT)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, err
    with open(ref_out, "rb") as f:
        ref = pickle.load(f)
    return {"ranks": ranks, "ref": ref, "inp": inp}


# ------------------------------------------------------------ the cases

def test_int8_quantizer_bit_identical(runs):
    g = runs["inp"]["psum"][0][0]
    q, s = quant.quantize_int8(torch.as_tensor(g))
    want_q, want_s, want_d = runs["ref"]["quant"]
    np.testing.assert_array_equal(_np(q), want_q)
    assert q.dtype == torch.int8 and s.ndim == 0
    np.testing.assert_array_equal(_np(s), want_s)
    np.testing.assert_array_equal(_np(quant.dequantize_int8(q, s)), want_d)


def test_compressed_psum_bit_identical_to_reference(runs):
    want_mean, want_err = runs["ref"]["psum"]
    for r, res in enumerate(runs["ranks"]):
        got = res["compression"]
        np.testing.assert_array_equal(got["mean"], want_mean[r])
        np.testing.assert_array_equal(got["err"], want_err[r])


def test_compressed_psum_wire_bytes(runs):
    """The scale's MAX is one fp32; the int32 sum carries 4 bytes an
    element, as an fp32 mean would."""
    n = runs["inp"]["psum"][0][0].size
    for res in runs["ranks"]:
        assert res["compression"]["wire"] == {"grad_scale": 4,
                                              "grad_sum": 4 * n}


def test_compress_tree_small_leaf_rule(runs):
    tree = runs["inp"]["tree"]
    for res in runs["ranks"]:
        means, errs = res["compression"]["tree"]
        for k in ("vec", "small"):
            np.testing.assert_allclose(means[k], tree[k].mean(0), rtol=0,
                                       atol=1e-6)
            assert not errs[k].any(), k
        big_mean, big_err = res["compression"]["big"]
        np.testing.assert_array_equal(means["big"], big_mean)
        np.testing.assert_array_equal(errs["big"], big_err)
        assert big_err.any()


def test_toy_regression_converges(runs):
    """The reference suite's DP case on the port: 150 compressed steps on
    4 ranks (its (8, 1) weight is a small leaf: a plain mean)."""
    for res in runs["ranks"]:
        assert res["toy"] < 1e-2, res["toy"]
        assert res["toy"] == runs["ranks"][0]["toy"]


@pytest.mark.parametrize("compress", [True, False])
def test_dp_step_tracks_reference(runs, compress):
    """Five steps of a 64 x 64 affine regression (the weight compressed,
    the bias a plain mean) against the reference's
    ``make_compressed_dp_step``: every rank's params equal each other's,
    and each step's params and loss within TRAJ_TOL of the reference's."""
    want = runs["ref"]["traj", compress]
    first = runs["ranks"][0]["traj"][compress]
    for res in runs["ranks"]:
        for (p, loss), (p0, loss0) in zip(res["traj"][compress], first):
            assert loss == loss0
            for k in p:
                np.testing.assert_array_equal(p[k], p0[k])
    for i, ((p, loss), (wp, wloss)) in enumerate(zip(first, want)):
        np.testing.assert_allclose(loss, wloss, rtol=1e-6, err_msg=str(i))
        for k in p:
            np.testing.assert_allclose(p[k], wp[k], rtol=0, atol=TRAJ_TOL,
                                       err_msg=f"step {i} {k}")


def test_pipeline_matches_reference_and_sequential(runs):
    want = runs["ref"]["pipe_y"]
    want_gws, want_gx = runs["ref"]["pipe_grads"]
    for s, res in enumerate(runs["ranks"]):
        p = res["pipe"]
        assert float(np.abs(p["y"] - want).max()) < PIPE_TOL
        assert float(np.abs(p["y"] - p["seq_y"]).max()) < PIPE_TOL
        np.testing.assert_array_equal(p["y_whole"], p["y"])
        for got, want_g in ((p["gw"], p["seq_gw"]), (p["gx"], p["seq_gx"]),
                            (p["gw"], want_gws[s]), (p["gx"], want_gx)):
            np.testing.assert_allclose(
                got, want_g, rtol=0,
                atol=PIPE_GRAD_TOL * float(np.abs(want_g).max()))
        # two runs of 5 microbatches + 3 fill ticks, a shift each; the
        # backward: the reverse of the 7 shifts a later tick reads, and
        # the input's enter
        assert p["counts"] == {"shift": 16, "backward": 8,
                               "pipeline_out": 2}, p["counts"]


def test_sharded_step_matches_reference_unsharded_step(runs):
    """(2, 2): each rank holds its shards and 4 of the 8 rows (two mux
    groups); its gradients averaged over ``data`` and its grad norm (the
    one AdamW clips by) match the unsharded path's on the whole batch
    (Adam's first step hardly sees a gradient's scale); loss and
    Σ|params| within the reference suite's bars, every leaf within
    LEAF_MAX and nearly all within LEAF_TOL."""
    want_loss, want_psum, want = runs["ref"]["lm"]
    res = [r["sharded"] for r in runs["ranks"]]
    for r in res:
        assert r["rows"] == 4
        assert r["grad_err"] <= MESH_GRAD_TOL, r["grad_err"]
        for norm in r["norm"]:
            assert abs(norm - r["want_norm"]) <= NORM_RTOL * r["want_norm"], (
                r["norm"], r["want_norm"])
        assert abs(r["loss"] - want_loss) < LOSS_TOL
        assert r["counts"]["weight_gather"] > 0 and r["counts"]["backward"]
    got = res[0]["params"]
    psum = sum(float(np.abs(x).sum(dtype=np.float64))
               for _, x in _leaves(got))
    assert abs(psum - want_psum) / abs(want_psum) < PSUM_RTOL
    wl = dict(_leaves(want))
    close = total = 0
    for path, x in _leaves(got):
        d = np.abs(x - wl[path])
        assert float(d.max()) <= LEAF_MAX, path
        close += int((d <= LEAF_TOL).sum())
        total += d.size
    assert close >= LEAF_SHARE * total, (close, total)


@pytest.mark.parametrize("case", ["seq_grads", "ep_grads"])
def test_mesh_layout_gradients_match_unsharded(runs, case):
    got = [r[case] for r in runs["ranks"] if r[case] is not None]
    assert len(got) == (4 if case == "seq_grads" else 2)
    for g in got:
        assert g["split"] > 0
        assert g["err"] <= MESH_GRAD_TOL, g
        assert g["loss"] <= 1e-6, g


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}/{i}")
    elif tree is not None:
        yield path, np.asarray(tree)
