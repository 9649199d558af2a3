"""Training of the port against the JAX reference on the CPU: data,
losses, AdamW, the supervisor, the kernels' refusal of autograd, remat,
the three-stage recipe, the CLI, every stage's gradients and multi-step
trajectories.  Both packages start from the port's seeded init carried
to the reference's layout (``_model``), checked against the shapes of
the reference's own init.

  * ``MarkovCorpus``, both tasks and ``ShardedLoader`` (shards and a
    restart) bit for bit the reference's; the reference's statistical
    tests of ``mlm_mask`` / ``electra_corrupt`` on the port's; the
    initializers' and dropout's distributions;
  * the four losses and their gradients within 1e-6 of the reference's;
  * ``AdamW.update`` with both schedules and clipping on every leaf of
    reduced rwkv6-7b, reduced qwen2-1.5b and a tiny MuxBERT (2 layers,
    d 64, N=2) within ``OPT_TOL`` of the reference's over four steps:
    rwkv's ``dec_w0`` / ``mu_cm`` decayed as on the reference's stacked
    layout, ``mux/v`` frozen with ``m`` and ``v`` kept; the reference
    suite's optimizer cases on the port;
  * gradients with remat on and off equal (MuxBERT's periods, RWKV's
    nested chunk remat);
  * the reference's ``test_three_stage_training_learns`` on the port,
    with its bars (stage 3 fine-tunes longer at a lower lr: its 80-step
    bar is fragile in the reference too, ROADMAP §3);
  * ``Supervisor``: the reference suite's cases, and a fault at step k
    with ``ReplayableIterator`` ends in the fault-free run's params;
  * each ``kernels.ops`` wrapper raises under autograd on an input that
    requires grad, and not under ``torch.no_grad()``;
  * the CLI on the CPU: the reference's stage lines and step counts, its
    refusals;
  * the loss and every gradient of each MUX stage (retrieval, MLM with
    its auxiliary retrieval objective, ELECTRA, classification, token
    classification) on a tiny MuxBERT (``tests/test_system.py``'s), and
    of the causal LM on reduced qwen2-1.5b and rwkv6-7b, against the
    reference's ``jax.value_and_grad``: each leaf within ``GRAD_TOL`` of
    the tree's largest |grad| (a key bias's gradient is zero in exact
    arithmetic and noise in both packages, so a per-leaf relative test
    cannot hold), the loss within ``LOSS_RTOL``; the MLM and ELECTRA
    stages get the reference's masks (``mux_stages.mlm_mask`` /
    ``electra_corrupt`` patched), the packages' generators differing;
  * five AdamW steps of the retrieval stage (in two microbatches) and of
    the classification stage from identical params and optimizer state:
    each step's loss and the final params against the reference's jitted
    step within ``TRAJ_TOL``, nearly all within 1e-6 (``TRAJ_SHARE``).
"""
import functools
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_config as ref_config
from repro.core import MuxSpec as RefMux
from repro.data import (MarkovCorpus as RefCorpus, ShardedLoader as RefLoader,
                        classification_task as ref_cls_task,
                        electra_corrupt as ref_electra,
                        mlm_mask as ref_mlm_mask, token_task as ref_tok_task)
from repro.models import TransformerLM as RefLM
from repro.models.bert import MuxBERT as RefBERT, bert_config as ref_bert
from repro.optim import (AdamW as RefAdamW,
                         linear_warmup_cosine_decay as ref_cos,
                         linear_warmup_linear_decay as ref_lin)
from repro.optim.adamw import path_str as ref_path_str
from repro.train import causal_lm_loss as ref_causal
from repro.train import jit_step as ref_jit_step
from repro.train import losses as ref_losses
from repro.train import make_train_step as ref_make_step
from repro.train import mux_stages as ref_stages
from repro_torch import interop
from repro_torch.checkpoint import AsyncCheckpointManager
from repro_torch.configs import get_config
from repro_torch.core import MuxEngine, MuxSpec
from repro_torch.data import (MASK_ID, N_SPECIAL, MarkovCorpus, ShardedLoader,
                              classification_task, electra_corrupt, mlm_mask,
                              token_task)
from repro_torch.kernels import ops
from repro_torch.launch import train as cli
from repro_torch.models import MuxBERT, TransformerLM, bert_config
from repro_torch.nn.initializers import (fanin_init, normal_init, ones_init,
                                        truncated_normal_init, zeros_init)
from repro_torch.nn.layers import dropout
from repro_torch.optim import (AdamW, global_norm, linear_warmup_cosine_decay,
                               linear_warmup_linear_decay, path_str,
                               reference_leaves)
from repro_torch.runtime import DeviceFailure, ReplayableIterator, Supervisor
from repro_torch.train import losses, make_train_step, mux_stages
from repro_torch.train.mux_stages import (classification_stage, mlm_stage,
                                          retrieval_stage)
from test_torch_model import _leaves

torch.set_num_threads(2)

KEY = jax.random.PRNGKey(0)
BERT = dict(n_layers=2, d_model=64, n_heads=4, d_ff=128, vocab_size=256,
            max_seq_len=32)               # tests/test_system.py's CFG
CFG = bert_config("small", **BERT)
CFG_R = ref_bert("small", **BERT)
MUX, REF_MUX = MuxSpec(n=2), RefMux(n=2)
# AdamW against the reference, four steps: the same fp32 arithmetic,
# rounded in other places (the global norm summed per layer here and per
# stacked leaf there, XLA's fusions); measured: every element within 2e-6
# relative plus 5.4e-9 absolute
OPT_TOL = dict(rtol=2e-6, atol=1e-7)
# the same computation twice on the CPU: its reductions are not bitwise
# repeatable (measured: gradients ~1e-9 apart run to run, remat or not)
REPEAT_TOL = 1e-6
# a stage's gradients, each leaf against the tree's largest |grad|:
# measured 4.1e-6 for rwkv6-7b (its chunked recurrence sums in another
# order; 1.1e-5 from other seeded weights), <= 3.8e-7 for the others
GRAD_TOL = 2e-5
LOSS_RTOL = 1e-5         # measured <= 2.3e-7
# five AdamW steps from the same weights, learning rates summing to
# 7.5e-3 (the most Adam moves a weight in them): Adam divides each
# gradient by its own running size, so where a gradient is near zero (a
# key bias's, zero in exact arithmetic; rare embedding rows) fp32 noise
# sets the step.  Every final param within 1e-4 absolute and at least
# TRAJ_SHARE of them within 1e-6 (measured: worst 5.5e-5 and 172 of
# 114688 elements past 1e-6, the retrieval stage in two microbatches;
# 8.6e-6 and 49 of 119043 for classification); losses within 1e-5
# relative each step (measured 1.8e-7), grad norms within 1e-5 (2.3e-6)
TRAJ_TOL = dict(rtol=0, atol=1e-4)
TRAJ_SHARE = 0.995


def _np(t):
    return t.detach().cpu().numpy()


def _grads_of(loss_fn, params, *args):
    """(loss, grads in the params' structure) of the port's loss_fn."""
    leaves = [x[2] for x in reference_leaves(params)]
    for t in leaves:
        t.requires_grad_(True)
    loss = loss_fn(params, *args)
    gs = torch.autograd.grad(loss, leaves, allow_unused=True)
    by_id = dict(zip(map(id, leaves), gs))

    def fill(t):
        if isinstance(t, dict):
            return {k: fill(v) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return type(t)(fill(v) for v in t)
        g = by_id[id(t)]
        return torch.zeros_like(t) if g is None else g
    for t in leaves:
        t.requires_grad_(False)
    return loss.detach(), fill(params)


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

def test_corpus_and_tasks_bit_identical():
    for vocab, seed in ((128, 7), (512, 0)):
        mine, want = MarkovCorpus(vocab, seed=seed), RefCorpus(vocab,
                                                               seed=seed)
        np.testing.assert_array_equal(
            mine.sample(np.random.default_rng(1), 4, 32),
            want.sample(np.random.default_rng(1), 4, 32))
    for mk, ref in ((classification_task(256, 3, seed=1),
                     ref_cls_task(256, 3, seed=1)),
                    (token_task(256, 5, seed=2), ref_tok_task(256, 5,
                                                              seed=2))):
        for a, b in zip(mk(np.random.default_rng(3), 8, 32),
                        ref(np.random.default_rng(3), 8, 32)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


def test_loader_shards_and_restart_match_reference():
    corpus = MarkovCorpus(vocab_size=128, seed=0)

    def mk(cls, sid):
        return cls(lambda rng, b, l: corpus.sample(rng, b, l), 8, 16,
                   shard_id=sid, n_shards=2, seed=3)
    l0, l1, r0, r1 = mk(ShardedLoader, 0), mk(ShardedLoader, 1), \
        mk(RefLoader, 0), mk(RefLoader, 1)
    b0, b1 = next(l0), next(l1)
    np.testing.assert_array_equal(b0, next(r0))
    np.testing.assert_array_equal(b1, next(r1))
    assert b0.shape == (4, 16) and not np.array_equal(b0, b1)
    np.testing.assert_array_equal(next(l0), next(r0))
    assert l0.state_dict() == r0.state_dict() == {"step": 2, "seed": 3}
    again = mk(ShardedLoader, 0)
    again.load_state_dict({"step": 0, "seed": 3})
    np.testing.assert_array_equal(next(again), b0)
    with pytest.raises(ValueError, match="not divisible"):
        ShardedLoader(lambda *a: None, 9, 4, n_shards=2)


def _toks():
    return torch.as_tensor(MarkovCorpus(vocab_size=512, seed=0).sample(
        np.random.default_rng(0), 32, 128))


def test_mlm_mask_stats():
    """tests/test_data.py's bars on the port's masking."""
    toks = _toks()
    inp, labels, w = mlm_mask(torch.Generator().manual_seed(0), toks,
                              vocab=512, rate=0.15)
    assert 0.10 < float(w.mean()) < 0.20
    assert 0.08 < float((inp == MASK_ID).float().mean()) < 0.16
    assert torch.equal(labels, toks)
    keep = w == 0
    assert torch.equal(inp[keep], toks[keep])
    rand = (w == 1) & (inp != MASK_ID) & (inp != toks)
    assert 0.0 < float(rand.float().mean()) < 0.03      # ~10% of 15%
    assert int(inp.min()) >= 0 and int(inp.max()) < 512


def test_electra_corrupt():
    toks = _toks()
    inp, is_rep = electra_corrupt(torch.Generator().manual_seed(0), toks,
                                  vocab=512, rate=0.15)
    assert torch.equal(is_rep == 1.0, inp != toks)
    assert 0.08 < float(is_rep.mean()) < 0.2
    assert int(inp.min()) >= N_SPECIAL


def test_dropout_keeps_expectation_and_is_seeded():
    x = torch.ones(200, 200)
    g = torch.Generator().manual_seed(0)
    assert dropout(g, x, 0.3, deterministic=True) is x
    y = dropout(g, x, 0.3, deterministic=False)
    assert set(torch.unique(y).tolist()) <= {0.0, float(
        torch.tensor(1.0) / 0.7)}
    assert abs(float(y.mean()) - 1.0) < 0.02
    assert torch.equal(dropout(torch.Generator().manual_seed(0), x, 0.3,
                               deterministic=False), y)


def test_initializers():
    """The reference's initializers' distributions: N(0, std²), N(0, 1)
    truncated to [-2, 2] times std, zeros, ones, LeCun normal on the
    penultimate dim."""
    g = torch.Generator().manual_seed(0)
    x = normal_init(g, (400, 500), 0.02)
    assert abs(float(x.std()) - 0.02) < 5e-4 and abs(float(x.mean())) < 1e-3
    t = truncated_normal_init(g, (400, 500), 0.5)
    assert float(t.abs().max()) <= 1.0 and float(t.std()) < 0.5
    assert torch.equal(zeros_init(g, (3, 2)), torch.zeros(3, 2))
    assert torch.equal(ones_init(g, (3,)), torch.ones(3))
    f = fanin_init(g, (2, 256, 300))
    assert abs(float(f.std()) - 256 ** -0.5) < 2e-3
    assert torch.equal(normal_init(torch.Generator().manual_seed(0),
                                   (400, 500), 0.02), x)


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------

def _loss_args(name, weighted):
    """(the loss's float inputs, port loss of tensors, reference loss of
    arrays) on seeded (2, 7) positions over 11 classes."""
    rng = np.random.default_rng(0)
    lg = rng.normal(size=(2, 7, 11)).astype(np.float32) * 3
    lab = rng.integers(0, 11, (2, 7)).astype(np.int32)
    w = (rng.random((2, 7)) < 0.6).astype(np.float32) if weighted else None
    tw = None if w is None else torch.as_tensor(w)
    if name.startswith("chunked_vocab_xent"):
        chunk = int(name.split("/")[1])
        floats = (rng.normal(size=(2, 7, 5)).astype(np.float32),
                  rng.normal(size=(11, 5)).astype(np.float32),
                  rng.normal(size=(11,)).astype(np.float32))
        return floats, (lambda h, t, b: losses.chunked_vocab_xent(
            h, t, torch.as_tensor(lab), tw, bias=b, chunk=chunk)), (
            lambda h, t, b: ref_losses.chunked_vocab_xent(
                h, t, lab, w, bias=b, chunk=chunk))
    if name == "sigmoid_bce":
        lg, lab = lg[..., 0], (lab % 2).astype(np.float32)
    return (lg,), (lambda x: getattr(losses, name)(x, torch.as_tensor(lab),
                                                   tw)), (
        lambda x: getattr(ref_losses, name)(x, lab, w))


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("name", ["softmax_xent", "causal_lm_loss",
                                  "sigmoid_bce", "chunked_vocab_xent/3"])
def test_losses_and_grads_match_reference(name, weighted):
    """Loss and gradients within 1e-6 of the reference's.  The chunked
    form runs chunks of 3 over 7 positions, the last one short; without
    weights the reference's padding zeroes every weight there (ROADMAP
    §3) and its loss is 0, so the port is held to the reference's loss in
    one chunk of 7."""
    floats, mine, ref = _loss_args(name, weighted)
    if name == "chunked_vocab_xent/3" and not weighted:
        assert float(ref(*floats)) == 0.0          # the reference's fault
        _, _, ref = _loss_args("chunked_vocab_xent/7", weighted)
    want, want_g = jax.jit(jax.value_and_grad(ref, argnums=tuple(
        range(len(floats)))))(*map(jnp.asarray, floats))
    ts = [torch.tensor(a, requires_grad=True) for a in floats]
    got = mine(*ts)
    got_g = torch.autograd.grad(got, ts)
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-6)
    for g, wg in zip(got_g, want_g):
        np.testing.assert_allclose(_np(g), np.asarray(wg), atol=1e-6)


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

def _ref_shapes(name, electra=False):
    """The reference init's tree for a case, shapes only
    (``jax.eval_shape``: nothing is drawn or compiled)."""
    if name == "mux-bert":
        cfg_r = ref_bert("small", **BERT)
        return jax.eval_shape(lambda k: RefBERT.init(
            k, cfg_r, RefMux(n=2), electra=electra), KEY)
    cfg_r = ref_config(name, reduced=True)
    return jax.eval_shape(lambda k: RefLM.init(k, cfg_r, RefMux(n=2)), KEY)


@functools.lru_cache(maxsize=None)
def _model(name, electra=False):
    """(reference-layout params as numpy, port cfg) of a case: the port's
    seeded init carried to the reference's layout (``interop``), whose
    tree and shapes must be those of the reference's init.  Both packages
    then start from these weights; the reference's own eager init costs
    seconds a model on this CPU."""
    g = torch.Generator().manual_seed(0)
    if name == "mux-bert":
        cfg, params = CFG, MuxBERT.init(g, CFG, MUX, electra=electra)
    else:
        cfg = get_config(name, reduced=True)
        params = TransformerLM.init(g, cfg, MUX)
    ref = interop.params_to_reference(params, cfg)
    want = _ref_shapes(name, electra=electra)
    assert jax.tree.structure(ref) == jax.tree.structure(want)
    assert [a.shape for a in jax.tree.leaves(ref)] == \
        [a.shape for a in jax.tree.leaves(want)]
    return ref, cfg


@pytest.mark.parametrize("name, sched", [
    ("rwkv6-7b", "cosine"), ("qwen2-1.5b", "linear"), ("mux-bert", "cosine")])
def test_adamw_matches_reference_on_every_leaf(name, sched):
    """Three steps of random gradients (clipped: norm ~30 > 1) from zero
    state, then the reference's state carried across into a fresh port
    optimizer for a fourth: params, m, v, count, grad_norm and lr equal
    within OPT_TOL on every leaf (``test_schedules`` holds both schedules
    to the reference's at every step)."""
    ref_p, cfg = _model(name)
    ref_s, port_s = ((ref_cos, linear_warmup_cosine_decay) if sched ==
                     "cosine" else (ref_lin, linear_warmup_linear_decay))
    ref_opt = RefAdamW(lr=ref_s(1e-2, 2, 6), weight_decay=0.1)
    ref_update = jax.jit(ref_opt.update)
    ref_apply = jax.jit(ref_opt.apply_updates)
    opt = AdamW(lr=port_s(1e-2, 2, 6), weight_decay=0.1)
    rp = jax.tree.map(jnp.asarray, ref_p)
    rs = ref_opt.init(rp)
    pp = interop.params_from_reference(ref_p, cfg, device="cpu")
    ps = opt.init(pp)
    rng = np.random.default_rng(1)
    for i in range(4):
        g = jax.tree.map(lambda a: rng.normal(size=a.shape).astype(
            np.float32) * 0.05, ref_p)
        upd, rs, rm = ref_update(jax.tree.map(jnp.asarray, g), rs, rp)
        rp = ref_apply(rp, upd)
        if i == 3:     # a fresh optimizer from the reference's state
            ps = interop.opt_state_from_reference(
                jax.tree.map(np.asarray, prev), cfg, device="cpu")
            assert ps["count"] == 3
        ps, pm = opt.update(interop.params_from_reference(g, cfg,
                                                          device="cpu"),
                            ps, pp)
        prev = rs
        np.testing.assert_allclose(float(pm["grad_norm"]),
                                   float(rm["grad_norm"]), rtol=1e-6)
        assert float(pm["grad_norm"]) > 1.0           # clipping is active
        np.testing.assert_allclose(pm["lr"], float(rm["lr"]), rtol=1e-7)
    got = {"params": interop.params_to_reference(pp, cfg),
           **interop.opt_state_to_reference(ps, cfg)}
    want = {"params": rp, **rs}
    assert int(got["count"]) == int(want["count"]) == 4
    gl, wl = dict(_leaves(got)), dict(_leaves(want))
    assert gl.keys() == wl.keys()
    for path in wl:
        np.testing.assert_allclose(gl[path], np.asarray(wl[path]),
                                   **OPT_TOL, err_msg=path)
    frozen = [p for p in wl if p.endswith("mux_engine/mux/v")]
    assert len(frozen) == 3                            # params, m, v
    for p in frozen:
        base = ref_p["backbone"] if name == "mux-bert" else ref_p
        want_v = (base["mux_engine"]["mux"]["v"] if p.startswith("/params")
                  else 0.0)
        np.testing.assert_array_equal(gl[p], want_v)


@pytest.mark.parametrize("name", ["rwkv6-7b", "mux-bert", "qwen2-1.5b"])
def test_masks_read_the_reference_path_and_rank(name):
    """Every leaf's reference path and rank (``reference_leaves``) are the
    reference tree's, for the stacked single-pattern models and MuxBERT:
    rwkv6-7b's per-layer vectors, 1-D in the port's layers, are 2-D in
    the reference's stacked periods, where its decay mask decays them."""
    ref = _ref_shapes(name)
    ref_p, cfg = _model(name)
    pp = interop.params_from_reference(ref_p, cfg, device="cpu")
    got = {(path_str(p), nd) for p, nd, _ in reference_leaves(pp)}
    want = {(ref_path_str(p), leaf.ndim) for p, leaf in
            jax.tree_util.tree_flatten_with_path(ref)[0]}
    assert got == want
    opt, ref_opt = AdamW(lr=1.0), RefAdamW(lr=1.0)
    for p, leaf in jax.tree_util.tree_flatten_with_path(ref)[0]:
        s = ref_path_str(p)
        assert opt.decay_mask(s.split("/"), leaf.ndim) == \
            ref_opt.decay_mask(p, leaf)
        assert opt.trainable_mask(s.split("/"), leaf.ndim) == \
            ref_opt.trainable_mask(p, leaf)
    if name == "rwkv6-7b":
        by_path = {path_str(p): (nd, t.ndim) for p, nd, t in
                   reference_leaves(pp)}
        for leaf in ("periods/0/dec_w0", "periods/0/mu_cm"):
            assert by_path[leaf] == (2, 1)
            assert opt.decay_mask(leaf.split("/"), 2)
    assert MuxEngine.frozen_paths(MuxSpec(n=2)) == (
        ("mux_engine", "mux", "v"),)
    assert MuxEngine.frozen_paths(MuxSpec(n=2, learn_keys_v=True)) == ()
    assert MuxEngine.frozen_paths(MuxSpec(n=1)) == ()


def test_adamw_converges_quadratic():
    w_true = torch.as_tensor(np.random.default_rng(0).normal(size=(8,)),
                             dtype=torch.float32)
    params = {"w": torch.zeros(8)}
    opt = AdamW(lr=0.1, weight_decay=0.0)
    state = opt.init(params)
    for _ in range(200):
        _, g = _grads_of(lambda p: ((p["w"] - w_true) ** 2).sum(), params)
        opt.update(g, state, params)
    np.testing.assert_allclose(_np(params["w"]), _np(w_true), atol=1e-2)


def test_frozen_gaussian_keys_do_not_move():
    params = {"mux_engine": {"mux": {"v": torch.ones(4, 8)}},
              "other": torch.ones(8, 8)}
    opt = AdamW(lr=0.1)
    state = opt.init(params)
    opt.update({"mux_engine": {"mux": {"v": torch.ones(4, 8)}},
                "other": torch.ones(8, 8)}, state, params)
    assert torch.equal(params["mux_engine"]["mux"]["v"], torch.ones(4, 8))
    assert torch.equal(state["m"]["mux_engine"]["mux"]["v"],
                       torch.zeros(4, 8))
    assert float((params["other"] - 1).abs().max()) > 0


def test_no_weight_decay_on_norms_and_biases():
    params = {"ln": {"scale": torch.ones(8)}, "w": torch.ones(8, 8)}
    opt = AdamW(lr=1.0, weight_decay=0.5, clip_norm=None, b1=0.0, b2=0.0,
                eps=1.0)
    state = opt.init(params)
    opt.update({}, state, params)          # zero grads: only decay moves
    assert torch.equal(params["ln"]["scale"], torch.ones(8))
    assert float((params["w"] - 1).abs().max()) > 0.0


def test_clip_norm():
    params = {"w": torch.zeros(4)}
    opt = AdamW(lr=1.0, clip_norm=1e-3)
    _, m = opt.update({"w": torch.full((4,), 100.0)}, opt.init(params),
                      params)
    assert float(m["grad_norm"]) == 200.0          # reported pre-clip
    assert float(global_norm({"a": torch.full((4,), 100.0)})) == 200.0


def test_schedules():
    lin = linear_warmup_linear_decay(1.0, 10, 100)
    assert lin(5) == 0.5
    assert abs(lin(10) - 1.0) < 1e-6
    assert lin(100) == 0.0
    cos = linear_warmup_cosine_decay(1.0, 10, 100)
    assert abs(cos(55) - 0.5) < 1e-2
    assert cos(100) < 1e-6
    for step in (0, 1, 7, 10, 11, 63, 99, 100, 130):
        for mine, ref in ((lin, ref_lin(1.0, 10, 100)),
                          (cos, ref_cos(1.0, 10, 100)),
                          (linear_warmup_cosine_decay(3e-4, 5, 40, 1e-5),
                           ref_cos(3e-4, 5, 40, 1e-5))):
            assert mine(step) == pytest.approx(
                float(ref(jnp.asarray(step, jnp.int32))), rel=1e-6,
                abs=1e-12)


# ---------------------------------------------------------------------------
# remat
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["mux-bert", "rwkv6-7b"])
def test_remat_gives_equal_gradients(name):
    """MuxBERT's checkpointed periods, and RWKV6's nested checkpoint of
    each chunk step (3 chunks of 32: the training forward's chunk rule):
    loss and gradients equal within REPEAT_TOL (of the largest |grad|)."""
    ref_p, cfg = _model(name)
    toks = torch.as_tensor(np.random.default_rng(0).integers(
        4, 256, (4, 96 if name == "rwkv6-7b" else 32)))
    out = []
    for remat in (True, False):
        c = cfg.replace(remat=remat)
        p = interop.params_from_reference(ref_p, c, device="cpu")
        if name == "mux-bert":
            def loss(p):
                return MuxBERT.mlm_logits(p, c, toks, mux=MUX,
                                          use_kernels=False).square().mean()
        else:
            def loss(p):
                return losses.causal_lm_loss(TransformerLM.apply(
                    p, c, toks, mux=MUX, dtype=torch.float32,
                    use_kernels=False)["logits"], toks)
        out.append(_grads_of(loss, p))
    (l1, g1), (l2, g2) = out
    np.testing.assert_allclose(float(l1), float(l2), rtol=1e-6)
    pairs = reference_leaves(g1, g2)
    big = max(float(a.abs().max()) for _, _, a, _ in pairs)
    for (path, _, a, b) in pairs:
        assert float((a - b).abs().max()) <= REPEAT_TOL * big, path


@pytest.mark.parametrize("name", ["whisper-encoder", "rwkv6-7b"])
def test_serving_forward_makes_no_checkpoint_call(name, monkeypatch):
    """Remat is a training setting: a forward whose params require no grad
    (serving: whisper-small's encoder with its full config's remat=True,
    RWKV6's no-cache plain forward with its nested chunk remat) runs no
    ``torch.utils.checkpoint``; the same forward on params that require
    grad does."""
    from repro_torch.kernels import rwkv6 as krwkv
    from repro_torch.models import EncDecLM
    from repro_torch.models import transformer as tmod
    calls, real = [], tmod.checkpoint

    def counting(fn, *a, **kw):
        calls.append(fn)
        return real(fn, *a, **kw)
    monkeypatch.setattr(tmod, "checkpoint", counting)
    monkeypatch.setattr(krwkv, "checkpoint", counting)
    g = torch.Generator().manual_seed(0)
    if name == "whisper-encoder":
        cfg = get_config("whisper-small", reduced=True)
        cfg = cfg.replace(encoder=cfg.encoder.replace(remat=True))
        params = EncDecLM.init(g, cfg, MUX)
        frames = torch.randn(2 * MUX.n, cfg.encoder.max_seq_len,
                             cfg.encoder.d_model, generator=g)

        def forward(p):
            return EncDecLM.encode(p, cfg, frames, mux=MUX,
                                   dtype=torch.float32, use_kernels=False)
    else:
        cfg = get_config(name, reduced=True)
        params = TransformerLM.init(g, cfg, MUX)
        toks = torch.as_tensor(np.random.default_rng(0).integers(
            4, 256, (2 * MUX.n, 2 * cfg.rwkv_chunk)))

        def forward(p):
            return TransformerLM.apply(p, cfg, toks, mux=MUX,
                                       dtype=torch.float32,
                                       use_kernels=False)["logits"]
    assert torch.is_grad_enabled()
    assert torch.isfinite(forward(params)).all()
    assert calls == []
    for t in (x[2] for x in reference_leaves(params)):
        t.requires_grad_(True)
    forward(params).square().mean().backward()
    assert calls


# ---------------------------------------------------------------------------
# the three stages learn (tests/test_system.py on the port)
# ---------------------------------------------------------------------------

def _loader(batch=16, seq=32, seed=0):
    corpus = MarkovCorpus(vocab_size=CFG.vocab_size, seed=seed)
    return ShardedLoader(
        lambda rng, b, l: {"tokens": corpus.sample(rng, b, l)},
        batch, seq, seed=seed)


def _run(params, loss_fn, loader, steps, lr=3e-3):
    opt = AdamW(lr=linear_warmup_linear_decay(lr, 10, steps))
    state = opt.init(params)
    step = make_train_step(loss_fn, opt)
    m = {}
    for i, batch in zip(range(steps), loader):
        batch = {k: torch.as_tensor(v) for k, v in batch.items()}
        params, state, m = step(params, state, batch,
                                torch.Generator().manual_seed(i))
    return params, {k: float(v) for k, v in m.items()}


def test_three_stage_training_learns():
    """tests/test_system.py's recipe and bars, but for stage 3: its 80
    fine-tuning steps at lr 3e-3 leave the last batch's accuracy (16
    instances) on either side of the 0.45 bar with ~1e-5 of difference in
    the pre-trained weights (ROADMAP §3: the reference's own run does so
    too, its weights perturbed at that level), so the port fine-tunes 150
    steps at lr 1e-3 (measured: last-batch accuracy 0.625, held-out
    accuracy 0.58-0.63, over four seeds and one / two threads)."""
    g = torch.Generator().manual_seed(0)
    params = MuxBERT.init(g, CFG, MUX)
    params, m = _run(params, retrieval_stage(CFG, MUX), _loader(), 60)
    assert m["retrieval_acc"] > 0.5, m
    params, m0 = _run(params, mlm_stage(CFG, MUX), _loader(seed=1), 1)
    params, m = _run(params, mlm_stage(CFG, MUX), _loader(seed=2), 60)
    assert m["mlm_loss"] < m0["mlm_loss"], (m0, m)
    task = classification_task(CFG.vocab_size, 3, seed=0)
    ft = {"model": params, "head": MuxBERT.init_classifier(g, CFG, 3)}
    ld = ShardedLoader(lambda rng, b, l: dict(zip(("tokens", "labels"),
                                                  task(rng, b, l))),
                       16, 32, seed=5)
    ft, m = _run(ft, classification_stage(CFG, MUX), ld, 150, lr=1e-3)
    assert m["accuracy"] > 0.45, m        # chance = 1/3


# ---------------------------------------------------------------------------
# Supervisor (tests/test_runtime.py's cases on the port)
# ---------------------------------------------------------------------------

def test_supervisor_restores_after_failure(tmp_path):
    def step_fn(state, batch, step):
        return {"w": state["w"] + 1.0}, {"loss": float(step)}

    armed = {"on": True}

    def fault_hook(step):
        if step == 7 and armed["on"]:
            armed["on"] = False
            raise DeviceFailure("slice 3 lost")

    sup = Supervisor(step_fn=step_fn,
                     ckpt=AsyncCheckpointManager(str(tmp_path), keep_k=2),
                     checkpoint_every=5, max_restarts=2,
                     fault_hook=fault_hook)
    with pytest.warns(UserWarning, match="no .seek"):
        state, hist = sup.run({"w": torch.zeros(())},
                              iter(lambda: {"x": 0}, None), 12)
    restarts = [h for h in hist if h.get("event") == "restart"]
    assert len(restarts) == 1 and restarts[0]["at_step"] == 5
    assert float(state["w"]) == 12.0
    assert [h["step"] for h in hist if "step" in h] == list(range(12))


def test_supervisor_budget_exhausted(tmp_path):
    def step_fn(state, batch, step):
        raise DeviceFailure("always down")

    sup = Supervisor(step_fn=step_fn,
                     ckpt=AsyncCheckpointManager(str(tmp_path)),
                     max_restarts=2, backoff_s=0.001)
    with pytest.raises(RuntimeError, match="restart budget"):
        sup.run({"w": torch.zeros(())}, iter(lambda: {}, None), 5)


def test_supervisor_does_not_catch_a_bug(tmp_path):
    def step_fn(state, batch, step):
        raise RuntimeError("a bug, not a device")

    sup = Supervisor(step_fn=step_fn,
                     ckpt=AsyncCheckpointManager(str(tmp_path)))
    with pytest.raises(RuntimeError, match="a bug"):
        sup.run({"w": torch.zeros(())}, iter(lambda: {}, None), 5)


def test_supervisor_replay_matches_fault_free_run(tmp_path):
    """A fault at step 6 of 10 (checkpoints every 4), the batches from a
    ReplayableIterator: the restored run replays steps 4-5 on their own
    batches and ends in the fault-free run's params (within 1e-7: an
    AdamW step moves a weight ~1e-3), moments and losses (a wrong batch
    moves the losses by ~1e-2), with the optimizer's int count
    restored."""
    cfg = get_config("qwen2-1.5b", reduced=True)
    corpus = MarkovCorpus(vocab_size=cfg.vocab_size, seed=0)

    def batch_fn(i):
        return {"tokens": torch.as_tensor(corpus.sample(
            np.random.default_rng((0, i)), 4, 16))}

    def loss_fn(p, batch, generator):
        logits = TransformerLM.apply(p, cfg, batch["tokens"], mux=MUX,
                                     dtype=torch.float32,
                                     use_kernels=False)["logits"]
        return losses.causal_lm_loss(logits, batch["tokens"]), {}

    def run(fault_at, d):
        opt = AdamW(lr=1e-3)
        params = TransformerLM.init(torch.Generator().manual_seed(0), cfg,
                                    MUX)
        step = make_train_step(loss_fn, opt)

        def step_fn(state, batch, i):
            p, o, m = step(*state, batch, torch.Generator().manual_seed(i))
            return (p, o), m

        armed = {"on": True}

        def hook(i):
            if i == fault_at and armed["on"]:
                armed["on"] = False
                raise DeviceFailure("lost")
        sup = Supervisor(step_fn=step_fn,
                         ckpt=AsyncCheckpointManager(str(tmp_path / d)),
                         checkpoint_every=4, fault_hook=hook)
        (p, o), hist = sup.run((params, opt.init(params)),
                               ReplayableIterator(batch_fn), 10)
        return p, o, hist

    p1, o1, h1 = run(None, "a")
    p2, o2, h2 = run(6, "b")
    assert [h["at_step"] for h in h2 if h.get("event")] == [4]
    assert [h["step"] for h in h2 if "step" in h] == list(range(10))
    assert o1["count"] == o2["count"] == 10 and isinstance(o2["count"], int)
    for (path, _, a, b) in reference_leaves(p1, p2):
        np.testing.assert_allclose(_np(b), _np(a), rtol=0, atol=1e-7,
                                   err_msg=str(path))
    for (path, _, a, b) in reference_leaves(
            {"m": o1["m"], "v": o1["v"]}, {"m": o2["m"], "v": o2["v"]}):
        np.testing.assert_allclose(_np(b), _np(a), rtol=1e-4, atol=1e-12,
                                   err_msg=str(path))
    np.testing.assert_allclose([float(h["loss"]) for h in h2 if "loss" in h],
                               [float(h["loss"]) for h in h1],
                               rtol=REPEAT_TOL)


# ---------------------------------------------------------------------------
# the kernels refuse autograd
# ---------------------------------------------------------------------------

def _wrapper_calls():
    """Each wrapper with small CPU inputs (its first tensor argument the
    one that will require grad)."""
    g = torch.Generator().manual_seed(0)

    def r(*s):
        return torch.randn(s, generator=g)
    pages = r(4, 4, 2, 8)
    bt = torch.tensor([[0, 1], [2, 3]], dtype=torch.int32)
    ppos = torch.arange(16, dtype=torch.int32).reshape(4, 4)
    return {
        "mux_embed_combine": (lambda x: ops.mux_embed_combine(
            torch.zeros(2, 3, dtype=torch.long), x, r(2, 8)), r(10, 8)),
        "mux_combine": (lambda x: ops.mux_combine(x, r(2, 8)), r(2, 3, 8)),
        "paged_attention": (lambda x: ops.paged_attention(
            x, pages, pages, bt, ppos, torch.tensor([5, 6])), r(2, 1, 4, 8)),
        "paged_prefill_attention": (lambda x: ops.paged_prefill_attention(
            x, pages, pages, bt, ppos, torch.tensor([0, 0]),
            torch.tensor([2, 2])), r(2, 2, 4, 8)),
        "demux_rsa": (lambda x: ops.demux_rsa(
            x, r(2, 8), r(8, 16), r(8, 16), r(16), r(16, 8), r(8)),
            r(3, 8)),
        "decode_attention": (lambda x: ops.decode_attention(
            x, r(2, 4, 2, 8), r(2, 4, 2, 8), torch.arange(4), q_pos=3),
            r(2, 1, 4, 8)),
        "flash_attention": (lambda x: ops.flash_attention(
            x, r(1, 5, 2, 8), r(1, 5, 2, 8)), r(1, 5, 4, 8)),
        "rwkv6_chunked": (lambda x: ops.rwkv6_chunked(
            x, r(1, 4, 2, 8), r(1, 4, 2, 8), -r(1, 4, 2, 8).exp(), r(2, 8),
            torch.zeros(1, 2, 8, 8), chunk=4), r(1, 4, 2, 8)),
    }


@pytest.mark.parametrize("name", [w.__name__ for w in ops.WRAPPERS])
def test_kernel_wrappers_refuse_autograd(name):
    fn, x = _wrapper_calls()[name]
    wrapper = getattr(ops, name)
    calls = wrapper.calls
    fn(x)                                       # no grad anywhere: runs
    x.requires_grad_(True)
    with pytest.raises(RuntimeError, match="use_kernels=False"):
        fn(x)
    assert wrapper.calls == calls + 1           # a refused call is uncounted
    with torch.no_grad():
        fn(x)


def test_mux_bert_trains_on_the_plain_path_only():
    p = MuxBERT.init(torch.Generator().manual_seed(0), CFG, MUX)
    toks = torch.randint(4, 256, (4, 16))
    for t in (x[2] for x in reference_leaves(p)):
        t.requires_grad_(True)
    with pytest.raises(RuntimeError, match="no backward"):
        MuxBERT.mlm_logits(p, CFG, toks, mux=MUX, use_kernels=True)
    MuxBERT.mlm_logits(p, CFG, toks, mux=MUX, use_kernels=False).sum() \
        .backward()
    with torch.no_grad():
        MuxBERT.mlm_logits(p, CFG, toks, mux=MUX, use_kernels=True)


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

def _cli(capsys, *argv):
    assert cli.main(list(argv)) == 0
    return capsys.readouterr().out


def test_cli_mux_bert_stages(capsys, tmp_path):
    out = _cli(capsys, "--model", "mux-bert-small", "--vocab", "256",
               "--seq", "32", "--batch", "8", "--steps", "3",
               "--warmup-steps", "3", "--device", "cpu",
               "--ckpt", str(tmp_path))
    assert "--- stage: retrieval-warmup (3 steps) ---" in out
    assert "--- stage: mlm-pretrain (3 steps) ---" in out
    assert len(re.findall(r"    steps=3  loss \d+\.\d{4} -> \d+\.\d{4}  "
                          r"\(\d+s, \d+ ms/step, stragglers=\d+\)", out)) == 2
    assert out.splitlines()[0].startswith(
        "model: mux-bert-small  params=12.7M  mux N=2")
    assert out.rstrip().endswith("done.")
    assert not list(tmp_path.iterdir())      # 3 steps: no checkpoint yet


def test_cli_causal_lm_and_refusals(capsys, tmp_path):
    got = {}
    out = _cli(capsys, "--arch", "qwen2-1.5b", "--reduced", "--steps", "3",
               "--batch", "4", "--seq", "16", "--device", "cpu",
               "--ckpt", str(tmp_path))
    assert "--- stage: lm (3 steps) ---" in out and "steps=3  loss" in out
    assert cli.main(["--arch", "rwkv6-7b", "--reduced", "--steps", "1",
                     "--batch", "2", "--seq", "32", "--device", "cpu",
                     "--ckpt", str(tmp_path)], out=got) == 0
    assert got["stages"][0]["steps"] == 1 and got["cfg"].name == "rwkv6-7b"
    for argv, msg in ((["--arch", "whisper-small"], "encoder-decoder"),
                      (["--arch", "qwen2-moe-a2.7b"], "pass --reduced"),
                      (["--arch", "qwen2-1.5b"], "pass --reduced"),
                      (["--model", "mux-bert-huge"], "one of")):
        with pytest.raises(SystemExit):
            cli.main(argv + ["--device", "cpu"])
        assert msg in capsys.readouterr().err
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli.main(["--model", "mux-bert-small", "--steps", "1"])


# ---------------------------------------------------------------------------
# the stages against the reference's value_and_grad and jitted step
# ---------------------------------------------------------------------------

# the MLM stage runs with its auxiliary retrieval objective, which takes
# every line of the plain MLM stage and its own
STAGES = ("retrieval", "mlm+retrieval", "electra", "classification",
          "token_classification", "lm/qwen2-1.5b", "lm/rwkv6-7b")


@functools.lru_cache(maxsize=None)
def _case(stage):
    """(reference-layout params as numpy, batch as numpy, port cfg,
    reference loss_fn, port loss_fn) of one stage."""
    rng = np.random.default_rng(0)
    if stage.startswith("lm/"):
        arch = stage[3:]
        cfg_r = ref_config(arch, reduced=True)
        ref, cfg = _model(arch)
        toks = RefCorpus(cfg.vocab_size, seed=0).sample(rng, 4, 32)

        def ref_fn(p, batch, key):
            out = RefLM.apply(p, cfg_r, batch["tokens"], mux=REF_MUX,
                              dtype=jnp.float32)
            return ref_causal(out["logits"], batch["tokens"]), {}

        def fn(p, batch, generator):
            logits = TransformerLM.apply(p, cfg, batch["tokens"], mux=MUX,
                                         dtype=torch.float32,
                                         use_kernels=False)["logits"]
            return losses.causal_lm_loss(logits, batch["tokens"]), {}
        return ref, {"tokens": toks}, cfg, ref_fn, fn
    ref, _ = _model("mux-bert", electra=stage == "electra")
    batch = {"tokens": RefCorpus(CFG.vocab_size, seed=0).sample(rng, 8, 32)}
    kw = {"retrieval_rate": 0.5} if stage == "mlm+retrieval" else {}
    name = stage.split("+")[0]
    if name in ("classification", "token_classification"):
        g = torch.Generator().manual_seed(1)
        if name == "classification":
            task = ref_cls_task(CFG.vocab_size, 3)
            head = MuxBERT.init_classifier(g, CFG, 3)
            keys = ("tokens", "labels")
        else:
            task = ref_tok_task(CFG.vocab_size, 5)
            head = MuxBERT.init_token_classifier(g, CFG, 5)
            keys = ("tokens", "tags")
        batch = dict(zip(keys, task(rng, 8, 32)))
        ref = {"model": ref, "head": jax.tree.map(_np, head)}
    ref_fn = getattr(ref_stages, f"{name}_stage")(CFG_R, REF_MUX, **kw)
    fn = getattr(mux_stages, f"{name}_stage")(CFG, MUX, **kw)
    return ref, batch, CFG, ref_fn, fn


@functools.lru_cache(maxsize=None)
def _ref_grad_fn(stage):
    """The reference's jitted value_and_grad of a stage's loss."""
    return jax.jit(jax.value_and_grad(_case(stage)[3], has_aux=True))


@functools.lru_cache(maxsize=None)
def _ref_value_and_grad(stage):
    ref, batch, _, _, _ = _case(stage)
    (loss, _), grads = _ref_grad_fn(stage)(
        ref, {k: jnp.asarray(v) for k, v in batch.items()}, KEY)
    return float(loss), jax.tree.map(np.asarray, grads)


def _patch_masks(monkeypatch, batch):
    """The port's stages get the reference's masks of ``batch`` under
    KEY."""
    toks = jnp.asarray(batch["tokens"])
    mlm = [torch.as_tensor(np.array(x)) for x in
           ref_mlm_mask(KEY, toks, vocab=CFG.vocab_size, rate=0.15)]
    rtd = [torch.as_tensor(np.array(x)) for x in
           ref_electra(KEY, toks, vocab=CFG.vocab_size, rate=0.15)]
    monkeypatch.setattr(mux_stages, "mlm_mask", lambda *a, **k: mlm)
    monkeypatch.setattr(mux_stages, "electra_corrupt", lambda *a, **k: rtd)


@pytest.mark.parametrize("stage", STAGES)
def test_stage_loss_and_grads_match_reference(stage, monkeypatch):
    ref, batch, cfg, _, fn = _case(stage)
    _patch_masks(monkeypatch, batch)
    want_loss, want = _ref_value_and_grad(stage)
    params = interop.params_from_reference(ref, cfg, device="cpu")
    loss, grads = _grads_of(
        lambda p: fn(p, {k: torch.as_tensor(v) for k, v in batch.items()},
                     None)[0], params)
    np.testing.assert_allclose(float(loss), want_loss, rtol=LOSS_RTOL)
    got = dict(_leaves(interop.params_to_reference(grads, cfg)))
    want = dict(_leaves(want))
    assert got.keys() == want.keys()
    big = max(float(np.abs(w).max()) for w in want.values())
    assert big > 0
    for path, w in want.items():
        err = float(np.abs(got[path] - w).max()) / big
        assert err <= GRAD_TOL, (path, err)


def _batches(stage, n):
    """n seeded batches of the stage's task (numpy)."""
    rng = np.random.default_rng(5)
    if stage == "classification":
        task = ref_cls_task(CFG.vocab_size, 3)
        return [dict(zip(("tokens", "labels"), task(rng, 8, 32)))
                for _ in range(n)]
    corpus = RefCorpus(CFG.vocab_size, seed=0)
    return [{"tokens": corpus.sample(rng, 8, 32)} for _ in range(n)]


@pytest.mark.parametrize("stage, micro", [("retrieval", 2),
                                          ("classification", 1)])
def test_trajectory_matches_reference(stage, micro):
    """Five AdamW steps (warm-up 2 of 5, clipping at 1) on the same
    batches from the same params and zero state, against the reference's
    (the retrieval stage in two microbatches through its jitted
    ``make_train_step``; classification in one, through the body of that
    step: the stage's jitted value_and_grad, ``AdamW.update`` and
    ``apply_updates``): the losses and grad norms step by step and the
    final params within TRAJ_TOL."""
    steps = 5
    ref, _, cfg, ref_fn, fn = _case(stage)
    ref_opt = RefAdamW(lr=ref_lin(3e-3, 2, 5))
    opt = AdamW(lr=linear_warmup_linear_decay(3e-3, 2, 5))
    if micro > 1:
        ref_step = ref_jit_step(ref_make_step(ref_fn, ref_opt,
                                              n_microbatches=micro),
                                donate=False)
    else:
        grad_fn, update = _ref_grad_fn(stage), jax.jit(ref_opt.update)

        def ref_step(p, s, batch, key):
            (loss, metrics), grads = grad_fn(p, batch, key)
            updates, s, om = update(grads, s, p)
            return (ref_opt.apply_updates(p, updates), s,
                    {**metrics, **om, "loss": loss})
    step = make_train_step(fn, opt, n_microbatches=micro)
    rp = jax.tree.map(jnp.asarray, ref)
    rs = ref_opt.init(rp)
    pp = interop.params_from_reference(ref, cfg, device="cpu")
    ps = opt.init(pp)
    for i, batch in enumerate(_batches(stage, steps)):
        rp, rs, rm = ref_step(rp, rs, {k: jnp.asarray(v)
                                       for k, v in batch.items()},
                              jax.random.fold_in(KEY, i))
        pp, ps, pm = step(pp, ps, {k: torch.as_tensor(v)
                                   for k, v in batch.items()},
                          torch.Generator().manual_seed(i))
        np.testing.assert_allclose(float(pm["loss"]), float(rm["loss"]),
                                   rtol=1e-5, err_msg=f"step {i}")
        np.testing.assert_allclose(float(pm["grad_norm"]),
                                   float(rm["grad_norm"]), rtol=1e-5)
    got = {"params": interop.params_to_reference(pp, cfg),
           **interop.opt_state_to_reference(ps, cfg)}
    want = {"params": rp, **rs}
    assert int(got["count"]) == int(want["count"]) == steps
    gl, wl = dict(_leaves(got)), dict(_leaves(want))
    close = total = 0
    for path, w in wl.items():
        if path.startswith(("/m/", "/v/")):
            continue               # moments: held through the params
        np.testing.assert_allclose(gl[path], np.asarray(w), **TRAJ_TOL,
                                   err_msg=path)
        close += int((np.abs(gl[path] - np.asarray(w)) <= 1e-6).sum())
        total += np.size(w)
    assert close >= TRAJ_SHARE * total, (close, total)
