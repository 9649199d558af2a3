"""The paper's own models in the port (``repro_torch.models.bert``,
``repro_torch.core``) against the JAX reference, on the CPU.

Weights come from the reference's init through ``repro_torch.interop``;
inputs from numpy seeds.  The config is the reduced MUX-BERT shape the
port's registry builds (2 layers, d 64, 4 heads, d_ff 128, vocab 512, 64
positions), passed to the reference's ``bert_config`` too.

Modules (tolerance 1e-5 absolute: fp32 on both sides, summation order
only): ``MuxSpec`` defaults and ``validate``'s errors; the Gaussian and
contextual muxes at N 2 and 5 (the contextual one with 8 and 4 heads);
the prefix demux (``prefix``, ``apply``) and both demuxes at a hidden
width other than 2d; ``MuxEngine.combine`` / ``separate`` over the four
(mux, demux) pairs, ``extra_positions`` and the not-divisible error; the
retrieval loss and accuracy with and without a mask; ``ensemble_logits``
given the reference's inverse permutation, and the port's own
permute-then-average round trip.

Model (tolerance 1e-4 absolute on hidden states and logits): ``MuxBERT``
``hidden``, ``mlm_logits``, ``rtd_logits``, ``classify`` and
``classify_tokens`` at N=1 and for each (mux, demux) pair at N 2 and 5,
the port's kernel path (the wrappers' plain versions on CPU tensors) and
plain path each against the reference's plain path (the reference's
classifier and RTD heads have no other); ``hidden`` and ``mlm_logits``
also against the reference's kernel path (Pallas in interpret mode) with
``attn_impl`` naive and flash; the wrappers each ``hidden`` calls, which
are the launches the card run asserts.

Interop and configs: a MuxBERT tree with contextual-mux and prefix-demux
params, the RTD head and two classifier heads crosses both ways leaf for
leaf; the port's init tree has the reference's keys and shapes;
``param_count`` and the registry's full configs equal the reference's;
the reference's reduced registry config is inconsistent (ROADMAP §3) and
the port's runs.
"""
import dataclasses
import functools
import re
from unittest import mock

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_config as ref_config
from repro.configs import model_kind as ref_model_kind
from repro.core import MuxSpec as RefSpec
from repro.core import demux as ref_demux
from repro.core import engine as ref_engine
from repro.core import mux as ref_mux
from repro.models.bert import MuxBERT as RefBERT
from repro.models.bert import bert_config as ref_bert_config
from repro.models.config import param_count as ref_param_count
from repro_torch import interop
from repro_torch.configs import PAPER_MODELS, get_config, model_kind
from repro_torch.core import (MuxEngine, MuxSpec, ensemble_logits,
                              make_ensemble_batch, retrieval_accuracy,
                              retrieval_loss)
from repro_torch.core import demux as port_demux
from repro_torch.core import mux as port_mux
from repro_torch.kernels import ops
from repro_torch.models import MuxBERT, ModelConfig, bert_config, param_count

torch.set_num_threads(2)

MOD_TOL = dict(atol=1e-5, rtol=0)
LOGIT_TOL = dict(atol=1e-4, rtol=0)
REDUCED = dict(n_layers=2, d_model=64, n_heads=4, d_ff=128, vocab_size=512,
               max_seq_len=64)
B, L = 2, 12                # backbone rows, tokens an instance
PAIRS = [("gaussian", "rsa"), ("contextual", "rsa"), ("gaussian", "prefix"),
         ("contextual", "prefix")]
# N=1 once (the kinds are unused), each pair at N 2 and 5
MODEL_CASES = [(1, "gaussian", "rsa")] + [(n, m, d) for m, d in PAIRS
                                          for n in (2, 5)]
HEADS = ["hidden", "mlm_logits", "rtd_logits", "classify", "classify_tokens"]


# the reference's functions under jax.jit, specs and configs static: one
# compile a shape, where eager ``lax.scan`` and attention compile op by op
_ref_apply_mux = jax.jit(ref_mux.apply_mux, static_argnums=1)
_ref_prefix_apply = jax.jit(ref_demux.PrefixDemux.apply, static_argnums=2)
_ref_apply_demux = jax.jit(ref_demux.apply_demux, static_argnums=1)
_ref_combine = jax.jit(ref_engine.MuxEngine.combine, static_argnums=1)
_ref_separate = jax.jit(ref_engine.MuxEngine.separate, static_argnums=1)


def _case_id(case):
    n, m, d = case
    return f"N{n}" if n == 1 else f"N{n}-{m}-{d}"


def _torch(tree):
    return jax.tree.map(lambda a: torch.as_tensor(np.array(a)), tree)


def _close(got, want, tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **tol)


def _specs(n, mux_kind="gaussian", demux_kind="rsa", **kw):
    return (RefSpec(n=n, mux_kind=mux_kind, demux_kind=demux_kind, **kw),
            MuxSpec(n=n, mux_kind=mux_kind, demux_kind=demux_kind, **kw))


# -- modules -----------------------------------------------------------------

def test_mux_spec_defaults_match_reference():
    assert dataclasses.asdict(MuxSpec()) == dataclasses.asdict(RefSpec())
    assert MuxSpec(n=2).enabled and not MuxSpec().enabled


@pytest.mark.parametrize("bad", [dict(n=0), dict(mux_kind="sparse"),
                                 dict(demux_kind="index")],
                         ids=["n", "mux_kind", "demux_kind"])
def test_mux_spec_validate_errors_match_reference(bad):
    with pytest.raises(ValueError) as want:
        RefSpec(**bad).validate()
    with pytest.raises(ValueError, match=re.escape(str(want.value))):
        MuxSpec(**bad).validate()


@pytest.mark.parametrize("kind,n,heads", [
    ("gaussian", 2, 8), ("gaussian", 5, 8), ("contextual", 2, 8),
    ("contextual", 2, 4), ("contextual", 5, 8), ("contextual", 5, 4)])
def test_mux_apply_matches_reference(kind, n, heads):
    """``apply_mux`` (GaussianMux / ContextualMux) on (N, B, L, D) inputs
    with the reference's weights; the Gaussian one also through the
    mux-combine wrapper."""
    rs, ps = _specs(n, kind, ctx_heads=heads)
    p = ref_mux.init_mux(jax.random.PRNGKey(n), rs, 64)
    x = np.random.default_rng(n).standard_normal((n, B, L, 64), np.float32)
    want = _ref_apply_mux(p, rs, jnp.asarray(x))
    pt = _torch(p)
    _close(port_mux.apply_mux(pt, ps, torch.as_tensor(x)), want, MOD_TOL)
    ops.reset_counts()
    _close(port_mux.apply_mux(pt, ps, torch.as_tensor(x), use_kernel=True),
           want, MOD_TOL)
    assert ops.mux_combine.calls == (kind == "gaussian")


@pytest.mark.parametrize("n", [2, 5])
def test_prefix_demux_matches_reference(n):
    """``PrefixDemux.prefix`` (B, N, D) and ``apply`` on a (B, N+L, D)
    backbone output."""
    p = ref_demux.PrefixDemux.init(jax.random.PRNGKey(n), n, 64, 128)
    pt = _torch(p)
    np.testing.assert_array_equal(
        port_demux.PrefixDemux.prefix(pt, B, torch.float32).numpy(),
        np.asarray(ref_demux.PrefixDemux.prefix(p, B, jnp.float32)))
    h = np.random.default_rng(n).standard_normal((B, n + L, 64), np.float32)
    _close(port_demux.PrefixDemux.apply(pt, torch.as_tensor(h), n),
           _ref_prefix_apply(p, jnp.asarray(h), n), MOD_TOL)


@pytest.mark.parametrize("demux_kind", ["rsa", "prefix"])
def test_demux_hidden_width_matches_reference(demux_kind):
    """``demux_hidden`` = 48, not 2d = 128: the port's init has the
    reference's shapes, and ``apply_demux`` its values."""
    rs, ps = _specs(2, demux_kind=demux_kind, demux_hidden=48)
    p = ref_demux.init_demux(jax.random.PRNGKey(3), rs, 64)
    mine = port_demux.init_demux(torch.Generator().manual_seed(0), ps, 64)
    assert jax.tree.structure(p) == jax.tree.structure(mine)
    assert [tuple(a.shape) for a in jax.tree.leaves(p)] == \
        [tuple(a.shape) for a in jax.tree.leaves(mine)]
    assert p["w1h"]["w"].shape == (64, 48)
    lp = 2 + L if demux_kind == "prefix" else L
    h = np.random.default_rng(4).standard_normal((B, lp, 64), np.float32)
    _close(port_demux.apply_demux(_torch(p), ps, torch.as_tensor(h)),
           _ref_apply_demux(p, rs, jnp.asarray(h)), MOD_TOL)


@pytest.mark.parametrize("mux_kind,demux_kind", PAIRS)
def test_engine_combine_separate_match_reference(mux_kind, demux_kind):
    """``combine`` (plain and through the kernel wrappers' plain versions),
    ``separate`` and ``extra_positions`` for each kind pair at N=3."""
    rs, ps = _specs(3, mux_kind, demux_kind, ctx_heads=4)
    p = ref_engine.MuxEngine.init(jax.random.PRNGKey(5), rs, 64)
    pt = _torch(p)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((3 * B, L, 64), np.float32)
    want = _ref_combine(p, rs, jnp.asarray(x))
    for uk in (False, True):
        _close(MuxEngine.combine(pt, ps, torch.as_tensor(x), use_kernels=uk),
               want, MOD_TOL)
    extra = MuxEngine.extra_positions(ps)
    assert extra == ref_engine.MuxEngine.extra_positions(rs)
    assert want.shape == (B, L + extra, 64)
    h = rng.standard_normal((B, L + extra, 64), np.float32)
    _close(MuxEngine.separate(pt, ps, torch.as_tensor(h)),
           _ref_separate(p, rs, jnp.asarray(h)), MOD_TOL)
    for n in (1, 3):
        r1, p1 = _specs(n, mux_kind, demux_kind)
        assert MuxEngine.extra_positions(p1) == \
            ref_engine.MuxEngine.extra_positions(r1)


def test_engine_combine_refuses_a_batch_not_divisible_by_n():
    rs, ps = _specs(3)
    p = ref_engine.MuxEngine.init(jax.random.PRNGKey(0), rs, 8)
    x = np.zeros((4, 2, 8), np.float32)
    with pytest.raises(ValueError) as want:
        ref_engine.MuxEngine.combine(p, rs, jnp.asarray(x))
    with pytest.raises(ValueError, match=re.escape(str(want.value))):
        MuxEngine.combine(_torch(p), ps, torch.as_tensor(x))


@pytest.mark.parametrize("masked", [False, True])
def test_retrieval_metrics_match_reference(masked):
    rng = np.random.default_rng(6)
    logits = rng.standard_normal((6, L, 40), np.float32) * 3
    ids = rng.integers(0, 40, (6, L)).astype(np.int32)
    ids[:, ::3] = logits.argmax(-1)[:, ::3]           # some hits
    mask = (rng.random((6, L)) < 0.6).astype(np.float32) if masked else None
    kw = {} if mask is None else {"valid_mask": jnp.asarray(mask)}
    tkw = {} if mask is None else {"valid_mask": torch.as_tensor(mask)}
    for port_fn, ref_fn in ((retrieval_loss, ref_engine.retrieval_loss),
                            (retrieval_accuracy,
                             ref_engine.retrieval_accuracy)):
        _close(port_fn(torch.as_tensor(logits), torch.as_tensor(ids), **tkw),
               ref_fn(jnp.asarray(logits), jnp.asarray(ids), **kw), MOD_TOL)


def test_ensemble_logits_with_reference_permutation():
    """The reference permutes a batch N times over; the port's
    ``ensemble_logits`` undoes the reference's inverse permutation and
    averages as the reference's does."""
    n = 3
    x = np.random.default_rng(7).standard_normal((4, 5), np.float32)
    batch, inv = ref_engine.make_ensemble_batch(jax.random.PRNGKey(7),
                                                jnp.asarray(x), n)
    noise = np.random.default_rng(8).standard_normal((n * 4, 5), np.float32)
    logits = np.asarray(batch) + noise        # a per-instance prediction
    _close(ensemble_logits(torch.as_tensor(logits),
                           torch.as_tensor(np.array(inv)), n),
           ref_engine.ensemble_logits(jnp.asarray(logits), inv, n), MOD_TOL)


def test_ensemble_round_trip():
    """The port's permutation (from a ``torch.Generator``) is undone by its
    inverse: every instance's N copies come back, and averaging a rowwise
    function of the batch gives that function of each instance."""
    n = 4
    x = torch.as_tensor(np.random.default_rng(9).standard_normal((3, 2, 5),
                                                                  np.float32))
    rep, inv = make_ensemble_batch(torch.Generator().manual_seed(9), x, n)
    assert rep.shape == (n * 3, 2, 5)
    assert not torch.equal(rep, x.repeat(n, 1, 1))       # really permuted
    assert torch.equal(rep[inv].reshape(n, 3, 2, 5),
                       x[None].expand(n, -1, -1, -1))
    _close(ensemble_logits(2 * rep + 1, inv, n), (2 * x + 1).numpy(),
           MOD_TOL)


# -- the model ---------------------------------------------------------------

@functools.cache
def _model(n, mux_kind, demux_kind):
    """Reference MuxBERT weights (ELECTRA head, a 3-class classifier and a
    5-tag token head), the port's copy through interop, and tokens."""
    rs, ps = _specs(n, mux_kind, demux_kind)
    cfg_r = ref_bert_config("base", **REDUCED)
    ref = RefBERT.init(jax.random.PRNGKey(n), cfg_r, rs, electra=True)
    ref["cls"] = RefBERT.init_classifier(jax.random.PRNGKey(11), cfg_r, 3)
    ref["tok"] = RefBERT.init_token_classifier(jax.random.PRNGKey(12), cfg_r,
                                               5)
    port = interop.params_from_reference(jax.tree.map(np.asarray, ref),
                                         bert_config("base", **REDUCED),
                                         device="cpu")
    tokens = np.random.default_rng(n).integers(
        0, REDUCED["vocab_size"], (n * B, L)).astype(np.int32)
    return rs, ps, ref, port, tokens


@functools.cache
def _ref_head(case, head, use_kernels=False, impl="naive"):
    """The reference's ``head``.  Its backbone runs once a case and path:
    the other heads are the reference's own head code over that
    ``hidden`` (``MuxBERT.hidden`` stood in by its cached result, the
    value each head would compute again)."""
    rs, _, ref, _, tokens = _model(*case)
    cfg = ref_bert_config("base", attn_impl=impl, **REDUCED)
    toks = jnp.asarray(tokens)
    if head == "hidden":
        return np.asarray(RefBERT.hidden(ref, cfg, toks, mux=rs,
                                         use_kernels=use_kernels))
    h = jnp.asarray(_ref_head(case, "hidden", use_kernels, impl))
    with mock.patch.object(RefBERT, "hidden", lambda *a, **kw: h):
        if head == "mlm_logits":
            out = RefBERT.mlm_logits(ref, cfg, toks, mux=rs,
                                     use_kernels=use_kernels)
        elif head == "rtd_logits":
            out = RefBERT.rtd_logits(ref, cfg, toks, mux=rs)
        else:
            hp = ref["cls" if head == "classify" else "tok"]
            out = getattr(RefBERT, head)(ref, hp, cfg, toks, mux=rs)
    return np.asarray(out)


def _port_head(case, head, use_kernels, impl="auto"):
    _, ps, _, port, tokens = _model(*case)
    cfg = bert_config("base", attn_impl=impl, **REDUCED)
    toks = torch.as_tensor(tokens)
    if head in ("classify", "classify_tokens"):
        hp = port["cls" if head == "classify" else "tok"]
        return getattr(MuxBERT, head)(port, hp, cfg, toks, mux=ps,
                                      use_kernels=use_kernels)
    return getattr(MuxBERT, head)(port, cfg, toks, mux=ps,
                                  use_kernels=use_kernels)


@pytest.mark.parametrize("use_kernels", [True, False])
@pytest.mark.parametrize("head", HEADS)
@pytest.mark.parametrize("case", MODEL_CASES, ids=_case_id)
def test_heads_match_reference_plain_path(case, head, use_kernels):
    got = _port_head(case, head, use_kernels)
    want = _ref_head(case, head)
    n = case[0]
    lead = {"classify": (n * B, 3), "classify_tokens": (n * B, L, 5),
            "rtd_logits": (n * B, L), "hidden": (n * B, L, 64),
            "mlm_logits": (n * B, L, REDUCED["vocab_size"])}[head]
    assert tuple(got.shape) == lead == want.shape
    _close(got, want, LOGIT_TOL)


@pytest.mark.parametrize("impl", ["naive", "flash"])
@pytest.mark.parametrize("head", ["hidden", "mlm_logits"])
@pytest.mark.parametrize("mux_kind,demux_kind", PAIRS)
def test_kernel_path_matches_reference_kernel_path(mux_kind, demux_kind,
                                                   head, impl):
    """Both kernel paths at N=2, ``attn_impl`` naive and flash: the
    reference's Pallas kernels in interpret mode, the port's wrappers'
    plain versions."""
    case = (2, mux_kind, demux_kind)
    _close(_port_head(case, head, True, impl),
           _ref_head(case, head, True, impl), LOGIT_TOL)


# the wrappers one ``hidden`` calls under use_kernels with attn_impl
# 'flash', as the reference gates its fused entry and exit
# (repro/models/transformer.py:114-117, 215-216); the card run asserts
# these counts as launches
CALLS = {(1, "gaussian", "rsa"): {},
         (2, "gaussian", "rsa"): {"mux_embed_combine": 1, "demux_rsa": 1},
         (2, "gaussian", "prefix"): {"mux_combine": 1},
         (2, "contextual", "rsa"): {"demux_rsa": 1},
         (2, "contextual", "prefix"): {}}


@pytest.mark.parametrize("case", sorted(CALLS), ids=_case_id)
def test_wrapper_calls_per_hidden(case):
    ops.reset_counts()
    _port_head(case, "hidden", True, "flash")
    want = dict.fromkeys(ops.counts(), 0)
    want.update(CALLS[case], flash_attention=REDUCED["n_layers"])
    assert ops.counts("calls") == want
    assert not any(ops.counts("launches").values())      # CPU tensors
    ops.reset_counts()
    _port_head(case, "hidden", False)                    # the plain path
    assert not any(ops.counts("calls").values())


# -- interop and configs -----------------------------------------------------

def test_interop_round_trip_of_a_bert_tree():
    """Contextual-mux and prefix-demux params, the MLM and RTD heads and
    two classifier heads cross both ways leaf for leaf."""
    _, _, ref, port, _ = _model(2, "contextual", "prefix")
    assert set(port["backbone"]["mux_engine"]["mux"]) == {
        "v", "trans_ctx", "trans_inst"}
    assert "prefix_emb" in port["backbone"]["mux_engine"]["demux"]
    back = interop.params_to_reference(port, bert_config("base", **REDUCED))
    want = jax.tree.map(np.asarray, ref)
    assert jax.tree.structure(back) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(want)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("mux_kind,demux_kind", PAIRS)
def test_init_tree_has_reference_keys_and_shapes(mux_kind, demux_kind):
    rs, ps = _specs(2, mux_kind, demux_kind)
    cfg_r = ref_bert_config("base", **REDUCED)
    cfg = bert_config("base", **REDUCED)
    g = torch.Generator().manual_seed(0)
    want = {**RefBERT.init(jax.random.PRNGKey(0), cfg_r, rs, electra=True),
            "cls": RefBERT.init_classifier(jax.random.PRNGKey(1), cfg_r, 3),
            "tok": RefBERT.init_token_classifier(jax.random.PRNGKey(2),
                                                 cfg_r, 5)}
    mine = {**MuxBERT.init(g, cfg, ps, electra=True),
            "cls": MuxBERT.init_classifier(g, cfg, 3),
            "tok": MuxBERT.init_token_classifier(g, cfg, 5)}
    got = interop.params_to_reference(mine, cfg)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    assert [a.shape for a in jax.tree.leaves(got)] == \
        [a.shape for a in jax.tree.leaves(want)]
    assert "rtd" not in MuxBERT.init(g, cfg, ps)


@pytest.mark.parametrize("arch", PAPER_MODELS)
def test_registry_full_config_and_param_count_match_reference(arch):
    """Every field the port's ``ModelConfig`` has equals the reference's,
    ``param_count`` equals the reference's, and the kind is 'bert'."""
    mine, want = get_config(arch), ref_config(arch)
    for f in dataclasses.fields(ModelConfig):
        assert getattr(mine, f.name) == getattr(want, f.name), f.name
    assert param_count(mine) == ref_param_count(want)
    assert model_kind(arch) == ref_model_kind(arch) == "bert"


@pytest.mark.parametrize("arch", PAPER_MODELS)
def test_reduced_config_is_bert_config_of_the_reduced_shape(arch):
    """The port's reduced config is ``bert_config(size, **REDUCED)``: heads
    of d_model / n_heads, equal to the reference's ``bert_config`` of the
    same shape field by field and in ``param_count``, which counts every
    backbone parameter of the port's init."""
    size = arch.split("-")[-1]
    mine = get_config(arch, reduced=True)
    assert mine == bert_config(size, **REDUCED)
    assert (mine.n_kv_heads, mine.head_dim) == (4, 16)
    want = ref_bert_config(size, **REDUCED)
    for f in dataclasses.fields(ModelConfig):
        assert getattr(mine, f.name) == getattr(want, f.name), f.name
    assert param_count(mine) == ref_param_count(want)
    p = MuxBERT.init(torch.Generator().manual_seed(0), mine)
    assert sum(t.numel() for t in jax.tree.leaves(p["backbone"])) == \
        param_count(mine)


def test_reference_reduced_bert_config_is_inconsistent():
    """Reference fault (ROADMAP §3): the reference registry reduces
    mux-bert-base with ``cfg.replace(d_model=64, n_heads=4, ...)``, which
    keeps base's derived ``n_kv_heads=12`` and ``head_dim=64``
    (``repro/configs/registry.py:93-94``), so its first forward fails to
    reshape.  The port's reduced config derives them and runs."""
    cfg_r = ref_config("mux-bert-base", reduced=True)
    assert (cfg_r.d_model, cfg_r.n_heads) == (64, 4)
    assert (cfg_r.n_kv_heads, cfg_r.head_dim) == (12, 64)
    ref = RefBERT.init(jax.random.PRNGKey(0), cfg_r)
    toks = jnp.zeros((2, 16), jnp.int32)
    with pytest.raises(TypeError, match="cannot reshape"):
        RefBERT.hidden(ref, cfg_r, toks)
    cfg = get_config("mux-bert-base", reduced=True)
    p = MuxBERT.init(torch.Generator().manual_seed(0), cfg, MuxSpec(n=2))
    out = MuxBERT.mlm_logits(p, cfg, torch.zeros((2, 16), dtype=torch.long),
                             mux=MuxSpec(n=2))
    assert out.shape == (2, 16, 512) and bool(torch.isfinite(out).all())
