"""The port's sharding rules (``repro_torch.runtime.sharding``) against the
reference's (``repro.runtime.sharding``), on a duck-typed mesh (only
``.shape`` is read), in process and without a process group.

Every leaf of the ten registered architectures is compared at full width:
the reference's shapes come from ``jax.eval_shape`` of its init and the
port's tree from its own init under ``FakeTensorMode``, so nothing is
allocated; each port leaf is looked up by its reference path.
"""
import functools

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.configs import get_config as ref_get_config
from repro.core import MuxSpec as RefMux
from repro.models import TransformerLM as RefLM
from repro.models.encdec import EncDecLM as RefEncDec
from repro.models.vlm import VLM as RefVLM
from repro.runtime import sharding as ref_sh

from repro_torch.configs import ARCHS, get_config, model_kind
from repro_torch.core import MuxSpec
from repro_torch.models import VLM, EncDecLM, TransformerLM
from repro_torch.runtime import sharding as sh


class FakeMesh:
    """Duck-typed mesh: only .shape is consulted by the rules."""
    def __init__(self, **axes):
        self.shape = axes


MESH = FakeMesh(data=16, model=16)
MESHES = {"16x16": FakeMesh(data=16, model=16),
          "2x2": FakeMesh(data=2, model=2), "2x1": FakeMesh(data=2, model=1),
          "1x4": FakeMesh(data=1, model=4), "data8": FakeMesh(data=8)}


# the reference suite's cases (tests/test_runtime.py)
@pytest.mark.parametrize("path,shape,want", [
    ("periods/0/ffn/up/w", (18, 2048, 16384), P(None, None, "model")),
    ("periods/0/ffn/down/w", (18, 16384, 2048), P(None, "model", None)),
    ("periods/0/wq/w", (28, 1536, 16, 128), P(None, None, "model", None)),
    ("periods/0/wq/w", (18, 2048, 8, 256), P(None, None, None, "model")),
    ("periods/0/wk/w", (24, 2560, 8, 80), P(None, None, None, "model")),
    ("periods/0/wq/w", (32, 1536, 24, 64), P(None, None, None, "model")),
    ("embed/table", (256000, 3072), P("model", None)),
    ("embed/table", (49155, 1536), P(None, "model")),
    ("embed/table", (49155, 1537), P()),
    ("periods/0/ffn/w_up", (32, 40, 1536, 512), P(None, None, None, "model")),
    ("periods/0/ffn/w_up", (24, 64, 2048, 1408), P(None, "model", None, None)),
    ("periods/0/ln1/scale", (32, 1536), P()),
    ("final_norm/scale", (4096,), P()),
    ("periods/0/wq/b", (28, 12, 128), P(None, None, "model")),
    ("periods/0/ffn/router/w", (32, 1536, 40), P(None, "model", None)),
])
def test_spec_rules(path, shape, want):
    got = sh.spec_for_param(path, shape, MESH)
    assert isinstance(got, tuple)
    assert got == want == ref_sh.spec_for_param(path, shape, MESH)


def test_spec_rules_model_absent():
    mesh = FakeMesh(data=8)
    assert sh.spec_for_param("periods/0/ffn/up/w", (4, 64, 256), mesh) == ()
    assert sh.data_axes(mesh) == ref_sh.data_axes(mesh) == ("data",)
    for nd in (1, 2, 4):
        assert sh.batch_spec(mesh, nd) == ref_sh.batch_spec(mesh, nd)
    assert sh.data_axes(FakeMesh(pod=2, data=4, model=2)) == ("pod", "data")


def _np_tree(t):
    """The reference's cache tree with numpy leaves of the same shapes."""
    return jax.tree.map(lambda x: np.zeros(x.shape, np.int8), t)


def _is_spec(x):
    return isinstance(x, P) or (isinstance(x, tuple) and not any(
        isinstance(e, dict) for e in x))


def _same_specs(ref_specs, port_specs):
    flat, _ = jax.tree_util.tree_flatten_with_path(ref_specs,
                                                   is_leaf=_is_spec)
    got, _ = jax.tree_util.tree_flatten_with_path(port_specs,
                                                  is_leaf=_is_spec)
    assert [ref_sh.path_of(k) for k, _ in flat] == \
        [ref_sh.path_of(k) for k, _ in got]
    for (kp, want), (_, have) in zip(flat, got):
        assert have == want, (ref_sh.path_of(kp), have, want)


def test_cache_specs():
    """The reference suite's ring / state case and its paged layout case."""
    mesh = FakeMesh(data=16, model=16)
    cache = {"periods": [{"k": np.zeros((28, 128, 1024, 16, 64), np.int8),
                          "pos": np.zeros((28, 1024)),
                          "idx": np.zeros((28,))}],
             "tail": [{"s": np.zeros((1, 64, 64, 64)),
                       "shift_tm": np.zeros((1, 4096))}]}
    specs = sh.cache_specs(cache, mesh)
    assert specs["periods"][0]["k"] == P(None, ("data",), None, "model", None)
    assert specs["periods"][0]["pos"] == P(None, None)
    assert specs["tail"][0]["s"] == P(None, "model", None, None)
    assert specs["tail"][0]["shift_tm"] == P(None, "model")
    _same_specs(ref_sh.cache_specs(cache, mesh), specs)
    mesh = FakeMesh(data=2, model=2)
    cache = {"periods": [{"kp": np.zeros((3, 10, 8, 2, 16)),
                          "vp": np.zeros((3, 10, 8, 2, 16)),
                          "ppos": np.zeros((3, 10, 8)),
                          "bt": np.zeros((3, 4, 5))}],
             "tail": [{"kp": np.zeros((10, 8, 2, 16)),
                       "ppos": np.zeros((10, 8)), "bt": np.zeros((4, 5))}]}
    specs = sh.cache_specs(cache, mesh)
    assert specs["periods"][0]["kp"] == P(None, ("data",), None, "model",
                                          None)
    assert specs["tail"][0]["bt"] == P(("data",), None)
    _same_specs(ref_sh.cache_specs(cache, mesh), specs)


REF_MODELS = {"lm": RefLM, "encdec": RefEncDec, "vlm": RefVLM}
PORT_MODELS = {"lm": TransformerLM, "encdec": EncDecLM, "vlm": VLM}


@functools.lru_cache(maxsize=None)
def _trees(arch):
    """(reference eval_shape tree, port FakeTensor tree) at full width."""
    kind = model_kind(arch)
    ref = jax.eval_shape(lambda k: REF_MODELS[kind].init(
        k, ref_get_config(arch), RefMux(n=2)), jax.random.PRNGKey(0))
    with FakeTensorMode():
        port = PORT_MODELS[kind].init(torch.Generator().manual_seed(0),
                                      get_config(arch), MuxSpec(n=2))
    return ref, port


def _ref_by_path(tree, specs):
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    sflat = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, P))[0]
    return {ref_sh.path_of(k): (tuple(v.shape), s)
            for (k, v), (_, s) in zip(flat, sflat)}


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_and_opt_specs_every_leaf(arch, mesh):
    """param_specs and opt_state_specs of every leaf at full width equal the
    reference's for that leaf's reference path."""
    m = MESHES[mesh]
    ref, port = _trees(arch)
    pat = len(get_config(arch).block_pattern)
    want = _ref_by_path(ref, ref_sh.param_specs(ref, m))
    ref_opt = ref_sh.opt_state_specs(ref, m)
    want_opt = _ref_by_path(ref, ref_opt["m"])
    got = sh.param_specs(port, m, pattern=pat)
    got_opt = sh.opt_state_specs(port, m, pattern=pat)
    assert got_opt["count"] == ref_opt["count"] == P()
    leaves = sh._ref_leaves(port, pat)
    specs = {id(x): s for x, s in zip(
        jax.tree.leaves(port), jax.tree.leaves(
            got, is_leaf=lambda x: isinstance(x, tuple)))}
    opt = {id(x): s for x, s in zip(
        jax.tree.leaves(port), jax.tree.leaves(
            got_opt["m"], is_leaf=lambda x: isinstance(x, tuple)))}
    # a stacked reference leaf holds every period's layer
    assert sorted({p for p, _, _ in leaves}) == sorted(want)
    for path, shape, leaf in leaves:
        assert shape == want[path][0], path
        assert specs[id(leaf)] == want[path][1], (path, specs[id(leaf)])
        assert opt[id(leaf)] == want_opt[path][1], (path, opt[id(leaf)])


@pytest.mark.parametrize("kv", ["fp32", "int8"])
@pytest.mark.parametrize("mesh", ["2x2", "2x1", "1x4", "16x16"])
def test_paged_cache_specs(kv, mesh):
    """A paged cache over fp32 and int8 pages: the port's rules on the
    reference's cache tree equal the reference's, and on the port's own
    cache (one dict per layer) each leaf gets the reference leaf's spec
    without the period axis."""
    m = MESHES[mesh]
    cfg_r = ref_get_config("qwen2-1.5b", reduced=True)
    quant = None if kv == "fp32" else kv
    store = jax.numpy.float32 if quant is None else jax.numpy.int8
    ref = jax.eval_shape(lambda: RefLM.init_cache(
        cfg_r, 4, 32, store, layout="paged", block_size=4, num_blocks=36,
        kv_quant=quant))
    ref_specs = ref_sh.cache_specs(ref, m)
    _same_specs(ref_specs, sh.cache_specs(_np_tree(ref), m))
    with FakeTensorMode():
        port = TransformerLM.init_cache(
            get_config("qwen2-1.5b", reduced=True), 4, 32, torch.float32,
            layout="paged", block_size=4, num_blocks=36, kv_quant=quant,
            device="cpu")
    got = sh.cache_specs(port, m)
    want = ref_specs["periods"][0]
    for name, spec in got["layers"][0].items():
        assert want[name] == (None, *spec)        # the period axis in front
    assert want["bt"] == (None, *got["bt"])


def test_local_shard():
    x = torch.arange(4 * 6).reshape(4, 6)
    sizes = {"data": 2, "model": 3}
    parts = [[sh.local_shard(x, (("data",), "model"),
                             {"data": d, "model": r}, sizes)
              for r in range(3)] for d in range(2)]
    assert torch.equal(torch.cat([torch.cat(p, 1) for p in parts], 0), x)
    assert sh.local_shard(x, (), {"model": 1}, sizes) is x
    assert sh.port_spec((None, None, "model"), 2) == (None, "model")
    assert sh.port_spec((), 3) == ()
    with pytest.raises(ValueError, match="does not split"):
        sh.local_shard(x, ("model", None), {"model": 0}, {"model": 3})
