"""The port's sharding policies against the JAX package's, on the CPU.

  * ``param_specs`` equal to the reference's for all ten architectures ×
    all seven strategies × the 16×16, 2×16×16 and 2×4 meshes, over the
    full-size abstract parameters: the reference's stacked leaves (a
    leading layer axis, spec entry None) element by element against the
    port's per-layer lists; Adafactor's stacked slots (kimi-k2's
    optimizer) leaf for leaf;
  * ``abstract_params``: the reference's shapes and types;
  * ``batch_specs`` (with and without ``seq_shard``) and ``cache_specs``
    for every architecture and step kind;
  * ``default_activation_rules`` for every strategy and ``seq_shard``;
    ``_divisible``'s edge cases;
  * on a 2×4 fake group: each placed parameter's local shard has the
    shape its spec implies, and ``MeshPolicy.cs`` redistributes a DTensor
    to its rule and leaves a plain tensor alone.

The reference side gets a stand-in mesh, ``SimpleNamespace(axis_names=...,
devices=np.empty(shape))`` (its spec functions read nothing else); the
port side a real ``DeviceMesh`` of a fake process group.
"""

import types

import jax
import numpy as np
import pytest
import torch

from repro.launch import sharding as jsh
from repro.launch.specs import _batch_struct as j_batch_struct
from repro.launch.specs import abstract_params as jabstract_params
from repro.models.model import make_caches as jmake_caches
from repro.optim.optimizers import adafactor as jadafactor
from repro_torch.configs import ALL_ARCHS
from repro_torch.launch import sharding as sh
from repro_torch.launch.mesh import fake_group, make_mesh, mesh_info
from repro_torch.launch.specs import _batch_struct, abstract_params
from repro_torch.models import get_arch, make_caches
from repro_torch.optim import adafactor, warmup_cosine

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "2x4": ((2, 4), ("data", "model"))}


def jmesh(name):
    shape, axes = MESHES[name]
    return types.SimpleNamespace(axis_names=axes, devices=np.empty(shape))


@pytest.fixture(scope="module")
def meshes():
    """Each mesh built under its own fake group (torn down after; the spec
    functions read only the mesh's names and shape)."""
    out = {}
    for name, (shape, axes) in MESHES.items():
        with fake_group(int(np.prod(shape))):
            out[name] = make_mesh(shape, axes)
    return out


_ABSTRACT = {}


def abstract(arch):
    """(reference eval_shape tree, port meta tree), once per module."""
    if arch not in _ABSTRACT:
        cfg = get_arch(arch)
        _ABSTRACT[arch] = (jabstract_params(cfg), abstract_params(cfg))
    return _ABSTRACT[arch]


def ref_flat(tree):
    """{key path: leaf} of a reference tree (ShapeDtypeStructs or specs)."""
    leaves = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
    return {tuple(str(getattr(k, "key", k)) for k in path): leaf
            for path, leaf in leaves}


def port_flat(tree, path=()):
    """{key path: [leaf per layer] or leaf} of a port tree: a list's
    elements under the one key path of the reference's stacked leaf."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(port_flat(v, path + (str(k),)))
        return out
    if isinstance(tree, list):
        per = [port_flat(e) for e in tree]
        return {path + p: [e[p] for e in per] for p in per[0]}
    return {path: tree}


def spec(x):
    return tuple(tuple(e) if isinstance(e, (list, tuple)) else e for e in x)


def assert_specs_equal(jtree, ptree):
    want, got = ref_flat(jtree), port_flat(ptree)
    assert sorted(want) == sorted(got)
    for key, w in want.items():
        g = got[key]
        if isinstance(g, list):          # a stack: the reference's leading None
            assert spec(w)[0] is None, (key, w)
            for i, gi in enumerate(g):
                assert spec(gi) == spec(w)[1:], (key, i, gi, w)
        else:
            assert spec(g) == spec(w), (key, g, w)


@pytest.mark.parametrize("strategy", sh.STRATEGIES)
@pytest.mark.parametrize("arch", ALL_ARCHS)
@pytest.mark.parametrize("mesh", list(MESHES))
def test_param_specs_match_reference(meshes, mesh, arch, strategy):
    jp, pp = abstract(arch)
    cfg = get_arch(arch)
    want = jsh.param_specs(jp, cfg, jmesh(mesh), strategy)
    got = sh.param_specs(pp, cfg, meshes[mesh], strategy)
    assert_specs_equal(want, got)


@pytest.mark.parametrize("mesh", ["16x16", "2x16x16"])
def test_param_specs_of_adafactor_state_match_reference(meshes, mesh):
    """kimi-k2 trains with Adafactor (>0.5T params), whose slots keep the
    reference's stacked layout: the port judges them as the reference
    does."""
    arch = "kimi-k2-1t-a32b"
    jp, pp = abstract(arch)
    cfg = get_arch(arch)
    lr = warmup_cosine(3e-4, 10, 100)
    jstate = jax.eval_shape(jadafactor(lr).init, jp)
    pstate = adafactor(lr).init(pp)
    want = jsh.param_specs(jstate, cfg, jmesh(mesh), "fsdp_tp")
    got = sh.param_specs(pstate, cfg, meshes[mesh], "fsdp_tp")
    assert_specs_equal(want, got)


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_abstract_params_match_reference(arch):
    jp, pp = abstract(arch)
    want, got = ref_flat(jp), port_flat(pp)
    assert sorted(want) == sorted(got)
    for key, w in want.items():
        g = got[key]
        shapes = [tuple(t.shape) for t in g] if isinstance(g, list) else None
        if shapes is not None:
            assert len(g) == w.shape[0] and set(shapes) == {w.shape[1:]}, key
            g = g[0]
        else:
            assert tuple(g.shape) == w.shape, key
        assert g.device.type == "meta"
        assert str(g.dtype).split(".")[-1] == str(w.dtype), (key, g.dtype)


@pytest.mark.parametrize("mesh", ["16x16", "2x16x16"])
@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_batch_and_cache_specs_match_reference(meshes, arch, mesh):
    cfg = get_arch(arch)
    jm, pm = jmesh(mesh), meshes[mesh]
    for kind in ("train", "prefill", "decode"):
        jb, pb = j_batch_struct(cfg, 256, 128, kind), \
            _batch_struct(cfg, 256, 128, kind)
        for seq in (False, True):
            want = jsh.batch_specs(jm, jb, seq_shard=seq)
            got = sh.batch_specs(pm, pb, seq_shard=seq)
            assert {k: spec(v) for k, v in got.items()} == \
                {k: spec(v) for k, v in want.items()}, (kind, seq)
    for B, S in ((128, 4096), (1, 1 << 19)):
        jc = jmake_caches(cfg, B, S, abstract=True)
        pc = make_caches(cfg, B, S, device="meta")
        for seq in (False, True):
            want = jsh.cache_specs(jm, jc, seq_shard=seq)
            got = sh.cache_specs(pm, pc, seq_shard=seq)
            assert {k: spec(v) for k, v in got.items()} == \
                {k: spec(v) for k, v in want.items()}, (B, seq)


@pytest.mark.parametrize("seq_shard", [False, True])
@pytest.mark.parametrize("strategy", sh.STRATEGIES)
def test_activation_rules_match_reference(meshes, strategy, seq_shard):
    for mesh in MESHES:
        want = jsh.default_activation_rules(jmesh(mesh), strategy, seq_shard)
        got = sh.default_activation_rules(meshes[mesh], strategy, seq_shard)
        assert {k: spec(v) for k, v in got.items()} == \
            {k: spec(v) for k, v in want.items()}, mesh


def test_make_policy_matches_reference(meshes):
    for strategy in sh.STRATEGIES:
        want = jsh.make_policy(jmesh("2x4"), strategy, remat="full")
        got = sh.make_policy(meshes["2x4"], strategy, remat="full")
        assert got.describe() == want.describe()
    with pytest.raises(ValueError, match="strategy"):
        sh.make_policy(meshes["2x4"], "zero3")


DIVISIBLE_CASES = [
    ((32, 64), ("data", "model")),          # both divide
    ((8, 64), ("data", "model")),           # 8 on a 16-way axis: dropped
    ((64,), ("data", "model")),             # spec longer than the shape
    ((64, 24, 7), (("pod", "data"),)),      # multi-axis entry, padded
    ((16, 24), (("pod", "data"), None)),    # 16 % 32: dropped
    ((1, 1 << 19, 8), (None, ("pod", "data", "model"))),
    ((), ()),                               # a scalar
    ((5, 3), (None, None)),
]


@pytest.mark.parametrize("shape,entries", DIVISIBLE_CASES)
def test_divisible_edge_cases_match_reference(meshes, shape, entries):
    want = jsh._divisible(shape, jax.sharding.PartitionSpec(*entries),
                          jmesh("2x16x16"))
    got = sh._divisible(shape, sh.P(*entries), meshes["2x16x16"])
    assert spec(got) == spec(want)
    assert isinstance(got, sh.P)


def test_mesh_info_and_the_world_size_check(meshes):
    assert mesh_info(meshes["2x16x16"]) == {
        "axes": {"pod": 2, "data": 16, "model": 16}, "n_devices": 512}
    with fake_group(4):
        with pytest.raises(RuntimeError, match="need 8 ranks"):
            make_mesh((2, 4), ("data", "model"))


def test_placements_keep_a_multi_axis_entry_in_order(meshes):
    m = meshes["2x16x16"]
    pl = sh.placements(sh.P(("pod", "data"), "model"), m)
    assert [str(p) for p in pl] == ["S(0)", "S(0)", "S(1)"]
    with pytest.raises(ValueError, match="order"):
        sh.placements(sh.P(("data", "pod")), m)


def test_local_shards_have_the_shapes_their_specs_imply():
    """On a 2×4 fake group, every placed parameter of danube and llama4
    (``scaled()``) under fsdp_tp_ep holds dim // (the product of its
    spec's axis sizes) of each dim; ``cs`` redistributes to the rule."""
    sizes = {"data": 2, "model": 4}
    with fake_group(8):
        mesh = make_mesh((2, 4), ("data", "model"))
        for arch in ("h2o-danube-1.8b", "llama4-scout-17b-a16e"):
            cfg = get_arch(arch).scaled()
            params = abstract_params(cfg)
            specs = sh.param_specs(params, cfg, mesh, "fsdp_tp_ep")
            named = sh.named_sharding(mesh, specs)
            got, want = port_flat(params), port_flat(named)
            n_sharded = 0
            for key, leaf in got.items():
                for p, s in zip(leaf if isinstance(leaf, list) else [leaf],
                                want[key] if isinstance(leaf, list)
                                else [want[key]]):
                    d = s.place(p)
                    implied = []
                    for dim, e in zip(p.shape, tuple(s.spec) + (None,) * 8):
                        axes = e if isinstance(e, tuple) else \
                            (() if e is None else (e,))
                        k = int(np.prod([sizes[a] for a in axes]))
                        implied.append(dim // k)
                        n_sharded += k > 1
                    assert tuple(d.to_local().shape) == tuple(implied), key
            assert n_sharded > 0
        pol = sh.make_policy(mesh, "fsdp_tp")
        x = torch.empty(4, 8, 16, device="meta")
        assert pol.cs(x, "act_btd") is x
        dx = sh.NamedSharding(mesh, sh.P()).place(x)
        y = pol.cs(dx, "act_btd")
        assert [str(p) for p in y.placements] == ["S(0)", "R"]
        assert tuple(y.to_local().shape) == (2, 8, 16)
        heads = pol.cs(dx.view(4, 8, 2, 8), "act_bthd")   # 2 heads, 4-way
        assert [str(p) for p in heads.placements] == ["S(0)", "R"]
