"""The port's sharding rules against the JAX package's, leaf by leaf.

For all ten archs at published widths (the JAX tree from ``eval_shape``,
the port's from its meta-device ``abstract_params``): ``param_pspecs``
under "2d", under "fsdp" on the production (16, 16) mesh and on a (2, 2)
mesh (``param_pspec_fsdp`` picks the largest dimension that divides the
widest axis group, so the two sizes choose differently), and with
``zero_over_pod`` on the (2, 16, 16) mesh; ``state_pspecs`` on each
arch's decode state; ``batch_pspecs``; the ``fit_batch_*`` cases of
tests/test_sharding.py; every split dimension divides its axes; and the
abstract trees of ``launch/steps.py`` (``input_specs`` for every shape
kind, ``abstract_opt_state`` / ``abstract_train_state``, ``shard_tree``)
against the reference's shapes and dtypes, with the specs its
``input_specs`` gives a mesh.

The reference stacks a pattern position's layers for ``lax.scan``: layer
``g * len(pattern) + i`` is entry ``[g]`` of ``blocks/scan/i``, and its
spec is the reference's with the scan's leading None dropped.
"""
import torch_cores  # noqa: F401  (first: caps torch's threads)
import functools

import jax
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from repro.configs import registry as jreg
from repro.distributed import sharding as jsh
from repro.launch import steps as jsteps
from repro.models import init_params as j_init_params
from repro.models.transformer import init_decode_state as j_init_state
from repro_torch.configs import registry as treg
from repro_torch.distributed import sharding as tsh
from repro_torch.launch import steps
from repro_torch.launch.mesh import Mesh, make_production_mesh

ARCHS = tuple(jreg.list_archs())


class FakeMesh:
    def __init__(self, shape):
        self.axis_names = tuple(shape)
        self.shape = dict(shape)


PROD = {"data": 16, "model": 16}
POD = {"pod": 2, "data": 16, "model": 16}
SMALL = {"data": 2, "model": 2}


@functools.lru_cache(maxsize=None)
def _jax_params(arch):
    cfg = jreg.get_config(arch)
    return cfg, jax.eval_shape(lambda: j_init_params(cfg,
                                                     jax.random.PRNGKey(0)))


@functools.lru_cache(maxsize=None)
def _port_params(arch):
    return steps.abstract_params(treg.get_config(arch))


def _port_name(cfg, path: str, g: int = 0) -> str:
    """The port's name of a reference leaf path (entry ``g`` of a scanned
    leaf)."""
    parts = path.split("/")
    if parts[0] == "blocks":
        pat = len(cfg.block_pattern)
        n_groups = cfg.num_layers // pat
        pos = int(parts[2])
        layer = g * pat + pos if parts[1] == "scan" else n_groups * pat + pos
        rest = ["lam" if p == "lambda" else p for p in parts[3:]]
        return ".".join(["blocks", str(layer)] + rest)
    if parts[0] == "embed":
        return "embed" if parts[1] == "tokens" else f"embed.{parts[1][2:]}"
    if parts[0] == "head" and parts[1].startswith("cb"):
        return ".".join(["head", parts[1][2:]] + parts[2:])
    return ".".join(parts)


def _ref_specs(cfg, tree, specs) -> dict:
    """{port name: spec tuple} of a reference spec tree (scan prefix
    dropped, one entry per layer)."""
    out = {}
    leaves = jax.tree_util.tree_leaves_with_path(tree)
    spec_leaves = jax.tree_util.tree_leaves(
        specs, is_leaf=lambda x: isinstance(x, JP))
    assert len(leaves) == len(spec_leaves)
    for (path, leaf), spec in zip(leaves, spec_leaves):
        ps = jsh._path_str(path)
        spec = tuple(spec)
        if "/scan/" in ps:
            assert spec[0] is None, (ps, spec)
            for g in range(leaf.shape[0]):
                out[_port_name(cfg, ps, g)] = spec[1:]
        else:
            out[_port_name(cfg, ps)] = spec
    return out


def _divides(specs, shapes, sizes):
    for name, spec in specs.items():
        assert len(spec) == len(shapes[name]), (name, spec)
        for dim, ax in zip(shapes[name], spec):
            if ax is None:
                continue
            n = 1
            for a in (ax if isinstance(ax, tuple) else (ax,)):
                n *= sizes[a]
            assert dim % n == 0, (name, spec, shapes[name])


CASES = {
    "2d": (dict(), None, PROD),
    "fsdp_16x16": (dict(strategy="fsdp"), PROD, PROD),
    "fsdp_2x2": (dict(strategy="fsdp"), SMALL, SMALL),
    "zero_over_pod": (dict(zero_over_pod=True), None, POD),
}


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_pspecs_match_the_reference(arch, case):
    kw, mesh_shape, sizes = CASES[case]
    cfg, jtree = _jax_params(arch)
    jmesh = None if mesh_shape is None else FakeMesh(mesh_shape)
    want = _ref_specs(cfg, jtree, jsh.param_pspecs(jtree, mesh=jmesh, **kw))
    tmesh = None if mesh_shape is None else Mesh(mesh_shape)
    model = _port_params(arch)
    got = tsh.param_pspecs(model, mesh=tmesh, **kw)
    assert list(got) == list(tsh.stored(model))
    assert {k: tuple(v) for k, v in got.items()} == want
    assert all(isinstance(v, tsh.P) for v in got.values())
    shapes = {k: tuple(p.shape) for k, p in tsh.stored(model).items()}
    _divides(got, shapes, sizes)


@pytest.mark.parametrize("batch", [32, 1])
@pytest.mark.parametrize("arch", ARCHS)
def test_state_and_batch_pspecs_match_the_reference(arch, batch):
    jcfg = jreg.get_config(arch)
    tcfg = treg.get_config(arch)
    mesh = make_production_mesh()
    jmesh = FakeMesh(PROD)
    jstate = jax.eval_shape(lambda: j_init_state(jcfg, batch, 64))
    jspecs = jsh.state_pspecs(jstate, jmesh)
    want = {}
    for (path, leaf), spec in zip(
            jax.tree_util.tree_leaves_with_path(jstate),
            jax.tree_util.tree_leaves(jspecs,
                                      is_leaf=lambda x: isinstance(x, JP))):
        ps = jsh._path_str(path)
        spec = tuple(spec)
        if ps == "pos":
            want["pos"] = spec
        elif ps.startswith("scan/"):
            for g in range(leaf.shape[0]):
                want[_port_name(jcfg, "blocks/" + ps, g)] = spec[1:]
        else:
            want[_port_name(jcfg, "blocks/" + ps)] = spec
    tstate = steps.abstract_decode_state(tcfg, batch, 64)
    tspecs = tsh.state_pspecs(tstate, mesh)
    got = {"pos": tuple(tspecs["pos"])}
    for i, (st, sp) in enumerate(zip(tstate["layers"], tspecs["layers"])):
        assert type(sp) is type(st)
        for f in st._fields:
            got[f"blocks.{i}.{f}"] = tuple(getattr(sp, f))
    assert got == want

    b = {"tokens": torch.empty((batch, 16), device="meta"),
         "labels": torch.empty((batch, 16), device="meta"),
         "frontend": torch.empty((batch, 4, 8), device="meta")}
    jb = {k: jax.ShapeDtypeStruct(tuple(v.shape), jax.numpy.int32)
          for k, v in b.items()}
    assert {k: tuple(v) for k, v in tsh.batch_pspecs(b, mesh).items()} == \
        {k: tuple(v) for k, v in jsh.batch_pspecs(jb, jmesh).items()}


@pytest.mark.parametrize("size,strategy", [
    (256, "2d"), (1, "2d"), (2, "2d"), (3, "2d"), (32, "2d"), (512, "fsdp"),
    (64, "fsdp"), (4, "fsdp")])
def test_fit_batch_matches_the_reference(size, strategy):
    for shape in (POD, PROD, SMALL, {"data": 1, "model": 4}):
        tm, jm = Mesh(shape), FakeMesh(shape)
        assert tsh.batch_axes(tm) == jsh.batch_axes(jm)
        assert tsh.fit_batch_axes(tm, size, strategy) == \
            jsh.fit_batch_axes(jm, size, strategy)
        assert tsh.fit_batch_spec(tm, size, strategy) == \
            jsh.fit_batch_spec(jm, size, strategy)
    m = Mesh(POD)
    assert tsh.fit_batch_axes(m, 256) == ("pod", "data")
    assert tsh.fit_batch_axes(m, 1) == ()
    assert tsh.fit_batch_axes(m, 2) == ("pod",)
    assert tsh.fit_batch_spec(m, 1) is None


def test_rule_tables_and_reference_paths():
    """The tables are the reference's, and each port name reads as the
    reference's path for the rules (scan dropped)."""
    assert [p for p, _ in tsh.PARAM_RULES] == [p for p, _ in jsh.PARAM_RULES]
    assert [tuple(s) for _, s in tsh.PARAM_RULES] == \
        [tuple(s) for _, s in jsh.PARAM_RULES]
    assert [p for p, _ in tsh.STATE_RULES] == [p for p, _ in jsh.STATE_RULES]
    for b in (None, "data", ("pod", "data")):
        assert [tuple(f(b)) for _, f in tsh.STATE_RULES] == \
            [tuple(f(b)) for _, f in jsh.STATE_RULES]
    assert tsh.ref_path("embed") == "embed/tokens"
    assert tsh.ref_path("embed.2") == "embed/cb2"
    assert tsh.ref_path("head.1.w") == "head/cb1/w"
    assert tsh.ref_path("blocks.7.rec.lam") == "blocks/7/rec/lambda"
    assert tuple(tsh.param_pspec("blocks/3/attn/wq/w", 2)) == \
        tuple(jsh.param_pspec("blocks/rem/0/attn/wq/w", 2))
    assert tuple(tsh.param_pspec("blocks/3/ffn/up/w", 2,
                                 zero_over_pod=True)) == \
        (("pod", "data"), "model")


def test_production_mesh_is_shapes_only():
    m = make_production_mesh()
    assert m.axis_names == ("data", "model")
    assert m.shape == PROD and m.rank is None
    m2 = make_production_mesh(multi_pod=True)
    assert m2.axis_names == ("pod", "data", "model") and m2.size == 512
    with pytest.raises(ValueError):
        tsh.ShardPlan(m)                     # no ranks to place blocks on


@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k", "decode_32k"])
@pytest.mark.parametrize("arch", ["qwen3-1.7b", "musicgen-medium",
                                  "pixtral-12b"])
def test_input_specs_and_abstract_trees_match_the_reference(arch, shape):
    jcfg, tcfg = jreg.get_config(arch), treg.get_config(arch)
    jshape, tshape = jreg.get_shape(shape), treg.get_shape(shape)
    want = jsteps.input_specs(jcfg, jshape)
    mesh = make_production_mesh()
    got = steps.input_specs(tcfg, tshape, mesh)
    assert got.keys() == want.keys()
    bspec = jsh.fit_batch_spec(FakeMesh(PROD), jshape.global_batch,
                               jcfg.sharding)
    for k, w in want.items():
        g = got[k]
        assert g.shape == tuple(w.shape)
        assert str(g.dtype).replace("torch.", "") == str(w.dtype)
        assert tuple(g.spec) == (bspec,) + (None,) * (len(g.shape) - 1)
    assert all(v.spec is None for v in
               steps.input_specs(tcfg, tshape).values())
    if shape != "train_4k":
        return
    from repro_torch.configs.base import TrainConfig
    state = steps.abstract_train_state(tcfg, TrainConfig(model=arch))
    names = list(tsh.stored(state["params"]))
    assert list(state["opt"]["m"]) == names == list(state["opt"]["v"])
    assert all(t.device.type == "meta" for t in state["opt"]["m"].values())
    tree = steps.shard_tree(state["opt"]["m"],
                            tsh.param_pspecs(state["opt"]["m"]), mesh)
    specs = tsh.param_pspecs(state["params"])
    assert {k: v.spec for k, v in tree.items()} == specs
    assert all(v.shape == tuple(state["opt"]["m"][k].shape)
               for k, v in tree.items())
