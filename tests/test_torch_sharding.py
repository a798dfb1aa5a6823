"""The port's sharding rules (``repro_torch.models.sharding``) against the
JAX package's, and the DTensor side of ``sharding_utils``.

For every arch and both production meshes (as device-free abstract meshes)
the port's ``param_specs`` equal ``repro.models.sharding.ShardingRules``'
spec for spec, on the shapes of ``jax.eval_shape(model.init)`` handed to the
port as meta tensors in the same nested-dict layout; likewise
``cache_specs`` at ``decode_32k`` and ``batch_specs`` at every shape. The
mirrors of ``tests/test_sharding_rules.py`` hold the port's rules on the
port's own models (built under ``FakeTensorMode``: no memory) for the archs
it builds. ``placements``/``maybe_shard`` run on one gloo rank (a process
group of one, in this process).
"""
import os
import tempfile

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import PartitionSpec as JP
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro.configs import ARCH_IDS, SHAPES, get_config as jget_config
from repro.models import build_model as jbuild_model
from repro.models.sharding import ShardingRules as JRules
from repro.models.sharding_utils import abstract_mesh as jabstract_mesh
from repro_torch.configs import get_config
from repro_torch.launch.mesh import make_mesh, use_mesh
from repro_torch.models import build_model
from repro_torch.models.sharding import ShardingRules, map_with_path
from repro_torch.models.sharding_utils import (BATCH, P, abstract_mesh, batch_spec, clean_spec,
                                               distribute, maybe_shard, mesh_axes, placements)
from repro_torch.models.transformer import unsupported

torch.set_num_threads(2)

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
PORT_ARCHS = [a for a in ARCH_IDS if unsupported(get_config(a)) is None]


def _meta(tree):
    """JAX shape structs -> meta tensors in the same containers."""
    return jax.tree.map(lambda s: torch.empty(s.shape, device="meta"), tree)


def _by_path(tree_shapes, specs):
    """path -> spec tuple of a JAX spec tree."""
    flat_s = jax.tree_util.tree_flatten_with_path(tree_shapes)[0]
    flat_p = jax.tree.leaves(specs, is_leaf=lambda x: isinstance(x, JP))
    assert len(flat_s) == len(flat_p)
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path): tuple(spec)
            for (path, _), spec in zip(flat_s, flat_p)}


def _port_by_path(specs, prefix=""):
    """path -> spec tuple of a port spec tree (a ``P`` is a leaf)."""
    if isinstance(specs, P):
        return {prefix[:-1]: tuple(specs)}
    items = specs.items() if isinstance(specs, dict) else enumerate(specs)
    out = {}
    for k, v in items:
        out.update(_port_by_path(v, f"{prefix}{k}/"))
    return out


def _check_equal(jshapes, jspecs, pspecs, what):
    exp, got = _by_path(jshapes, jspecs), _port_by_path(pspecs)
    assert got.keys() == exp.keys(), what
    bad = {p: (got[p], exp[p]) for p in exp if got[p] != exp[p]}
    assert not bad, f"{what}: {bad}"


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_equal_jax(arch, mesh_name):
    sizes, names = MESHES[mesh_name]
    jcfg = jget_config(arch)
    shapes = jax.eval_shape(jbuild_model(jcfg).init, jax.random.PRNGKey(0))
    jspecs = JRules(jcfg, jabstract_mesh(sizes, names)).param_specs(shapes)
    pspecs = ShardingRules(get_config(arch), abstract_mesh(sizes, names)).param_specs(
        _meta(shapes))
    _check_equal(shapes, jspecs, pspecs, f"{arch} on {mesh_name}")


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_specs_equal_jax(arch, mesh_name):
    sizes, names = MESHES[mesh_name]
    jcfg = jget_config(arch)
    shape = SHAPES["decode_32k"]
    cache = jax.eval_shape(lambda: jbuild_model(jcfg).init_cache(shape.global_batch,
                                                                 shape.seq_len))
    jspecs = JRules(jcfg, jabstract_mesh(sizes, names)).cache_specs(cache, shape.global_batch)
    pspecs = ShardingRules(get_config(arch), abstract_mesh(sizes, names)).cache_specs(
        _meta(cache), shape.global_batch)
    _check_equal(cache, jspecs, pspecs, f"{arch} cache on {mesh_name}")


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("shape_name", sorted(SHAPES))
def test_batch_specs_equal_jax(shape_name, mesh_name):
    sizes, names = MESHES[mesh_name]
    shape = SHAPES[shape_name]
    B, S = shape.global_batch, shape.seq_len
    batch = {"tokens": jax.ShapeDtypeStruct((B, S), np.int32),
             "labels": jax.ShapeDtypeStruct((B, S), np.int32),
             "mask": jax.ShapeDtypeStruct((B, S), np.float32),
             "pos": jax.ShapeDtypeStruct((B,), np.int32)}
    cfg = jget_config("qwen3_32b")
    jspecs = JRules(cfg, jabstract_mesh(sizes, names)).batch_specs(batch, B)
    pspecs = ShardingRules(get_config("qwen3_32b"), abstract_mesh(sizes, names)).batch_specs(
        _meta(batch), B)
    _check_equal(batch, jspecs, pspecs, f"{shape_name} batch on {mesh_name}")


def test_spec_canonicalisation_matches_jax():
    for entries in [(("data",), "model", None), ((), None), ((("pod", "data")), None),
                    ("model",), ()]:
        assert tuple(P(*entries)) == tuple(JP(*entries)), entries


# -- jax-free mirrors of tests/test_sharding_rules.py on the port's own models ----------
def _port_shapes(arch, cache=None):
    model = build_model(get_config(arch), device="cpu")
    with FakeTensorMode():
        if cache is None:
            return model.init(torch.Generator())
        return model.init_cache(*cache)


def _leaves_with_specs(shapes, specs):
    out = []
    map_with_path(lambda path, leaf: out.append((path, leaf)), shapes)
    flat = _port_by_path(specs)
    return [(path, leaf, flat[path]) for path, leaf in out]


def _check_spec_divides(shape, spec, sizes, where):
    assert len(spec) <= len(shape), f"{where}: spec longer than shape"
    for dim, entry in zip(shape, spec):
        if entry is None:
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        factor = int(np.prod([sizes[a] for a in axes]))
        assert dim % factor == 0, f"{where}: dim {dim} not divisible by {axes} (={factor})"


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", PORT_ARCHS)
def test_port_param_specs_divide(arch, mesh_name):
    sizes, names = MESHES[mesh_name]
    mesh = abstract_mesh(sizes, names)
    shapes = _port_shapes(arch)
    rules = ShardingRules(get_config(arch), mesh)
    for path, leaf, spec in _leaves_with_specs(shapes, rules.param_specs(shapes)):
        _check_spec_divides(leaf.shape, spec, mesh.shape, f"{arch}:{path}")


@pytest.mark.parametrize("arch", PORT_ARCHS)
def test_port_cache_specs_divide(arch):
    sizes, names = MESHES["16x16"]
    mesh = abstract_mesh(sizes, names)
    shape = SHAPES["decode_32k"]
    cache = _port_shapes(arch, (shape.global_batch, shape.seq_len))
    rules = ShardingRules(get_config(arch), mesh)
    for path, leaf, spec in _leaves_with_specs(cache, rules.cache_specs(cache,
                                                                        shape.global_batch)):
        _check_spec_divides(leaf.shape, spec, mesh.shape, f"{arch}:{path}")


@pytest.mark.parametrize("arch", ["qwen3_32b", "mamba2_780m", "recurrentgemma_9b"])
def test_port_big_params_actually_sharded(arch):
    """Every leaf over 64 MB in bf16 must be sharded on the 512-device mesh."""
    mesh = abstract_mesh(*MESHES["2x16x16"])
    shapes = _port_shapes(arch)
    rules = ShardingRules(get_config(arch), mesh)
    for path, leaf, spec in _leaves_with_specs(shapes, rules.param_specs(shapes)):
        if leaf.numel() * 2 > 64e6:
            assert any(e is not None for e in spec), f"{arch}:{path} ({leaf.shape}) replicated"


# -- placements and maybe_shard ---------------------------------------------------------
def test_clean_spec_drops_absent_axes_and_non_dividing_dims():
    sizes = {"data": 2, "model": 4}
    assert clean_spec(P(BATCH, "model", None), (4, 8, 3), sizes) == P("data", "model", None)
    assert clean_spec(P(BATCH, "model", None), (1, 6, 3), sizes) == P(None, None, None)
    assert clean_spec(P(("pod", "data", "model")), (16,), {"pod": 2, "data": 2, "model": 4}) \
        == P(("pod", "data", "model"))
    assert clean_spec(P(("pod", "data", "model")), (8,), {"pod": 2, "data": 2, "model": 4}) \
        == P(None)
    assert batch_spec(None) == P(BATCH, None)


def test_placements_pod_data_become_two_shards_in_order():
    mesh = abstract_mesh((2, 2, 4), ("pod", "data", "model"))
    assert placements(P(("pod", "data"), "model", None), mesh) == (Shard(0), Shard(0), Shard(1))
    assert placements(P(None, None), mesh) == (Replicate(),) * 3
    assert placements(P("model", ("pod", "data")), mesh) == (Shard(1), Shard(1), Shard(0))
    with pytest.raises(ValueError):
        placements(P(("data", "pod")), mesh)


@pytest.fixture(scope="module")
def one_rank_group():
    """A gloo process group of this process alone."""
    if dist.is_initialized():
        pytest.fail("a process group is already up in this test process")
    store = os.path.join(tempfile.mkdtemp(), "store")
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=0, world_size=1)
    yield
    dist.destroy_process_group()


def test_maybe_shard_lays_dtensors_out_and_leaves_plain_tensors(one_rank_group):
    mesh = make_mesh((1, 1), ("data", "model"), device="cpu")
    x = torch.arange(24.0).reshape(2, 3, 4)
    assert maybe_shard(x, P(BATCH, "model", None)) is x            # no ambient mesh
    dx = distribute(x, P(None, None, None), mesh)
    assert maybe_shard(dx, P(BATCH, "model", None)) is dx          # no ambient mesh
    assert mesh_axes() == ()
    with use_mesh(mesh):
        assert mesh_axes() == ("data", "model")
        assert maybe_shard(x, P(BATCH, "model", None)) is x        # a plain tensor
        y = maybe_shard(dx, P(BATCH, "model", None))
        # one rank a mesh dim: replicated (test_torch_dtensor shards over 4)
        assert isinstance(y, DTensor) and y.placements == (Replicate(), Replicate())
        assert torch.equal(y.full_tensor(), x)
    assert mesh_axes() == ()


def test_placements_replicate_over_a_mesh_dim_of_one_rank():
    mesh = abstract_mesh((1, 4), ("data", "model"))
    assert placements(P("data", "model", None), mesh) == (Replicate(), Shard(1))
    assert placements(clean_spec(P(BATCH, "model", None), (2, 6, 3), mesh.shape), mesh) \
        == (Replicate(), Replicate())
