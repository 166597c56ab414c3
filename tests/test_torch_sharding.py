"""Port parity for the sharding rules (`repro_torch.sharding`) over
described meshes (`repro_torch.launch.mesh`): the twin of
`tests/test_substrate.py`'s sharding tests.

Every architecture's parameter, cache and batch specs are held, leaf by
leaf, to the reference's `PartitionSpec`s (as tuples) on the (1, 1) debug
mesh and on the production (16, 16) and (2, 16, 16) shapes. The reference
reads only a mesh's `axis_names` and `devices.shape`, so its production
meshes are duck-typed here (no 512 devices needed). Equality is exact.
"""
from functools import cache
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch.utils._pytree as tpytree

from repro import sharding as jsharding
from repro.configs import INPUT_SHAPES as JSHAPES
from repro.configs import get_config as jget_config
from repro.launch import dryrun as jdryrun
from repro.launch.mesh import make_debug_mesh as jdebug_mesh
from repro.models import registry as jregistry
from repro_torch import sharding
from repro_torch.configs import INPUT_SHAPES, get_config, list_archs
from repro_torch.launch import dryrun, mesh
from repro_torch.models import registry

MESHES = {"1x1": ((1, 1), ("data", "model")),
          "16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
ARCHS = list_archs()
LM_ARCHS = [a for a in ARCHS if a != "b_alexnet"]


@pytest.fixture
def meshes(request):
    """(reference mesh, port MeshSpec) for a mesh name; the reference's
    module-level mesh is reset afterwards."""
    def make(name):
        shape, axes = MESHES[name]
        ref = (jdebug_mesh(1, 1) if name == "1x1"
               else SimpleNamespace(axis_names=axes, devices=np.empty(shape)))
        jsharding.set_mesh(ref)
        return ref, mesh.MeshSpec(axes, shape)

    yield make
    jsharding.set_mesh(None)


@cache
def _param_shapes(arch):
    """(reference, port) parameter specs of an arch, made once."""
    return (jregistry.param_specs_shapes(jget_config(arch)),
            registry.param_specs_shapes(get_config(arch)))


def _jspecs(tree):
    """{path: spec tuple} of a reference spec tree."""
    leaves = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
    return {jsharding._path_str(p): tuple(s) for p, s in leaves}


def _tspecs(tree):
    leaves = tpytree.tree_flatten_with_path(tree, is_leaf=lambda x: isinstance(x, tuple))[0]
    return {sharding.path_str(p): s for p, s in leaves}


def test_mesh_descriptions():
    assert mesh.make_production_mesh() == mesh.MeshSpec(("data", "model"), (16, 16))
    big = mesh.make_production_mesh(multi_pod=True)
    assert big.axis_names == ("pod", "data", "model") and big.shape == (2, 16, 16)
    assert big.size == 512 and big.name == "2x16x16" and big.axis_size("pod") == 2
    assert mesh.make_debug_mesh(4, 2).shape == (4, 2)
    assert dryrun.parse_mesh("2x16x16") == big
    with pytest.raises(ValueError):
        mesh.MeshSpec(("data",), (2, 2))
    with pytest.raises(ValueError):
        dryrun.parse_mesh("16")


@pytest.mark.parametrize("name", list(MESHES))
def test_axes_spec_for_and_fit_spec(meshes, name):
    """The twin of test_param_spec_rules / test_fit_spec_degrades_indivisible,
    on every mesh: the data and model axes, a rule per family of leaf, and
    sharding dropped where the axis does not divide the dim."""
    _, m = meshes(name)
    assert sharding.dp_axes(m) == jsharding.dp_axes()
    assert sharding.tp_axis(m) == jsharding.tp_axis()
    cases = [("segments/0/attn/wq", (512, 16, 64)), ("segments/0/attn/wq", (512, 12, 64)),
             ("embed/w", (151936, 4096)), ("exits/0/head/w", (4096, 50280)),
             ("segments/1/moe/w_up", (4, 40, 1536, 512)), ("segments/0/mamba/conv_b", (3,)),
             ("segments/0/mamba/dt_proj", (768, 24)), ("final_norm/scale", (4096,)),
             ("conv1/w", (64, 3, 5, 5)), ("segments/0/attn/wq", (16,))]
    for path, shape in cases:
        assert sharding.spec_for(path, shape, m) == tuple(jsharding.spec_for(path, shape)), path
    for axes, shape in [(["model", None], (24, 8)), (["model", None], (16, 8)),
                        ([("pod", "data") if name == "2x16x16" else "data", "model"], (32, 48)),
                        ([None, None], (3, 3))]:
        assert sharding.fit_spec(axes, shape, m) == tuple(jsharding.fit_spec(axes, shape))
    assert sharding.fit_spec(["model", None], (24, 8), None) == ("model", None)


@pytest.mark.parametrize("name", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_match_reference(meshes, arch, name):
    _, m = meshes(name)
    jshapes, shapes = _param_shapes(arch)
    assert _tspecs(sharding.param_specs(shapes, m)) == _jspecs(jsharding.param_specs(jshapes))


@pytest.mark.parametrize("name", list(MESHES))
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_cache_and_batch_specs_match_reference(meshes, arch, name):
    """Decode caches sharded by batch (decode_32k) and by sequence
    (long_500k, batch 1), and every shape's batch specs."""
    _, m = meshes(name)
    for shape_name, shape in INPUT_SHAPES.items():
        jshape = JSHAPES[shape_name]
        jcfg = jdryrun.shape_adapted_config(jget_config(arch), jshape)
        cfg = dryrun.shape_adapted_config(get_config(arch), shape)
        assert (_tspecs(sharding.batch_specs_tree(registry.input_specs(cfg, shape), m))
                == _jspecs(jsharding.batch_specs_tree(jregistry.input_specs(jcfg, jshape))))
        if shape.kind != "decode":
            continue
        for batch_sharded in (True, False):
            want = _jspecs(jsharding.cache_specs_tree(jregistry.cache_specs(jcfg, jshape),
                                                      batch_sharded=batch_sharded))
            got = _tspecs(sharding.cache_specs_tree(registry.cache_specs(cfg, shape), m,
                                                    batch_sharded=batch_sharded))
            assert got == want, (shape_name, batch_sharded)


def test_shard_bytes_divides_by_the_sharding_axes():
    m = mesh.make_production_mesh(multi_pod=True)
    leaf = registry.input_specs(get_config("qwen3-8b"), INPUT_SHAPES["train_4k"])["tokens"]
    spec = sharding.batch_specs_tree({"t": leaf}, m)["t"]
    assert spec == (("pod", "data"), None)
    assert sharding.shard_bytes(leaf, spec, m) == 256 * 4096 * 4 // 32
    assert sharding.shard_bytes(leaf, (), m) == 256 * 4096 * 4
