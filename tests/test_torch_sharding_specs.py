"""The port's sharding rules against the reference's rule table.

``repro_torch.distributed.sharding`` is a pure function of parameter paths,
shapes and a mesh's axis sizes, so it is held to the reference's
``param_specs``, ``state_specs`` and ``cache_spec`` on abstract meshes, with
no device: every leaf of all ten archs' full configs (the port's tree drawn
under ``FakeTensorMode``, which allocates nothing; the reference's through
``jax.eval_shape``) on the 16 x 16 and 2 x 16 x 16 meshes, the paths of
both trees equal and each spec equal as a tuple; every family's dense and
paged decode state at a batch that splits and at batch 1; and
``cache_spec`` at batch 1 (the sequence fallback) and 128. Mirrors
``tests/test_sharding_specs.py`` on the port's side.
"""
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import AbstractMesh
from jax.sharding import PartitionSpec as P
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.configs import get_config as jax_get_config
from repro.distributed import sharding as jsharding
from repro.models import model as jmodel
from repro_torch.configs import ARCHS, get_config
from repro_torch.distributed.sharding import (
    Spec,
    batch_spec,
    cache_spec,
    param_specs,
    rule_kind,
    state_specs,
    tree_map_with_path,
)
from repro_torch.models import model as M

SIZES = {"data": 16, "model": 16}
SIZES_MP = {"pod": 2, "data": 16, "model": 16}
PAGED = ("yi-6b", "qwen3-moe-30b-a3b", "internvl2-26b", "command-r-35b")


def _abstract_mesh(sizes: dict):
    try:
        return AbstractMesh(tuple(sizes.values()), tuple(sizes))
    except TypeError:   # jax<0.5 signature: AbstractMesh(((name, size), ...))
        return AbstractMesh(tuple(sizes.items()))


def _flat_ref(shapes, specs) -> dict:
    leaves = jax.tree_util.tree_leaves_with_path(shapes)
    spec_leaves = jax.tree_util.tree_leaves(specs, is_leaf=lambda x: isinstance(x, P))
    assert len(leaves) == len(spec_leaves)
    return {jsharding._path_str(p): (tuple(leaf.shape), tuple(s))
            for (p, leaf), s in zip(leaves, spec_leaves)}


def _flat_port(tree, specs) -> dict:
    shapes, out = {}, {}
    tree_map_with_path(lambda p, leaf: shapes.__setitem__(p, tuple(leaf.shape)), tree)
    tree_map_with_path(lambda p, s: out.__setitem__(p, (shapes[p], tuple(s))), specs)
    assert set(out) == set(shapes)
    return out


def _port_params(arch):
    with FakeTensorMode():
        return M.init_params(torch.Generator().manual_seed(0), get_config(arch), "cpu")


def _ref_params(arch):
    cfg = jax_get_config(arch)
    return cfg, jax.eval_shape(
        lambda: jmodel.init_params(jax.random.PRNGKey(0), cfg, dtype=jnp.bfloat16))


@pytest.mark.parametrize("sizes", [SIZES, SIZES_MP], ids=["16x16", "2x16x16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_equal_the_references_leaf_for_leaf(arch, sizes):
    jcfg, jshapes = _ref_params(arch)
    ref = _flat_ref(jshapes, jsharding.param_specs(jshapes, jcfg, _abstract_mesh(sizes)))
    params = _port_params(arch)
    ours = _flat_port(params, param_specs(params, get_config(arch), sizes))
    assert ours == ref


@pytest.mark.parametrize("arch", ARCHS)
def test_every_rule_names_a_leaf_of_the_ports_tree(arch):
    """The rules match the port's paths: the big matrices are not left
    replicated by a path the table does not know (as the reference's
    ``test_param_specs_shard_the_big_tensors``)."""
    params = _port_params(arch)
    specs = param_specs(params, get_config(arch), SIZES)
    big = []
    flat = _flat_port(params, specs)
    for path, (shape, spec) in flat.items():
        dims = sorted(shape)[-2:]
        if len(shape) >= 2 and dims[0] * dims[1] >= 1 << 20 and all(s is None for s in spec):
            big.append(path)
    # the reference replicates exactly these (its own test covers three archs)
    jcfg, jshapes = _ref_params(arch)
    ref = _flat_ref(jshapes, jsharding.param_specs(jshapes, jcfg, _abstract_mesh(SIZES)))
    assert big == [p for p, (shape, spec) in ref.items() if p in big]
    if arch in ("yi-6b", "qwen3-moe-30b-a3b", "rwkv6-7b"):
        assert not big, big
    assert rule_kind("layers/attn/wq") == "col" and rule_kind("final_norm") == "repl"


def _states(arch, cfg, jcfg, batch):
    with FakeTensorMode():
        ours = [M.init_decode_state(cfg, batch, 1024, torch.bfloat16, "cpu", num_frames=64)]
        if arch in PAGED:
            ours.append(M.init_paged_decode_state(cfg, batch, 1 + batch * 64, 16, 64,
                                                  torch.bfloat16, "cpu"))
    refs = [jax.eval_shape(lambda: jmodel.init_decode_state(jcfg, batch, 1024, jnp.bfloat16,
                                                            num_frames=64))]
    if arch in PAGED:
        refs.append(jax.eval_shape(lambda: jmodel.init_paged_decode_state(
            jcfg, batch, 1 + batch * 64, 16, 64, jnp.bfloat16)))
    return ours, refs


@pytest.mark.parametrize("batch", [128, 1, 24])
@pytest.mark.parametrize("arch", ARCHS)
def test_state_specs_equal_the_references_for_every_family(arch, batch):
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    ours, refs = _states(arch, cfg, jcfg, batch)
    for sizes in (SIZES, SIZES_MP):
        mesh = _abstract_mesh(sizes)
        for state, jstate in zip(ours, refs, strict=True):
            ref = _flat_ref(jstate, jsharding.state_specs(jstate, jcfg, mesh, batch))
            assert _flat_port(state, state_specs(state, cfg, sizes, batch)) == ref


@pytest.mark.parametrize("batch", [1, 8, 128])
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_spec_and_its_batch1_fallback_equal_the_references(arch, batch):
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    for sizes in (SIZES, SIZES_MP):
        mesh = _abstract_mesh(sizes)
        for fallback in (True, False):
            assert tuple(cache_spec(sizes, cfg, batch, seq_axis_fallback=fallback)) == \
                tuple(jsharding.cache_spec(mesh, jcfg, batch, seq_axis_fallback=fallback))
        assert tuple(batch_spec(sizes, 2)) == tuple(jsharding.batch_spec(mesh, 2))


def test_cache_spec_batch1_falls_back_to_sequence():
    cfg = get_config("yi-6b")   # kv=4, not divisible by 16
    assert cache_spec(SIZES, cfg, batch=1)[2] is not None      # slots dim sharded
    assert cache_spec(SIZES, cfg, batch=128)[1] is not None    # batch sharded


def test_multipod_batch_axes_compose():
    params = _port_params("yi-6b")
    specs = param_specs(params, get_config("yi-6b"), SIZES_MP)
    assert specs["layers"]["attn"]["wq"][1] == ("pod", "data")
    assert specs["layers"]["attn"]["wq"] == Spec(None, ("pod", "data"), "model")


def test_moe_experts_sharded_on_model():
    params = _port_params("qwen3-moe-235b-a22b")
    specs = param_specs(params, get_config("qwen3-moe-235b-a22b"), SIZES)
    assert specs["layers"]["moe"]["w_gate"][1] == "model"


def test_specs_are_leaves_of_the_tree_walk():
    tree = {"a": Spec(None, "data"), "b": [Spec(), Spec("model")]}
    seen = []
    tree_map_with_path(lambda p, s: seen.append((p, s)), tree)
    assert seen == [("a", Spec(None, "data")), ("b/0", Spec()), ("b/1", Spec("model"))]
