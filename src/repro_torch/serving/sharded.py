"""Sharded serving execution: gateway batches on a serving mesh.

Port of ``repro.serving.sharded``. Params are placed once through
``distributed.sharding.param_specs`` (the Megatron + FSDP table training
uses) as DTensors (``distribute_tensor`` with ``Shard(d)`` or
``Replicate()`` on each mesh axis, from the spec), and each gateway batch
is split along the composed data axes before dispatch, so the samplers run
unchanged: torch's DTensor dispatch propagates the placements through every
op and inserts the collectives where the reference's jit lowers GSPMD ones.
The hand-written kernels read raw pointers, so each kernel entry hands a
DTensor to its kernel through ``local_map`` (``kernels/dtensor.py``): the
kernel runs on every rank's local shard. When the padded bucket does not
divide the data-axis size the batch is replicated instead (correct, not
data-parallel).

No mesh -> nothing here runs (the ``Gateway(mesh=None)`` default).
"""
from __future__ import annotations

import contextlib

from repro_torch.distributed.sharding import Spec, param_specs, state_specs, tree_map_with_path
from repro_torch.launch.mesh import batch_axes


def check_mesh(mesh) -> None:
    """Refuse a ``mesh=`` that is not a ``DeviceMesh`` with a "model" axis
    and the batch axes ("data", or "pod" and "data")."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is None or "model" not in names or "data" not in names:
        raise TypeError(f"mesh= takes a torch DeviceMesh with ('data', 'model') or "
                        f"('pod', 'data', 'model') axes (repro_torch.launch.mesh), got "
                        f"{type(mesh).__name__} with axes {names}")


def scope(mesh):
    """The context a mesh dispatch runs in: torch's ``implicit_replication``
    (a plain tensor the model makes beside DTensor weights — a time step, a
    position table, a solver coefficient — counts as replicated, as jit's
    constants do), or nothing without a mesh."""
    if mesh is None:
        return contextlib.nullcontext()
    from torch.distributed.tensor.experimental import implicit_replication

    return implicit_replication()


def placements_for(mesh, spec: Spec) -> list:
    """The DTensor placements of ``spec`` on ``mesh``: ``Shard(d)`` on every
    mesh axis of more than one rank that tensor dim d names (a tuple entry
    composes its axes in order, as the reference's), ``Replicate()`` on the
    rest. Splitting over one rank is the whole tensor either way, and
    DTensor's propagation would refuse to view away a split dim of extent
    one (a batch of one row), so a one-rank axis replicates."""
    from torch.distributed.tensor import Replicate, Shard

    out = []
    for i, axis in enumerate(mesh.mesh_dim_names):
        dims = [d for d, entry in enumerate(spec)
                if entry == axis or (isinstance(entry, tuple) and axis in entry)]
        out.append(Shard(dims[0]) if dims and mesh.size(i) > 1 else Replicate())
    return out


def place(x, mesh, spec: Spec):
    """``x`` as a DTensor on ``mesh`` laid out by ``spec`` (a DTensor already
    there is redistributed)."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    placements = placements_for(mesh, spec)
    if isinstance(x, DTensor):
        return x.redistribute(mesh, placements)
    # every rank holds the whole value (the same seed draws the same weights,
    # the same requests assemble the same batch): each keeps its own shard
    # of it and nothing is scattered, as a device_put from the host does
    return distribute_tensor(x, mesh, placements, src_data_rank=None)


def _data_axes(mesh):
    axes = batch_axes(mesh)
    size = 1
    for a in axes:
        size *= mesh.shape[mesh.mesh_dim_names.index(a)]
    return (axes if len(axes) > 1 else axes[0]), size


def _placed(tree, specs, mesh):
    flat_specs = {}
    tree_map_with_path(lambda p, s: flat_specs.__setitem__(p, s), specs)
    return tree_map_with_path(lambda p, x: place(x, mesh, flat_specs[p]), tree)


def shard_params(params, cfg, mesh):
    """A backbone param tree placed on ``mesh`` by the serving/training rules."""
    return _placed(params, param_specs(params, cfg, mesh), mesh)


def shard_sampler(sampler, mesh):
    """Re-place a ``FlowSampler``/``AnytimeFlowSampler``'s params on the
    mesh, in place; its programs are keyed anew on the placed layout."""
    from repro_torch.serving.programs import ProgramCache

    check_mesh(mesh)
    sampler.params = shard_params(sampler.params, sampler.cfg, mesh)
    sampler.programs = ProgramCache(sampler.device)
    return sampler


def place_decode_state(state, cfg, mesh):
    """A slot-batched decode state (dense ``KVCache``, ``PagedKVCache`` or a
    recurrent state) placed on ``mesh`` by ``state_specs``: paged pools
    shard their KV heads on ``model``, the block table and per-row
    positions stay replicated."""
    index = state.index
    # a per-row index has the batch; a scalar one (every row at one
    # position) leaves it to the first leaf, (L, B, ...) in every state kind
    batch = int(index.shape[0]) if index.dim() else int(state[0].shape[1])
    return _placed(state, state_specs(state, cfg, mesh, batch), mesh)


def _batch_spec(shape, axes, size) -> Spec:
    return Spec(axes if shape[0] % size == 0 else None, *(None,) * (len(shape) - 1))


def _place_cond(place_one, cond, x0):
    x0 = place_one(x0)
    if cond is not None:
        cond = {k: place_one(v) if getattr(v, "ndim", 0) else v for k, v in cond.items()}
    return cond, x0


def batch_placer(mesh):
    """A ``place(cond, x0) -> (cond, x0)`` callable sharding batch tensors
    along the data axes (leading dim), replicating when indivisible."""
    axes, size = _data_axes(mesh)

    def place_one(x):
        return place(x, mesh, _batch_spec(tuple(x.shape), axes, size))

    return lambda cond, x0: _place_cond(place_one, cond, x0)


def tier_placer(mesh, ladder):
    """``batch_placer`` specialised to a ``ShapeLadder``: every dispatch
    shape is (bucket, rung, *tail) for a configured rung, so each shape's
    placements are built once and cached. The cache admits only shapes
    whose position axis is a configured rung, so it is bounded by buckets x
    rungs whatever the traffic; off-ladder shapes place uncached."""
    from torch.distributed.tensor import distribute_tensor

    axes, size = _data_axes(mesh)
    rungs = frozenset(ladder.rungs)
    cache: dict = {}

    def place_one(x):
        shape = tuple(x.shape)
        if len(shape) >= 2 and shape[1] in rungs:
            p = cache.get(shape)
            if p is None:
                p = cache[shape] = placements_for(mesh, _batch_spec(shape, axes, size))
            return distribute_tensor(x, mesh, p, src_data_rank=None)
        return place(x, mesh, _batch_spec(shape, axes, size))

    place_fn = lambda cond, x0: _place_cond(place_one, cond, x0)  # noqa: E731
    place_fn.cache = cache
    return place_fn


def carry_placer(mesh):
    """A ``place(carry) -> carry`` callable re-placing the continuous
    engine's slot-batched carry after a join scatters new rows: ``x0``/``x``
    along the data axes on the slot dim, ``U`` on its slot dim (axis 1),
    replicating when the slot count does not divide the data-axis size."""
    axes, size = _data_axes(mesh)

    def place_axis(x, dim):
        spec = [None] * x.ndim
        if x.shape[dim] % size == 0:
            spec[dim] = axes
        return place(x, mesh, Spec(*spec))

    def place_carry(carry):
        return carry._replace(x0=place_axis(carry.x0, 0), U=place_axis(carry.U, 1),
                              x=place_axis(carry.x, 0))

    return place_carry


def serving_mesh(name: str, device="cuda"):
    """CLI mesh selection: 'none' -> None, 'host' -> the 1 x 1 mesh of this
    process (always built; on the card a failure raises), 'production' /
    'multipod' -> ``launch.mesh`` shapes, falling back to None with a
    warning where the ranks are missing."""
    if name in (None, "none"):
        return None
    from repro_torch.launch import mesh as mesh_mod

    if name == "host":
        return mesh_mod.make_host_mesh(device)
    try:
        if name == "production":
            return mesh_mod.make_production_mesh(device=device)
        if name == "multipod":
            return mesh_mod.make_production_mesh(multi_pod=True, device=device)
    except Exception as e:
        print(f"WARNING: cannot build {name!r} mesh ({e}); "
              "falling back to single-device jit")
        return None
    raise ValueError(f"unknown mesh {name!r}; choose none|host|production|multipod")
