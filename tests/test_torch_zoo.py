"""The port's SolverZoo (``repro_torch.serving.zoo``) on the CPU: the 16
cases of ``tests/test_zoo.py`` (hit/miss/eviction accounting, directory-scan
loading, the cache contract that a hit performs zero distillation, spill),
and a zoo directory the reference wrote, served by the port with no
distillation. The field is the two-moons mixture of ``tests/test_bns.py``.
"""
import numpy as np
import pytest
import torch

from repro_torch.checkpoint import checkpointer
from repro_torch.core import schedulers, toy
from repro_torch.serving import SolverZoo
from repro_torch.solvers import SolverArtifact, SolverSpec


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Many tiny eager ops a test: one intra-op thread beside the other test
    workers (as the distillation test files do)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def field():
    sched = schedulers.fm_ot()
    return toy.mixture_field(sched, toy.two_moons_means(),
                             torch.full((16,), 0.15), torch.ones((16,)))


@pytest.fixture(scope="module")
def val_pairs():
    x0 = torch.from_numpy(np.random.default_rng(0).standard_normal((16, 2)).astype(np.float32))
    return x0, torch.zeros_like(x0)


class CountingDistiller:
    """Stub distiller with a call counter — baseline mode, so it is cheap."""

    def __init__(self, field, val_pairs):
        self.field = field
        self.val_pairs = val_pairs
        self.calls = 0

    def __call__(self, spec: SolverSpec) -> SolverArtifact:
        self.calls += 1
        return spec.distill(self.field, None, self.val_pairs).artifact()


@pytest.fixture
def distiller(field, val_pairs):
    return CountingDistiller(field, val_pairs)


def test_hit_skips_distillation_entirely(distiller):
    zoo = SolverZoo(capacity=4, distill_fn=distiller)
    spec = SolverSpec("euler", 4)
    a1 = zoo.get(spec)
    assert (zoo.stats.misses, zoo.stats.distills, distiller.calls) == (1, 1, 1)
    a2 = zoo.get(spec)
    assert a2 is a1                              # the very same object
    assert zoo.stats.hits == 1
    assert distiller.calls == 1                  # a hit distills NOTHING
    # an equal-but-not-identical spec is still a hit (keying is by value)
    assert zoo.get(SolverSpec("euler", 4)) is a1
    assert distiller.calls == 1


def test_distinct_specs_are_distinct_entries(distiller):
    zoo = SolverZoo(capacity=4, distill_fn=distiller)
    zoo.get(SolverSpec("euler", 4))
    zoo.get(SolverSpec("euler", 8))
    zoo.get(SolverSpec("midpoint", 4))
    assert len(zoo) == 3 and distiller.calls == 3


def test_lru_eviction(distiller):
    zoo = SolverZoo(capacity=2, distill_fn=distiller)
    a, b, c = (SolverSpec("euler", n) for n in (2, 4, 8))
    zoo.get(a)
    zoo.get(b)
    zoo.get(a)                  # refresh a: b is now least-recently used
    zoo.get(c)                  # evicts b
    assert zoo.stats.evictions == 1
    assert b not in zoo and a in zoo and c in zoo
    zoo.get(b)                  # re-distilled after eviction
    assert distiller.calls == 4


def test_directory_scan_loads_without_distilling(field, val_pairs, tmp_path,
                                                 distiller):
    specs = [SolverSpec("euler", 4), SolverSpec("midpoint", 8),
             SolverSpec("midpoint", mode="anytime", budgets=(2, 4))]
    for i, spec in enumerate(specs):
        if spec.mode == "anytime":
            from repro_torch.core.anytime import init_anytime

            art = SolverArtifact(spec=spec,
                                 params=init_anytime(field, spec.budgets),
                                 val_psnr=0.0)
        else:
            art = spec.distill(field, None, val_pairs).artifact()
        art.save(str(tmp_path / f"solver_{i}.msgpack"))
    # distractors: a non-artifact msgpack and a non-msgpack file
    checkpointer.save(str(tmp_path / "raw.msgpack"), {"w": torch.zeros((2,))})
    (tmp_path / "notes.txt").write_text("not a solver")

    zoo = SolverZoo(capacity=4, distill_fn=distiller)
    assert zoo.scan(str(tmp_path)) == 3
    for spec in specs:
        art = zoo.get(spec)
        assert art.spec == spec
    assert zoo.stats.loads == 3
    assert zoo.stats.distills == 0 and distiller.calls == 0
    assert zoo.get(specs[2]).kind == "anytime"   # second get: memory hit
    assert zoo.stats.hits == 1


def test_scan_missing_directory_is_empty():
    assert SolverZoo().scan("/nonexistent/zoo/dir") == 0


def test_get_without_distiller_raises(field, val_pairs):
    zoo = SolverZoo()
    with pytest.raises(KeyError):
        zoo.get(SolverSpec("euler", 4))
    # ... unless the call supplies what SolverSpec.distill needs
    art = zoo.get(SolverSpec("euler", 4), field=field, val_pairs=val_pairs)
    assert art.spec == SolverSpec("euler", 4)
    assert zoo.stats.distills == 1


def test_distiller_spec_mismatch_rejected(field, val_pairs):
    rogue = SolverSpec("midpoint", 8)

    def bad_distill(spec):
        return rogue.distill(field, None, val_pairs).artifact()

    zoo = SolverZoo(distill_fn=bad_distill)
    with pytest.raises(ValueError):
        zoo.get(SolverSpec("euler", 4))


def test_save_dir_persists_across_zoos(field, val_pairs, tmp_path, distiller):
    zoo1 = SolverZoo(distill_fn=distiller, save_dir=str(tmp_path))
    spec = SolverSpec("euler", 4)
    zoo1.get(spec)
    assert distiller.calls == 1
    # a fresh process scanning the same dir never re-distills
    zoo2 = SolverZoo(distill_fn=distiller, scan_dirs=(str(tmp_path),))
    art = zoo2.get(spec)
    assert art.spec == spec
    assert zoo2.stats.loads == 1 and distiller.calls == 1


def test_save_dir_never_collides_specs(field, val_pairs, tmp_path, distiller):
    """Specs differing only in cfg_scale/sigma0 get distinct files, and a
    re-get after eviction loads the RIGHT artifact (regression: one shared
    filename let the last save shadow every other spec)."""
    a = SolverSpec("euler", 4, cfg_scale=0.0)
    b = SolverSpec("euler", 4, cfg_scale=2.0)
    zoo = SolverZoo(capacity=1, distill_fn=distiller, save_dir=str(tmp_path))
    zoo.get(a)
    zoo.get(b)                  # evicts a from memory; both now on disk
    assert len(list(tmp_path.glob("*.msgpack"))) == 2
    art = zoo.get(a)            # must come back from a's own file
    assert art.spec == a
    assert zoo.stats.loads == 1 and distiller.calls == 2


def test_stale_disk_file_is_not_served(field, val_pairs, tmp_path, distiller):
    """A scanned file that no longer holds the indexed spec is re-distilled,
    never served wrong."""
    spec = SolverSpec("euler", 4)
    spec.distill(field, None, val_pairs).artifact().save(
        str(tmp_path / "s.msgpack"))
    zoo = SolverZoo(distill_fn=distiller, scan_dirs=(str(tmp_path),))
    # overwrite the file with a different solver behind the zoo's back
    SolverSpec("midpoint", 8).distill(field, None, val_pairs).artifact() \
        .save(str(tmp_path / "s.msgpack"))
    art = zoo.get(spec)
    assert art.spec == spec
    assert zoo.stats.loads == 0 and zoo.stats.distills == 1


def test_capacity_validation():
    with pytest.raises(ValueError):
        SolverZoo(capacity=0)


def test_preload_warm_starts_top_specs(distiller):
    """Boot-time warm start: preload resolves every spec once; later gets
    are pure memory hits (zero loads, zero distills)."""
    zoo = SolverZoo(capacity=4, distill_fn=distiller)
    specs = [SolverSpec("euler", 2), SolverSpec("euler", 4)]
    arts = zoo.preload(specs)
    assert [a.spec for a in arts] == specs
    assert distiller.calls == 2
    for spec in specs:
        zoo.get(spec)
    assert zoo.stats.hits == 2 and distiller.calls == 2


def test_preload_respects_capacity(distiller):
    """Preloading past capacity would self-evict; only the first k load."""
    notes = []
    zoo = SolverZoo(capacity=2, distill_fn=distiller)
    arts = zoo.preload([SolverSpec("euler", n) for n in (2, 4, 8)],
                       log=notes.append)
    assert len(arts) == 2 and len(zoo) == 2
    assert distiller.calls == 2 and zoo.stats.evictions == 0
    assert any("first 2 of 3" in n for n in notes)


def test_eviction_spills_to_save_dir(field, val_pairs, tmp_path):
    """ROADMAP open item: an evicted artifact is saved to save_dir instead
    of being dropped, and a later get LOADS it (no re-distillation) even
    with no distiller at all."""
    a = SolverSpec("euler", 2).distill(field, None, val_pairs).artifact()
    b = SolverSpec("euler", 4).distill(field, None, val_pairs).artifact()
    zoo = SolverZoo(capacity=1, save_dir=str(tmp_path))
    zoo.put(a)
    assert list(tmp_path.glob("*.msgpack")) == []   # in cache: nothing spilled
    zoo.put(b)                                      # evicts a -> spills it
    assert zoo.stats.evictions == 1 and zoo.stats.spills == 1
    assert len(list(tmp_path.glob("*.msgpack"))) == 1
    art = zoo.get(a.spec)                           # loads the spilled file
    assert art.spec == a.spec
    assert zoo.stats.loads == 1 and zoo.stats.distills == 0


def test_eviction_does_not_respill_already_saved(field, val_pairs, tmp_path,
                                                 distiller):
    """An artifact the zoo already persisted (distill-save or prior spill)
    is not written twice on eviction."""
    zoo = SolverZoo(capacity=1, distill_fn=distiller, save_dir=str(tmp_path))
    zoo.get(SolverSpec("euler", 2))                 # distilled AND saved
    zoo.get(SolverSpec("euler", 4))                 # evicts the saved one
    assert zoo.stats.evictions == 1 and zoo.stats.spills == 0
    assert len(list(tmp_path.glob("*.msgpack"))) == 2


def test_refreshed_put_spills_fresh_artifact_not_stale_file(field, val_pairs,
                                                            tmp_path,
                                                            distiller):
    """Regression: put() of an UPDATED artifact for an already-saved spec
    must not let eviction trust the stale file — the refresh is spilled and
    the next get serves the new parameters."""
    import dataclasses

    zoo = SolverZoo(capacity=1, distill_fn=distiller, save_dir=str(tmp_path))
    spec = SolverSpec("euler", 2)
    old = zoo.get(spec)                             # distilled AND saved
    zoo.put(dataclasses.replace(old, val_psnr=42.0))   # refreshed in memory
    zoo.get(SolverSpec("euler", 4))                 # evicts the refresh
    assert zoo.stats.spills == 1                    # ... which was spilled
    art = zoo.get(spec)                             # loads the SPILLED copy
    assert art.val_psnr == 42.0
    assert zoo.stats.loads == 1 and distiller.calls == 2


def test_reference_zoo_dir_is_served_without_distilling(tmp_path, distiller):
    """A directory the reference's SolverZoo wrote (save on distill, spill on
    eviction) is indexed and loaded by the port's zoo under the same file
    names, with bit-equal parameters and no distillation; a reference BST
    artifact beside them (skipped before the port had BST) is indexed and
    loaded as what it is, a ``bst`` artifact."""
    import jax
    import jax.numpy as jnp

    from repro.core import bst_solver
    from repro.core import schedulers as jsched
    from repro.core import toy as jtoy
    from repro.serving import SolverZoo as JaxZoo
    from repro.solvers import SolverArtifact as JaxArtifact
    from repro.solvers import SolverSpec as JaxSpec

    jfield = jtoy.mixture_field(jsched.fm_ot(), jtoy.two_moons_means(),
                                jnp.full((16,), 0.15), jnp.ones((16,)))
    jval = (jnp.asarray(np.random.default_rng(0).standard_normal((16, 2)), jnp.float32),
            jnp.zeros((16, 2)))
    ref = JaxZoo(capacity=1, save_dir=str(tmp_path),
                 distill_fn=lambda s: s.distill(jfield, None, jval).artifact())
    jspecs = [JaxSpec("euler", 4), JaxSpec("midpoint", 4, cfg_scale=1.5)]
    ref_arts = [ref.get(s) for s in jspecs]
    from repro.core.anytime import init_anytime as jinit

    any_spec = JaxSpec("midpoint", mode="anytime", budgets=(2, 4))
    ref_arts.append(ref.put(JaxArtifact(spec=any_spec, params=jinit(None, (2, 4)),
                                        val_psnr=0.0)))
    ref.get(jspecs[0])                              # evicts the anytime one: a spill
    k = bst_solver.knot_positions(4, "euler").shape[0]
    bst_spec = JaxSpec("euler", 4, mode="bst")
    ref_arts.append(JaxArtifact(spec=bst_spec, val_psnr=0.0, params=bst_solver.BSTParams(
        *(jnp.linspace(-1.0, 1.0, n) for n in (k - 1, k, k, k)))))
    ref_arts[-1].save(str(tmp_path / "bst.msgpack"))
    assert ref.stats.spills == 1 and len(list(tmp_path.glob("*.msgpack"))) == 4

    zoo = SolverZoo(capacity=4, distill_fn=distiller, scan_dirs=(str(tmp_path),))
    for jspec, jart in zip(jspecs + [any_spec, bst_spec], ref_arts):
        spec = SolverSpec.from_dict(jspec.to_dict())
        assert SolverZoo._filename(spec) == JaxZoo._filename(jspec)
        art = zoo.get(spec)
        assert art.spec == spec and art.kind == jart.kind
        for a, b in zip(art.params, jax.tree.leaves(jart.params)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert (zoo.stats.loads, zoo.stats.distills, distiller.calls) == (4, 0, 0)


def test_load_serves_a_named_file_as_a_load(field, val_pairs, tmp_path, distiller):
    """``load(path)`` (the launcher's --solver-artifact): a miss served by a
    load, cached under the file's own spec, so a later get is a hit."""
    spec = SolverSpec("midpoint", 4)
    spec.distill(field, None, val_pairs).artifact().save(str(tmp_path / "named.msgpack"))
    zoo = SolverZoo(distill_fn=distiller)
    art = zoo.load(str(tmp_path / "named.msgpack"))
    assert art.spec == spec
    assert (zoo.stats.misses, zoo.stats.loads, zoo.stats.distills) == (1, 1, 0)
    assert zoo.get(spec) is art and zoo.stats.hits == 1 and distiller.calls == 0
