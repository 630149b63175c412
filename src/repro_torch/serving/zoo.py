"""SolverZoo — a budget-aware cache of solver artifacts for serving.

Port of ``repro.serving.zoo``; its files and file names are the reference's,
so one directory serves both packages.

The zoo maps ``SolverSpec`` keys (the spec is a frozen, hashable dataclass —
the key IS the declarative solver description) to loaded ``SolverArtifact``s
with LRU eviction. A ``get`` resolves in order:

  1. memory hit — the loaded artifact, zero I/O, zero distillation;
  2. disk hit — a ``.msgpack`` artifact indexed by ``scan`` whose stored
     spec equals the requested one is loaded (no distillation);
  3. miss — the spec is distilled lazily via the zoo's ``distill_fn``
     (or ``SolverSpec.distill`` with the ``get`` call's field/pairs) and,
     when the zoo has a ``save_dir``, persisted for the next process.

``stats`` counts hits/misses/loads/distills/evictions/spills so serving can
assert the cache contract (a hit performs zero distillation) and dashboards
can watch the ratio. One anytime artifact covers every budget in its spec,
so multi-NFE serving needs exactly one entry.

Warm-start and spill (the serving-boot policy): ``preload(specs)`` resolves
the top-k specs before traffic arrives, and when the zoo has a ``save_dir``
an LRU eviction SPILLS the artifact to disk instead of dropping it, so the
next ``get`` is a load, never a re-distillation. ``load(path)`` serves one
named file (the launcher's ``--solver-artifact``) and counts it as a load.
"""
from __future__ import annotations

import dataclasses
import os
from collections import OrderedDict
from typing import Callable, Optional

from repro_torch.checkpoint import checkpointer
from repro_torch.observability import MetricsRegistry
from repro_torch.solvers.artifact import FORMAT, SolverArtifact
from repro_torch.solvers.spec import SolverSpec


@dataclasses.dataclass
class ZooStats:
    """Legacy counter bundle — a compatibility VIEW over the zoo's
    registry counters (``zoo_hits``/``zoo_misses``/...), not the store."""

    hits: int = 0          # served from memory
    loads: int = 0         # served from a scanned artifact file
    distills: int = 0      # distilled on miss
    misses: int = 0        # loads + distills
    evictions: int = 0     # LRU evictions past capacity
    spills: int = 0        # evicted artifacts saved to save_dir (not dropped)


class SolverZoo:
    """LRU cache of solver artifacts keyed by ``SolverSpec``."""

    def __init__(self, capacity: int = 8, *,
                 distill_fn: Optional[Callable[[SolverSpec], SolverArtifact]] = None,
                 scan_dirs=(), save_dir: Optional[str] = None,
                 metrics: Optional[MetricsRegistry] = None):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.capacity = capacity
        self.distill_fn = distill_fn
        self.save_dir = save_dir
        # counters live in the (possibly gateway-shared) registry so the
        # cache contract shows up in the same export as serving metrics
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self._m_hits = self.metrics.counter(
            "zoo_hits", "artifacts served from memory")
        self._m_loads = self.metrics.counter(
            "zoo_loads", "artifacts served from a scanned file")
        self._m_distills = self.metrics.counter(
            "zoo_distills", "artifacts distilled on miss")
        self._m_misses = self.metrics.counter(
            "zoo_misses", "gets not served from memory (loads + distills)")
        self._m_evictions = self.metrics.counter(
            "zoo_evictions", "LRU evictions past capacity")
        self._m_spills = self.metrics.counter(
            "zoo_spills", "evicted artifacts saved to save_dir, not dropped")
        self._cache: "OrderedDict[SolverSpec, SolverArtifact]" = OrderedDict()
        self._paths: dict[SolverSpec, str] = {}
        for d in scan_dirs:
            self.scan(d)

    @property
    def stats(self) -> ZooStats:
        """The legacy ``ZooStats`` view, built from the registry counters."""
        return ZooStats(hits=int(self._m_hits.value),
                        loads=int(self._m_loads.value),
                        distills=int(self._m_distills.value),
                        misses=int(self._m_misses.value),
                        evictions=int(self._m_evictions.value),
                        spills=int(self._m_spills.value))

    # -- disk index ---------------------------------------------------------

    def scan(self, directory: str) -> int:
        """Index saved ``.msgpack`` solver artifacts under ``directory``.

        Reads only each file's JSON meta (cheap); artifacts load lazily on
        ``get``. Non-artifact msgpack files are skipped, and so are artifacts
        of a kind the port cannot serve yet (``bst``, ROADMAP Queue A item 2).
        Returns how many artifacts were indexed.
        """
        found = 0
        if not os.path.isdir(directory):
            return 0
        for name in sorted(os.listdir(directory)):
            if not name.endswith(".msgpack"):
                continue
            path = os.path.join(directory, name)
            try:
                meta = checkpointer.load_meta(path)
            except Exception:
                continue
            if not meta or meta.get("format") != FORMAT or meta.get("kind") == "bst":
                continue
            self._paths[SolverSpec.from_dict(meta["spec"])] = path
            found += 1
        return found

    # -- cache --------------------------------------------------------------

    def __len__(self) -> int:
        return len(self._cache)

    def __contains__(self, spec: SolverSpec) -> bool:
        return spec in self._cache

    def specs(self) -> list[SolverSpec]:
        """Cached specs, least- to most-recently used."""
        return list(self._cache)

    def put(self, artifact: SolverArtifact) -> SolverArtifact:
        """Insert (or refresh) an artifact under its own spec key.

        When the insert pushes the zoo past capacity, the LRU entry is
        evicted — and, if the zoo has a ``save_dir`` and the artifact is not
        already indexed on disk, SPILLED there first instead of being
        dropped, so a later ``get`` reloads it without re-distilling.
        """
        spec = artifact.spec
        # the inserted artifact shadows any disk copy of unknown freshness:
        # drop the index entry so a later eviction spills THIS artifact
        # instead of trusting a possibly-stale file (``get`` re-links the
        # path right after its own load/save, where file == artifact holds)
        self._paths.pop(spec, None)
        if spec in self._cache:
            self._cache.move_to_end(spec)
        self._cache[spec] = artifact
        while len(self._cache) > self.capacity:
            spec_e, art_e = self._cache.popitem(last=False)
            self._m_evictions.inc()
            if self.save_dir is not None and spec_e not in self._paths:
                path = os.path.join(self.save_dir, self._filename(spec_e))
                art_e.save(path)
                self._paths[spec_e] = path
                self._m_spills.inc()
        return artifact

    def preload(self, specs, *, field=None, train_pairs=None, val_pairs=None,
                train_cfg=None, log=None) -> list[SolverArtifact]:
        """Warm-start: resolve the top-k specs (by expected traffic, caller-
        ordered) at boot so the first real request never pays a load/distill.

        Specs beyond ``capacity`` would immediately evict one another, so
        only the first ``capacity`` are resolved (with a log note). Returns
        the loaded artifacts in request order.
        """
        specs = list(specs)
        if len(specs) > self.capacity:
            if log:
                log(f"zoo: preloading only the first {self.capacity} of "
                    f"{len(specs)} specs (capacity)")
            specs = specs[:self.capacity]
        return [self.get(s, field=field, train_pairs=train_pairs,
                         val_pairs=val_pairs, train_cfg=train_cfg, log=log)
                for s in specs]

    def load(self, path: str) -> SolverArtifact:
        """The artifact in the file ``path``, whatever its spec: counted as a
        miss served by a load (no distillation), cached under its own spec
        and linked to the file."""
        art = SolverArtifact.load(path)
        self._m_misses.inc()
        self._m_loads.inc()
        art = self.put(art)
        self._paths[art.spec] = path
        return art

    def get(self, spec: SolverSpec, *, field=None, train_pairs=None,
            val_pairs=None, train_cfg=None, log=None) -> SolverArtifact:
        """The artifact for ``spec`` — cached, loaded from disk, or distilled.

        A memory or disk hit performs zero distillation; only a true miss
        trains, via ``distill_fn`` when the zoo has one, else
        ``spec.distill(field, train_pairs, val_pairs, train_cfg)``.
        """
        art = self._cache.get(spec)
        if art is not None:
            self._m_hits.inc()
            self._cache.move_to_end(spec)
            return art
        self._m_misses.inc()
        path = self._paths.get(spec)
        if path is not None and os.path.exists(path):
            art = SolverArtifact.load(path)
            if art.spec == spec:
                self._m_loads.inc()
                if log:
                    log(f"zoo: loaded {spec.mode}/{spec.name} from {path}")
                art = self.put(art)
                self._paths[spec] = path       # file == artifact, re-link
                return art
            # file changed since it was indexed — never serve the wrong solver
            del self._paths[spec]
        art = self._distill(spec, field, train_pairs, val_pairs, train_cfg,
                            log)
        art = self.put(art)
        if self.save_dir is not None:
            path = os.path.join(self.save_dir, self._filename(spec))
            art.save(path)
            self._paths[spec] = path
            if log:
                log(f"zoo: saved {path}")
        return art

    @staticmethod
    def _filename(spec: SolverSpec) -> str:
        """Readable prefix + full-spec digest: specs differing only in e.g.
        cfg_scale or sigma0 must never collide on disk."""
        import hashlib
        import json

        digest = hashlib.md5(
            json.dumps(spec.to_dict(), sort_keys=True).encode()).hexdigest()
        return f"{spec.mode}_{spec.name}_nfe{spec.nfe}_{digest[:10]}.msgpack"

    def _distill(self, spec, field, train_pairs, val_pairs, train_cfg,
                 log) -> SolverArtifact:
        if self.distill_fn is not None:
            self._m_distills.inc()
            art = self.distill_fn(spec)
        elif field is not None:
            self._m_distills.inc()
            art = spec.distill(field, train_pairs, val_pairs, train_cfg,
                               log=log).artifact()
        else:
            raise KeyError(
                f"{spec} not cached and the zoo cannot distill it (no "
                "distill_fn; pass field/train_pairs/val_pairs to get)")
        if art.spec != spec:
            raise ValueError(f"distill_fn returned artifact for {art.spec}, "
                             f"requested {spec}")
        return art
