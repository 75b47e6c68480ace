"""Warm-start cache of the clustering serve engine (port of
``repro.serve.warm_cache``).

An LRU keyed on the graph's :class:`~repro_torch.grblas.containers.
GraphFingerprint` — (n, nnz, pattern digest, quantized-weight digest) —
with three tiers:

  * ``exact``   — same pattern and same quantized weights: the engine
    re-enters the solver at the schedule tail from the cached U (one
    cheap level), skipping the p=2 eigensolve and the descent;
  * ``pattern`` — same pattern, other weights (a reweighted graph): the
    cached U warm-starts the solve on the new weights, the cached labels
    are not reused;
  * miss        — a cold solve.

An entry keeps the embedding where the solve left it (a tensor on the
graph's device, or an array); solo-lane entries may carry the
multilevel hierarchy, which the churn path patches instead of
rebuilding (``multilevel.coarsen.patch_hierarchy``).
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.grblas.containers import GraphFingerprint
from repro_torch.obs import metrics as _obs_metrics


@dataclasses.dataclass
class CacheEntry:
    """What a finished solve leaves for the next tenant."""

    U: object                        # (n, k) final embedding
    labels: np.ndarray               # (n,) discretized clusters
    p_final: float                   # where the continuation ended
    rcut: float
    fingerprint: GraphFingerprint
    hierarchy: object = None         # multilevel Hierarchy (solo lane)


def _finite(U) -> bool:
    if torch.is_tensor(U):
        return bool(torch.isfinite(U).all())
    return bool(np.isfinite(U).all())


class WarmCache:
    """LRU over full fingerprints with a pattern-key secondary index.

    The index maps ``fingerprint.pattern_key`` to the most recently
    stored full key with that pattern, so a same-pattern request finds
    its warm start without a scan.  Eviction is strict LRU on the
    primary map; the index never keeps an entry alive (it is repaired
    on lookup).

    The counters live in a :class:`~repro_torch.obs.metrics.
    MetricsRegistry` (the serve engine passes its own, so engine and
    cache keep one set of books); ``hits_exact`` and the rest are
    read-only views, and ``stats()`` keeps the reference's key set.
    """

    def __init__(self, capacity: int = 64, *,
                 metrics: Optional[_obs_metrics.MetricsRegistry] = None):
        if capacity < 1:
            raise ValueError("cache capacity must be >= 1")
        self.capacity = int(capacity)
        self.metrics = metrics if metrics is not None \
            else _obs_metrics.MetricsRegistry()
        self._lru: "OrderedDict[tuple, CacheEntry]" = OrderedDict()
        self._by_pattern: Dict[tuple, tuple] = {}

    @property
    def hits_exact(self) -> int:
        return int(self.metrics.value("warm_cache_hits_total", tier="exact"))

    @property
    def hits_pattern(self) -> int:
        return int(self.metrics.value("warm_cache_hits_total",
                                      tier="pattern"))

    @property
    def misses(self) -> int:
        return int(self.metrics.value("warm_cache_misses_total"))

    @property
    def evictions(self) -> int:
        return int(self.metrics.value("warm_cache_evictions_total"))

    @property
    def rejects(self) -> int:
        """Poisoned entries refused on insert."""
        return int(self.metrics.value("warm_cache_rejects_total"))

    def __len__(self) -> int:
        return len(self._lru)

    def __contains__(self, fp: GraphFingerprint) -> bool:
        return fp.key in self._lru

    def peek(self, fp: GraphFingerprint) -> Optional[CacheEntry]:
        """Exact-key lookup with no LRU refresh and no hit/miss count
        (the churn path's probe of its base graph)."""
        return self._lru.get(fp.key)

    def lookup(self, fp: GraphFingerprint
               ) -> Tuple[Optional[CacheEntry], Optional[str]]:
        """(entry, tier), tier "exact" | "pattern" | None.  Counts the
        hit or miss and refreshes the entry's recency."""
        entry = self._lru.get(fp.key)
        if entry is not None:
            self._lru.move_to_end(fp.key)
            self.metrics.counter("warm_cache_hits_total",
                                 tier="exact").inc()
            return entry, "exact"
        pkey = self._by_pattern.get(fp.pattern_key)
        if pkey is not None:
            entry = self._lru.get(pkey)
            if entry is None:                 # stale index (evicted)
                del self._by_pattern[fp.pattern_key]
            else:
                self._lru.move_to_end(pkey)
                self.metrics.counter("warm_cache_hits_total",
                                     tier="pattern").inc()
                return entry, "pattern"
        self.metrics.counter("warm_cache_misses_total").inc()
        return None, None

    def store(self, entry: CacheEntry) -> None:
        # a non-finite embedding (a diverged solve) is never handed out
        # as a warm start: refuse it and keep any earlier healthy entry
        if entry.U is None or not _finite(entry.U):
            self.metrics.counter("warm_cache_rejects_total").inc()
            return
        fp = entry.fingerprint
        self._lru[fp.key] = entry
        self._lru.move_to_end(fp.key)
        self._by_pattern[fp.pattern_key] = fp.key
        while len(self._lru) > self.capacity:
            old_key, old = self._lru.popitem(last=False)
            self.metrics.counter("warm_cache_evictions_total").inc()
            pk = old.fingerprint.pattern_key
            if self._by_pattern.get(pk) == old_key:
                del self._by_pattern[pk]
        self.metrics.gauge("warm_cache_size").set(len(self._lru))

    def stats(self) -> dict:
        return {"size": len(self._lru), "capacity": self.capacity,
                "hits_exact": self.hits_exact,
                "hits_pattern": self.hits_pattern,
                "misses": self.misses, "evictions": self.evictions,
                "rejects": self.rejects}
