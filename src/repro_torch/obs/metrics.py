"""Labeled counter/gauge/histogram registry (port of
``repro.obs.metrics``, pure Python, copied as it stands).

The metrics half of the telemetry substrate: spans answer *where did
this run's wall clock go*, metrics answer *what has the process done so
far* — requests served, compiles triggered, bytes moved, rungs fired.
Prometheus-shaped on purpose (monotonic counters, labeled families,
text exposition) so the serve engine's ``stats()`` can be scraped
without an adapter, but in-process and dependency-free.

Two usage patterns:

  * **library-wide** — module singleton :data:`DEFAULT`; low layers
    (grblas dispatch, solver registry compile marks, recovery rungs,
    fault injectors) increment it unconditionally.  A counter bump is a
    dict lookup + float add; there is no disabled/enabled switch to
    keep hot paths honest.
  * **per-component** — the serve engine owns a private
    ``MetricsRegistry`` shared with its ``WarmCache``, so per-engine
    tests see isolated counts and ``EngineStats`` fields become *views*
    over the registry instead of a second set of books.

``snapshot()`` flattens everything to ``{"name{k=v}": float}``;
``delta(prev)`` subtracts snapshots (counters/histograms subtract,
gauges report current) — the unit tests and the retrace accounting in
the benches are written against deltas, never absolute values.
"""
from __future__ import annotations

import math
import threading
from typing import Dict, List, Optional, Tuple

_DEFAULT_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
                    0.25, 0.5, 1.0, 2.5, 5.0, 10.0)


def _label_key(labels: Dict[str, str]) -> Tuple[Tuple[str, str], ...]:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def _label_str(key: Tuple[Tuple[str, str], ...]) -> str:
    if not key:
        return ""
    return "{" + ",".join(f'{k}="{v}"' for k, v in key) + "}"


class Counter:
    """Monotonic counter.  ``inc`` only; negative increments raise."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError("counters are monotonic; inc() must be >= 0")
        self.value += amount


class Gauge:
    """Point-in-time value (queue depth, cache size)."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def set(self, value: float) -> None:
        self.value = float(value)

    def inc(self, amount: float = 1.0) -> None:
        self.value += amount

    def dec(self, amount: float = 1.0) -> None:
        self.value -= amount


class Histogram:
    """Cumulative-bucket histogram (Prometheus semantics: bucket ``le``
    counts include everything below)."""

    __slots__ = ("bounds", "bucket_counts", "count", "sum")

    def __init__(self, bounds=_DEFAULT_BUCKETS):
        self.bounds = tuple(float(b) for b in bounds)
        if list(self.bounds) != sorted(self.bounds):
            raise ValueError("histogram bounds must be sorted ascending")
        self.bucket_counts = [0] * (len(self.bounds) + 1)  # +inf tail
        self.count = 0
        self.sum = 0.0

    def observe(self, value: float) -> None:
        v = float(value)
        self.count += 1
        self.sum += v
        for i, b in enumerate(self.bounds):
            if v <= b:
                self.bucket_counts[i] += 1
                return
        self.bucket_counts[-1] += 1

    def cumulative(self) -> List[Tuple[float, int]]:
        out, running = [], 0
        for b, c in zip(self.bounds, self.bucket_counts):
            running += c
            out.append((b, running))
        out.append((math.inf, self.count))
        return out


class MetricsRegistry:
    """Get-or-create families of labeled instruments.

    A (name, labelset) pair maps to one instrument; asking for the same
    name with a different instrument type is a programming error and
    raises immediately rather than silently forking the family.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[str, Dict[Tuple[Tuple[str, str], ...], object]] = {}
        self._types: Dict[str, type] = {}
        self._buckets: Dict[str, Tuple[float, ...]] = {}

    def _get(self, kind: type, name: str, labels: Dict[str, str],
             buckets=None):
        with self._lock:
            have = self._types.get(name)
            if have is None:
                self._types[name] = kind
                self._metrics[name] = {}
                if kind is Histogram:
                    self._buckets[name] = tuple(buckets or _DEFAULT_BUCKETS)
            elif have is not kind:
                raise TypeError(
                    f"metric {name!r} already registered as {have.__name__}, "
                    f"requested as {kind.__name__}")
            key = _label_key(labels)
            fam = self._metrics[name]
            inst = fam.get(key)
            if inst is None:
                inst = (Histogram(self._buckets[name]) if kind is Histogram
                        else kind())
                fam[key] = inst
            return inst

    def counter(self, name: str, **labels) -> Counter:
        return self._get(Counter, name, labels)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get(Gauge, name, labels)

    def histogram(self, name: str, buckets=None, **labels) -> Histogram:
        return self._get(Histogram, name, labels, buckets=buckets)

    # ------------------------------------------------------------- queries

    def family(self, name: str) -> Dict[Tuple[Tuple[str, str], ...], object]:
        """All instruments registered under ``name`` (empty if none)."""
        return dict(self._metrics.get(name, {}))

    def value(self, name: str, **labels) -> float:
        """Current value of a counter/gauge, 0.0 if never touched (so
        back-compat stat views don't materialize empty instruments)."""
        fam = self._metrics.get(name)
        if not fam:
            return 0.0
        inst = fam.get(_label_key(labels))
        return float(inst.value) if inst is not None else 0.0

    def total(self, name: str) -> float:
        """Sum over every labelset of a counter/gauge family."""
        return float(sum(i.value for i in self._metrics.get(name, {}).values()))

    def labeled_values(self, name: str, label: str) -> Dict[str, float]:
        """{label-value: metric-value} for one label dimension of a
        family — e.g. ``labeled_values("serve_failed_total", "kind")``
        reconstructs the old ``EngineStats.failures`` dict."""
        out: Dict[str, float] = {}
        for key, inst in self._metrics.get(name, {}).items():
            d = dict(key)
            if label in d:
                out[d[label]] = out.get(d[label], 0.0) + inst.value
        return out

    # ----------------------------------------------------- snapshot / delta

    def snapshot(self) -> Dict[str, float]:
        """Flat ``{"name{k=v}": value}``; histograms expand to
        ``_count`` / ``_sum`` / ``_bucket{le=..}`` series."""
        out: Dict[str, float] = {}
        with self._lock:
            for name, fam in self._metrics.items():
                kind = self._types[name]
                for key, inst in fam.items():
                    ls = _label_str(key)
                    if kind is Histogram:
                        out[f"{name}_count{ls}"] = float(inst.count)
                        out[f"{name}_sum{ls}"] = float(inst.sum)
                        for le, c in inst.cumulative():
                            les = "+Inf" if math.isinf(le) else repr(le)
                            lk = _label_key(dict(key, le=les))
                            out[f"{name}_bucket{_label_str(lk)}"] = float(c)
                    else:
                        out[f"{name}{ls}"] = float(inst.value)
        return out

    def delta(self, prev: Dict[str, float]) -> Dict[str, float]:
        """Snapshot minus ``prev``, dropping zero entries: what happened
        since.  Gauges subtract too — a gauge delta reads as net
        movement, which is what the serve benches chart."""
        now = self.snapshot()
        out = {}
        for k, v in now.items():
            d = v - prev.get(k, 0.0)
            if d != 0.0:
                out[k] = d
        return out

    # ------------------------------------------------------------ exposition

    def exposition(self) -> str:
        """Prometheus text format (``# TYPE`` headers + one line per
        series), newline-terminated."""
        lines: List[str] = []
        with self._lock:
            for name in sorted(self._metrics):
                kind = self._types[name]
                tname = {"Counter": "counter", "Gauge": "gauge",
                         "Histogram": "histogram"}[kind.__name__]
                lines.append(f"# TYPE {name} {tname}")
                for key in sorted(self._metrics[name]):
                    inst = self._metrics[name][key]
                    ls = _label_str(key)
                    if kind is Histogram:
                        for le, c in inst.cumulative():
                            les = "+Inf" if math.isinf(le) else repr(le)
                            lk = _label_key(dict(key, le=les))
                            lines.append(
                                f"{name}_bucket{_label_str(lk)} {c}")
                        lines.append(f"{name}_sum{ls} {inst.sum}")
                        lines.append(f"{name}_count{ls} {inst.count}")
                    else:
                        v = inst.value
                        sv = repr(int(v)) if float(v).is_integer() else repr(v)
                        lines.append(f"{name}{ls} {sv}")
        return "\n".join(lines) + ("\n" if lines else "")


# Library-wide registry: low-layer instruments (grblas dispatch, solver
# compiles, recovery rungs, fault injections) land here.
DEFAULT = MetricsRegistry()


def default() -> MetricsRegistry:
    return DEFAULT
