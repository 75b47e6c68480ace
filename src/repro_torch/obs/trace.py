"""Structured span tracing (port of ``repro.obs.trace``).

A :class:`Tracer` records nested :class:`Span`s (context managers with
attributes) into a bounded in-memory buffer and exports them as
Chrome/Perfetto trace-event JSON or JSONL.  Three design rules, as in
the reference:

  * **disabled tracing is (nearly) free** — the module-level ``ACTIVE``
    tracer defaults to the :data:`NULL` singleton; hot paths do one
    attribute lookup (``trace.ACTIVE.enabled``) and branch away, or call
    ``trace.ACTIVE.span(...)`` and get the shared no-op span.  Nothing
    allocates, nothing is buffered, nothing waits for the device.
  * **clocks are fenced** — CUDA launches return before the kernels run,
    so a span that wraps device work calls ``sp.fence(value)`` before its
    exit timestamp means anything: that synchronizes the CUDA device of
    every tensor in ``value`` (CPU tensors need nothing).  Fencing is
    governed by ``TraceConfig.fence``, so the same instrumentation can
    run unfenced when the caller wants launch-side timing.
  * **clocks are injectable** — ``TraceConfig.clock`` replaces the
    monotonic clock for deterministic tests.

The buffer is bounded (``TraceConfig.capacity``): when full, new spans
and instants are counted in ``Tracer.dropped`` instead of growing
without limit.

Correlation ids: fault injectors (``repro_torch.testing.faultinject``)
call ``begin_injection``, which stamps a fresh id, and recovery-ladder
events (``core.solvers.guard``) read ``current_injection()``, so one
timeline shows which injected fault caused which recovery rung.

This module imports nothing from the rest of ``repro_torch`` (stdlib and
torch only), so the lowest layers (grblas.api, the solver registry)
import it without cycles.
"""
from __future__ import annotations

import contextlib
import dataclasses
import itertools
import json
import time
from typing import Any, Callable, Dict, List, Optional

import torch


@dataclasses.dataclass(frozen=True)
class TraceConfig:
    """Shape of one tracing session (``PSCConfig.trace`` accepts this)."""

    capacity: int = 65536        # span+event buffer bound (drop past it)
    fence: bool = True           # synchronize the device at span fences
    clock: Optional[Callable[[], float]] = None   # None = time.perf_counter


def _cuda_devices(value, out: set) -> set:
    """The CUDA devices of every tensor in ``value`` (tensors, and tuples,
    lists and dict values of them, nested)."""
    if isinstance(value, torch.Tensor):
        if value.device.type == "cuda":
            out.add(value.device)
    elif isinstance(value, (tuple, list)):
        for v in value:
            _cuda_devices(v, out)
    elif isinstance(value, dict):
        for v in value.values():
            _cuda_devices(v, out)
    return out


def block_until_ready(value):
    """Synchronize the CUDA device of every tensor in ``value`` (once a
    device), so the host clock after it covers their device work.  CPU
    tensors and other values need nothing.  Returns ``value``."""
    for dev in _cuda_devices(value, set()):
        torch.cuda.synchronize(dev)
    return value


class Span:
    """One timed region.  Context manager; reopenable attributes via
    ``set(...)``; ``fence(x)`` waits for the device work behind x so the
    exit timestamp covers the device work the span claims."""

    __slots__ = ("name", "cat", "t0", "dur", "sid", "parent", "depth",
                 "attrs", "_tracer")

    def __init__(self, tracer: "Tracer", name: str, cat: str,
                 attrs: Dict[str, Any]):
        self._tracer = tracer
        self.name = name
        self.cat = cat
        self.attrs = attrs
        self.t0 = 0.0
        self.dur = 0.0
        self.sid = 0
        self.parent: Optional[int] = None
        self.depth = 0

    def set(self, **attrs) -> "Span":
        self.attrs.update(attrs)
        return self

    def fence(self, value):
        """Wait until ``value``'s device work is done (when the session
        fences), so the span's exit time includes it.  Returns value."""
        if self._tracer._fence:
            block_until_ready(value)
        return value

    def event(self, name: str, **attrs) -> None:
        """An instant event stamped inside this span."""
        self._tracer.instant(name, **attrs)

    def __enter__(self) -> "Span":
        self._tracer._open(self)
        return self

    def __exit__(self, *exc) -> bool:
        self._tracer._close(self)
        return False


class _NullSpan:
    """The shared no-op span: every method is a cheap constant."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs):
        return self

    def fence(self, value):
        return value

    def event(self, name, **attrs):
        return None


NULL_SPAN = _NullSpan()


class NullTracer:
    """Disabled tracing: ``ACTIVE`` points here by default, so hot paths
    pay one attribute lookup (``.enabled``) or a no-op call."""

    enabled = False
    spans: List[Span] = []
    events: List[dict] = []
    dropped = 0

    def span(self, name, cat="", **attrs):
        return NULL_SPAN

    def instant(self, name, **attrs):
        return None

    def fence(self, value):
        return value


NULL = NullTracer()

# The module-level active tracer.  Hot paths read ``trace.ACTIVE``; the
# session machinery (``use`` / ``session``) swaps it.
ACTIVE = NULL


class Tracer:
    """A bounded in-memory span recorder (see module docstring)."""

    enabled = True

    def __init__(self, cfg: Optional[TraceConfig] = None):
        cfg = cfg if cfg is not None else TraceConfig()
        self.cfg = cfg
        self._clock = cfg.clock if cfg.clock is not None else time.perf_counter
        self._fence = cfg.fence
        self._capacity = int(cfg.capacity)
        self._stack: List[Span] = []
        self._seq = itertools.count(1)
        self.spans: List[Span] = []     # finished spans, exit order
        self.events: List[dict] = []    # instant events
        self.dropped = 0
        self.t_start = self._clock()

    # ------------------------------------------------------------- recording

    def span(self, name: str, cat: str = "", **attrs) -> Span:
        return Span(self, name, cat, attrs)

    def instant(self, name: str, **attrs) -> None:
        if len(self.events) >= self._capacity:
            self.dropped += 1
            return
        parent = self._stack[-1].sid if self._stack else None
        self.events.append({"name": name, "ts": self._clock() - self.t_start,
                            "parent": parent, "attrs": attrs})

    def fence(self, value):
        if self._fence:
            block_until_ready(value)
        return value

    def _open(self, sp: Span) -> None:
        sp.sid = next(self._seq)
        sp.parent = self._stack[-1].sid if self._stack else None
        sp.depth = len(self._stack)
        self._stack.append(sp)
        sp.t0 = self._clock() - self.t_start

    def _close(self, sp: Span) -> None:
        sp.dur = (self._clock() - self.t_start) - sp.t0
        if self._stack and self._stack[-1] is sp:
            self._stack.pop()
        elif sp in self._stack:         # mis-nested exit: drop descendants
            while self._stack and self._stack[-1] is not sp:
                self._stack.pop()
            self._stack.pop()
        if len(self.spans) >= self._capacity:
            self.dropped += 1
            return
        self.spans.append(sp)

    # ----------------------------------------------------------- aggregation

    def roots(self) -> List[Span]:
        return [s for s in self.spans if s.depth == 0]

    def children(self, parent: Span) -> List[Span]:
        return [s for s in self.spans if s.parent == parent.sid]

    def by_name(self) -> Dict[str, float]:
        """Total seconds per span name (all depths)."""
        out: Dict[str, float] = {}
        for s in self.spans:
            out[s.name] = out.get(s.name, 0.0) + s.dur
        return out

    # -------------------------------------------------------------- exporters

    def export_chrome(self) -> dict:
        """Chrome/Perfetto trace-event JSON (``chrome://tracing`` /
        ui.perfetto.dev openable): complete ("X") events for spans,
        instant ("i") events, timestamps in microseconds."""
        ev = []
        for s in self.spans:
            ev.append({"name": s.name, "cat": s.cat or "span", "ph": "X",
                       "ts": round(s.t0 * 1e6, 3),
                       "dur": round(s.dur * 1e6, 3),
                       "pid": 0, "tid": 0,
                       "args": _jsonable(s.attrs)})
        for e in self.events:
            ev.append({"name": e["name"], "cat": "event", "ph": "i",
                       "ts": round(e["ts"] * 1e6, 3), "pid": 0, "tid": 0,
                       "s": "t", "args": _jsonable(e["attrs"])})
        ev.sort(key=lambda d: d["ts"])
        return {"traceEvents": ev, "displayTimeUnit": "ms",
                "otherData": {"dropped": self.dropped}}

    def write_chrome(self, path) -> None:
        with open(path, "w") as f:
            json.dump(self.export_chrome(), f)

    def export_jsonl(self) -> str:
        """One JSON object per line: spans (kind="span") then instants
        (kind="event"), both with seconds-based timestamps."""
        lines = []
        for s in self.spans:
            lines.append(json.dumps(
                {"kind": "span", "name": s.name, "cat": s.cat,
                 "ts": s.t0, "dur": s.dur, "sid": s.sid,
                 "parent": s.parent, "depth": s.depth,
                 "attrs": _jsonable(s.attrs)}))
        for e in self.events:
            lines.append(json.dumps(
                {"kind": "event", "name": e["name"], "ts": e["ts"],
                 "parent": e["parent"], "attrs": _jsonable(e["attrs"])}))
        return "\n".join(lines) + ("\n" if lines else "")

    # --------------------------------------------------------------- session

    def activate(self):
        """``with tracer.activate():`` — install as the module ACTIVE."""
        return use(self)


def _jsonable(attrs: Dict[str, Any]) -> Dict[str, Any]:
    out = {}
    for k, v in attrs.items():
        if isinstance(v, (str, int, float, bool)) or v is None:
            out[k] = v
        else:
            out[k] = str(v)
    return out


@contextlib.contextmanager
def use(tracer):
    """Install ``tracer`` as the module-level ACTIVE for the block."""
    global ACTIVE
    prev = ACTIVE
    ACTIVE = tracer
    try:
        yield tracer
    finally:
        ACTIVE = prev


def coerce(spec) -> Optional[TraceConfig]:
    """``PSCConfig.trace`` coercion: None/False = off, True = defaults,
    a TraceConfig passes through."""
    if not spec:
        return None
    if spec is True:
        return TraceConfig()
    if isinstance(spec, TraceConfig):
        return spec
    raise TypeError(f"trace must be None, True/False, or a TraceConfig, "
                    f"got {type(spec).__name__}")


@contextlib.contextmanager
def session(spec):
    """The pipeline's tracing entry: if ``spec`` asks for tracing and no
    real tracer is active, create one, install it, and yield it (the
    caller owns its telemetry).  If a tracer is already active — an
    outer session, an engine-level tracer — yield None and let spans
    flow to the owner."""
    cfg = coerce(spec) if not isinstance(spec, Tracer) else None
    if isinstance(spec, Tracer):
        if ACTIVE.enabled:
            yield None
            return
        with use(spec):
            yield spec
        return
    if cfg is None or ACTIVE.enabled:
        yield None
        return
    tracer = Tracer(cfg)
    with use(tracer):
        yield tracer


# ------------------------------------------------- fault/recovery correlation

_INJECTION_SEQ = itertools.count(1)
_CURRENT_INJECTION: Optional[int] = None


def begin_injection(site: str, detail: str = "") -> int:
    """Stamp a fresh injection id (fault injectors call this); emits a
    ``fault.<site>`` instant on the active tracer so the fault and any
    recovery it triggers share one correlatable id on the timeline."""
    global _CURRENT_INJECTION
    inj = next(_INJECTION_SEQ)
    _CURRENT_INJECTION = inj
    ACTIVE.instant(f"fault.{site}", injection_id=inj, detail=detail)
    return inj


def current_injection() -> Optional[int]:
    """The most recent injection id (None outside chaos runs) — recovery
    events attach it so failures read off one timeline."""
    return _CURRENT_INJECTION


# --------------------------------------------------------------- telemetry

@dataclasses.dataclass
class Telemetry:
    """What a traced pipeline run hands back (``PSCResult.telemetry``):
    the finished spans/events plus export and aggregation helpers."""

    spans: List[Span]
    events: List[dict]
    dropped: int
    metrics: Optional[dict] = None      # DEFAULT-registry snapshot

    @classmethod
    def from_tracer(cls, tracer: Tracer,
                    metrics: Optional[dict] = None) -> "Telemetry":
        return cls(spans=list(tracer.spans), events=list(tracer.events),
                   dropped=tracer.dropped, metrics=metrics)

    def _as_tracer(self) -> Tracer:
        t = Tracer(TraceConfig(fence=False))
        t.spans = self.spans
        t.events = self.events
        t.dropped = self.dropped
        return t

    def chrome(self) -> dict:
        return self._as_tracer().export_chrome()

    def write_chrome(self, path) -> None:
        self._as_tracer().write_chrome(path)

    def jsonl(self) -> str:
        return self._as_tracer().export_jsonl()

    def root(self) -> Optional[Span]:
        roots = [s for s in self.spans if s.depth == 0]
        return roots[0] if roots else None

    def phase_breakdown(self) -> Dict[str, float]:
        """Seconds per top-level phase: depth-1 spans under the root
        (init / continuation / kmeans on the flat path;
        multilevel.coarse_solve / multilevel.refine / kmeans on the
        multilevel path), grouped by name."""
        root = self.root()
        if root is None:
            return {}
        out: Dict[str, float] = {}
        for s in self.spans:
            if s.parent == root.sid:
                out[s.name] = out.get(s.name, 0.0) + s.dur
        return out

    def coverage(self) -> float:
        """Fraction of the root span's wall clock accounted for by its
        direct children."""
        root = self.root()
        if root is None or root.dur <= 0:
            return float("nan")
        return sum(self.phase_breakdown().values()) / root.dur

    def total_s(self) -> float:
        root = self.root()
        return root.dur if root is not None else float("nan")

    def by_name(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for s in self.spans:
            out[s.name] = out.get(s.name, 0.0) + s.dur
        return out


# ------------------------------------------------------------------ helpers

def under_trace() -> bool:
    """True while ``torch.compile`` traces the caller, where a wall-clock
    span would time the trace, not the run.  The port runs eagerly, so
    no instrument site branches on it yet."""
    return bool(torch.compiler.is_compiling())


def roofline_summary(spans, peak_gbs: Optional[float] = None
                     ) -> Dict[str, dict]:
    """Per-backend achieved bandwidth from ``grblas.mxm`` spans (attrs
    carry the byte model): {backend: {calls, bytes, seconds, gb_s[,
    frac_of_peak]}}."""
    out: Dict[str, dict] = {}
    for s in spans:
        by = s.attrs.get("bytes") if isinstance(s.attrs, dict) else None
        if by is None:
            continue
        be = s.attrs.get("backend", "?")
        row = out.setdefault(be, {"calls": 0, "bytes": 0, "seconds": 0.0})
        row["calls"] += 1
        row["bytes"] += int(by)
        row["seconds"] += float(s.dur)
    for row in out.values():
        row["gb_s"] = (row["bytes"] / row["seconds"] / 1e9
                       if row["seconds"] > 0 else float("nan"))
        if peak_gbs:
            row["frac_of_peak"] = row["gb_s"] / peak_gbs
    return out
