"""The port's telemetry layer (``repro_torch.obs``) against the
reference's contract (``tests/test_obs.py``, without its two serve-engine
tests, which wait for the serve port): span nesting and the Chrome /
JSONL round trip, the bounded buffer, the null tracer as the default,
session ownership, the traced flat pipeline's telemetry, the disabled
path's cost, ``roofline_summary`` from ``grblas.mxm`` spans, the metrics
registry, and the exactly-once contract between recovery rungs and
their counters and trace events.  The recorder and the registry are fed
the same operations as the reference's and must export the same
documents."""
import dataclasses
import json
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")  # the reference-only CI has no torch

from repro.obs import MetricsRegistry as RefMetricsRegistry
from repro.obs import TraceConfig as RefTraceConfig
from repro.obs import Tracer as RefTracer
from repro.obs import use as ref_use
from repro_torch.core.psc import PSCConfig, p_spectral_cluster
from repro_torch.graphs import ring_of_cliques, sbm_graph
from repro_torch.grblas import mxm
from repro_torch.obs import (DEFAULT, NULL, MetricsRegistry, TraceConfig,
                             Tracer, roofline_summary, use)
from repro_torch.obs import trace as obs_trace
from repro_torch.testing import nan_in_multivector

torch.set_num_threads(1)

K = 4
# 2-level continuation ([1.7, 1.5]), the reference's recipe
_KW = dict(k=K, newton_iters=8, tcg_iters=5, p_target=1.5, p_factor=0.85)


@pytest.fixture(scope="module")
def sbm():
    return sbm_graph([30] * K, 0.92, 0.03, seed=0, device="cpu")[0]


def _record(tracer_cls, cfg_cls, use_fn):
    """One scripted session on an injected clock."""
    t = {"now": 0.0}
    tr = tracer_cls(cfg_cls(fence=False, clock=lambda: t["now"]))
    with use_fn(tr):
        with tr.span("root", cat="test", n=4):
            t["now"] += 1.0
            with tr.span("child_a"):
                t["now"] += 0.25
            tr.instant("ping", x=1)
            with tr.span("child_b", note="b"):
                t["now"] += 0.5
            t["now"] += 0.25
    return tr


# ------------------------------------------------------------ span recorder

def test_span_nesting_and_chrome_round_trip():
    tr = _record(Tracer, TraceConfig, use)
    assert [s.name for s in tr.spans] == ["child_a", "child_b", "root"]
    root = tr.roots()[0]
    assert root.name == "root" and root.t0 == 0.0 and root.dur == 2.0
    kids = tr.children(root)
    assert [s.name for s in kids] == ["child_a", "child_b"]
    for s in kids:
        assert s.depth == 1 and s.parent == root.sid
        assert s.t0 + s.dur <= root.t0 + root.dur
    doc = json.loads(json.dumps(tr.export_chrome()))
    xs = [e for e in doc["traceEvents"] if e["ph"] == "X"]
    rx = next(e for e in xs if e["name"] == "root")
    assert rx["ts"] == 0.0 and rx["dur"] == 2.0e6 and rx["args"] == {"n": 4}
    inst = [e for e in doc["traceEvents"] if e["ph"] == "i"]
    assert inst[0]["ts"] == 1.25e6 and inst[0]["args"] == {"x": 1}
    lines = [json.loads(ln) for ln in tr.export_jsonl().splitlines()]
    assert [ln["kind"] for ln in lines] == ["span"] * 3 + ["event"]
    # the same session on the reference's recorder exports the same
    # documents
    ref = _record(RefTracer, RefTraceConfig, ref_use)
    assert tr.export_chrome() == ref.export_chrome()
    assert tr.export_jsonl() == ref.export_jsonl()


def test_bounded_buffer_drops_past_capacity():
    tr = Tracer(TraceConfig(capacity=4, fence=False))
    with use(tr):
        for i in range(10):
            with tr.span(f"s{i}"):
                pass
        for i in range(6):
            tr.instant(f"e{i}")
    assert len(tr.spans) == 4 and len(tr.events) == 4
    assert tr.dropped == 6 + 2


def test_null_tracer_is_the_default_and_free():
    assert obs_trace.ACTIVE is NULL
    assert not NULL.enabled
    sp = obs_trace.ACTIVE.span("anything", cat="x", big=1)
    assert sp is obs_trace.NULL_SPAN
    with sp as s:
        assert s.set(a=1) is s
        assert s.fence(42) == 42


def test_fence_waits_only_on_cuda_tensors(monkeypatch):
    """A fence synchronizes the CUDA device of each tensor in the value
    (once a device) and does nothing for CPU tensors or other values."""
    synced = []
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda dev=None: synced.append(dev))
    x = torch.zeros(3)
    assert obs_trace.block_until_ready((x, [x, {"a": x}], 7, None)) is not None
    assert synced == []
    meta = torch.empty(2, device="meta")
    obs_trace.block_until_ready(meta)
    assert synced == []
    tr = Tracer(TraceConfig(fence=True))
    with tr.span("s") as sp:
        assert sp.fence(x) is x
    assert synced == []
    assert not obs_trace.under_trace()


def test_session_ownership_nested_calls_share_the_outer_tracer():
    with obs_trace.session(True) as owner:
        assert owner is not None and obs_trace.ACTIVE is owner
        with obs_trace.session(True) as inner:       # nested: reuse outer
            assert inner is None
        with obs_trace.session(None) as off:
            assert off is None
    assert obs_trace.ACTIVE is NULL
    with obs_trace.session(False) as off:
        assert off is None and obs_trace.ACTIVE is NULL
    with pytest.raises(TypeError):
        PSCConfig(trace="yes")


# --------------------------------------------------------- traced pipeline

def test_traced_flat_pipeline_telemetry(sbm):
    cfg = PSCConfig(trace=True, **_KW)
    res = p_spectral_cluster(sbm, cfg)
    tel = res.telemetry
    assert tel is not None and tel.dropped == 0
    assert tel.root().name == "psc"
    ph = tel.phase_breakdown()
    assert {"init", "continuation", "kmeans"} <= set(ph)
    assert tel.coverage() >= 0.8
    levels = [s for s in tel.spans if s.name == "solver.level"]
    assert len(levels) == 2
    assert all("n_apply" in s.attrs and "fval" in s.attrs for s in levels)
    assert any(s.name == "grblas.mxm" for s in tel.spans)
    # untraced run: telemetry is None, result identical
    res2 = p_spectral_cluster(sbm, dataclasses.replace(cfg, trace=None))
    assert res2.telemetry is None
    assert res2.rcut == res.rcut
    np.testing.assert_array_equal(res2.labels, res.labels)
    # a tracer handed in records the solve and owns its telemetry
    tr = Tracer(TraceConfig(fence=False))
    res3 = p_spectral_cluster(sbm, dataclasses.replace(cfg, trace=tr))
    assert res3.telemetry is not None and tr.roots()[0].name == "psc"


def test_traced_multilevel_spans():
    from repro_torch.multilevel import MultilevelConfig

    W, _ = ring_of_cliques(4, 40, device="cpu")
    res = p_spectral_cluster(W, PSCConfig(
        trace=True, multilevel=MultilevelConfig(coarse_size=32),
        **dict(_KW, newton_iters=5, tcg_iters=4)))
    names = {s.name for s in res.telemetry.spans}
    assert {"psc", "multilevel.coarse_solve", "multilevel.refine",
            "kmeans"} <= names
    # the coarse solve's own pipeline feeds the same timeline
    assert sum(s.name == "psc" for s in res.telemetry.spans) == 2


def test_disabled_tracing_overhead_within_2pct(sbm):
    """(instrument sites a traced solve hits) x (disabled-path cost of
    one site) <= 2% of the solve's wall clock."""
    cfg = PSCConfig(trace=True, **_KW)
    t0 = time.perf_counter()
    res = p_spectral_cluster(sbm, cfg)
    wall = time.perf_counter() - t0
    n_sites = len(res.telemetry.spans) + len(res.telemetry.events)
    assert n_sites > 0
    assert obs_trace.ACTIVE is NULL
    reps = 20000
    t0 = time.perf_counter()
    for _ in range(reps):
        with obs_trace.ACTIVE.span("x", cat="t", a=1) as sp:
            sp.fence(None)
    null_cost = (time.perf_counter() - t0) / reps
    assert n_sites * null_cost <= 0.02 * wall


def test_roofline_summary_from_mxm_spans():
    W, _ = ring_of_cliques(4, 8, device="cpu")
    X = torch.as_tensor(np.random.default_rng(0).standard_normal(
        (W.n_rows, K)), dtype=torch.float32)
    tr = Tracer(TraceConfig())
    with use(tr):
        mxm(W, X)
    spans = [s for s in tr.spans if s.name == "grblas.mxm"]
    assert spans
    s0 = spans[0]
    # the reference's byte model: (value + column id) per nnz, X in and
    # Y out once
    assert s0.attrs["bytes"] == W.nnz * 8 + 2 * W.n_rows * K * 4
    assert s0.attrs["nnz"] == W.nnz and s0.attrs["k"] == K
    summ = roofline_summary(spans, peak_gbs=100.0)
    row = summ[s0.attrs["backend"]]
    assert row["calls"] == len(spans) and row["gb_s"] > 0
    assert row["frac_of_peak"] == pytest.approx(row["gb_s"] / 100.0)


def test_fallback_counter_and_instant():
    """A pinned descriptor that cannot serve a ring degrades to auto and
    is counted."""
    from repro_torch.grblas import Descriptor, capable_desc

    W, _ = ring_of_cliques(3, 4, device="cpu")          # no BSR layout
    before = DEFAULT.snapshot()
    tr = Tracer(TraceConfig(fence=False))
    with use(tr):
        assert capable_desc(W, desc=Descriptor(backend="bsr_pallas")) is None
    d = DEFAULT.delta(before)
    assert d == {'grblas_fallback_total{backend="bsr_pallas",'
                 'ring="reals_+x"}': 1.0}
    assert [e["name"] for e in tr.events] == ["grblas.fallback"]


# --------------------------------------------------------- metrics registry

def _fill(reg):
    reg.counter("req_total", lane="bucket").inc()
    reg.counter("req_total", lane="solo").inc(2)
    reg.gauge("depth").set(3)
    h = reg.histogram("lat_s", buckets=(0.1, 1.0))
    for v in (0.05, 0.5, 5.0):
        h.observe(v)


def test_metrics_snapshot_delta_and_exposition():
    reg = MetricsRegistry()
    _fill(reg)
    snap = reg.snapshot()
    assert snap['req_total{lane="bucket"}'] == 1.0
    assert snap["lat_s_sum"] == pytest.approx(5.55)
    assert snap['lat_s_bucket{le="+Inf"}'] == 3.0
    assert reg.total("req_total") == 3.0
    assert reg.labeled_values("req_total", "lane") == {"bucket": 1.0,
                                                       "solo": 2.0}
    prev = snap
    reg.counter("req_total", lane="solo").inc()
    assert reg.delta(prev) == {'req_total{lane="solo"}': 1.0}
    text = reg.exposition()
    assert "# TYPE lat_s histogram" in text and text.endswith("\n")
    with pytest.raises(TypeError):
        reg.gauge("req_total")
    with pytest.raises(ValueError):
        reg.counter("req_total", lane="bucket").inc(-1)
    # the reference's registry, fed the same, exports the same
    ref = RefMetricsRegistry()
    _fill(ref)
    ref.counter("req_total", lane="solo").inc()
    assert reg.snapshot() == ref.snapshot()
    assert reg.exposition() == ref.exposition()


# --------------------------------------- recovery rungs: exactly-once + ids

def test_rung_counters_fire_exactly_once_and_correlate(sbm):
    before = DEFAULT.snapshot()
    tr = Tracer(TraceConfig())
    with use(tr):
        with nan_in_multivector("newton", at_call=1,
                                max_calls=None) as log:
            res = p_spectral_cluster(sbm, PSCConfig(guard=True, **_KW))
    assert res.recovery.final_rung == "driver_switch"
    assert log.count() >= 2 and log.ids == sorted(log.ids)
    fired = {}
    for r in res.recovery.rungs:
        fired[r.rung] = fired.get(r.rung, 0) + 1
    d = DEFAULT.delta(before)
    for rung, n in fired.items():
        assert d.get(f'recovery_rungs_total{{rung="{rung}"}}', 0.0) == n
    moved = {k for k in d if k.startswith("recovery_rungs_total")}
    assert moved == {f'recovery_rungs_total{{rung="{r}"}}' for r in fired}
    faults = [e for e in tr.events
              if e["name"] == "fault.nan_in_multivector"]
    assert [e["attrs"]["injection_id"] for e in faults] == log.ids
    assert d.get('fault_injections_total{site="nan_in_multivector"}') \
        == len(log.ids)
    rung_evs = [e for e in tr.events if e["name"] == "recovery.rung"]
    assert len(rung_evs) == len(res.recovery.rungs)
    assert all(e["attrs"]["injection_id"] in log.ids for e in rung_evs)
    spans = {s.name for s in tr.spans if s.name.startswith("recovery.")}
    assert spans == {f"recovery.{r}" for r in fired}
    div = [e for e in tr.events if e["name"] == "solver.divergence"]
    assert div and div[0]["attrs"]["injection_id"] in log.ids


def test_retrace_names_load_from_obs():
    """``obs.retrace`` and its names load on first use and read the
    registry's build log: a build bumps ``compiles_total{site=}`` and
    stamps a ``compile`` instant on the active tracer."""
    import repro_torch.obs as obs
    from repro_torch.core.solvers import registry

    assert obs.RetraceDetector is obs.retrace.RetraceDetector
    assert issubclass(obs.RetraceError, AssertionError)
    det = obs.RetraceDetector()
    before = DEFAULT.value("compiles_total", site="obs-test")
    tr = Tracer(TraceConfig())
    with obs.use(tr):
        registry.mark_trace(("obs-test", 1))
        registry.mark_trace(("obs-test", 1))
    assert det.compiles() == {("obs-test", 1): 2}
    assert det.by_site() == {"obs-test": 2} and det.serve_buckets() == {}
    assert DEFAULT.value("compiles_total", site="obs-test") == before + 2
    assert [e["attrs"]["site"] for e in tr.events
            if e["name"] == "compile"] == ["obs-test", "obs-test"]
    with pytest.raises(obs.RetraceError, match="more than 1x"):
        det.assert_at_most(1)
    with pytest.raises(obs.RetraceError, match="unexpected build"):
        det.assert_no_retrace()
    with obs.assert_no_retrace() as quiet:
        pass
    assert quiet.traces() == []
