"""repro_torch.obs — telemetry: spans, metrics and rebuild detection
(port of ``repro.obs``).

``obs.trace`` and ``obs.metrics`` depend only on the standard library and
torch, so the lowest layers (grblas, the solver registry) import them
freely; ``obs.retrace`` (the detector over the serve engine's build memo)
sits above the solver stack and is loaded on first use.
"""
from repro_torch.obs import metrics, trace
from repro_torch.obs.metrics import (DEFAULT, Counter, Gauge, Histogram,
                                     MetricsRegistry)
from repro_torch.obs.trace import (NULL, Span, Telemetry, TraceConfig, Tracer,
                                   begin_injection, current_injection,
                                   roofline_summary, session, use)

__all__ = [
    "metrics", "trace", "retrace",
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "DEFAULT",
    "NULL", "Span", "Telemetry", "TraceConfig", "Tracer",
    "begin_injection", "current_injection", "roofline_summary",
    "session", "use",
    "RetraceDetector", "RetraceError", "assert_no_retrace",
]

_LAZY = {"retrace", "RetraceDetector", "RetraceError", "assert_no_retrace"}


def __getattr__(name):
    if name in _LAZY:
        import importlib

        _retrace = importlib.import_module("repro_torch.obs.retrace")
        globals()["retrace"] = _retrace
        for attr in ("RetraceDetector", "RetraceError", "assert_no_retrace"):
            globals()[attr] = getattr(_retrace, attr)
        return globals()[name]
    raise AttributeError(f"module 'repro_torch.obs' has no attribute {name!r}")
