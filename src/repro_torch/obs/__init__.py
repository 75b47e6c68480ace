"""repro_torch.obs — telemetry: spans and metrics (port of ``repro.obs``).

``obs.trace`` and ``obs.metrics`` depend only on the standard library and
torch, so the lowest layers (grblas, the solver registry) import them
freely.  The reference's third module, ``obs.retrace`` (the recompile
detector), counts the compiles of the serve engine's bucket memo, which
the port does not have yet: its names raise NotImplementedError naming
ROADMAP.md queue 1, item 13.
"""
from repro_torch.obs import metrics, trace
from repro_torch.obs.metrics import (DEFAULT, Counter, Gauge, Histogram,
                                     MetricsRegistry)
from repro_torch.obs.trace import (NULL, Span, Telemetry, TraceConfig, Tracer,
                                   begin_injection, current_injection,
                                   roofline_summary, session, use)

__all__ = [
    "metrics", "trace",
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "DEFAULT",
    "NULL", "Span", "Telemetry", "TraceConfig", "Tracer",
    "begin_injection", "current_injection", "roofline_summary",
    "session", "use",
]

_RETRACE = {"retrace", "RetraceDetector", "RetraceError", "assert_no_retrace"}


def __getattr__(name):
    if name in _RETRACE:
        raise NotImplementedError(
            f"repro_torch.obs.{name} is not ported yet (ROADMAP.md queue 1, "
            "item 13: it comes with the serve engine's one-compile-per-bucket "
            "contract)")
    raise AttributeError(f"module 'repro_torch.obs' has no attribute {name!r}")
