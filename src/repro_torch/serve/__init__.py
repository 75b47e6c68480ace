"""Serving layer of the port: the LM decode engine (``serve.engine``).
The reference's clustering serve engine (``repro.serve.psc_engine``,
bucketing, warm cache, churn) is not ported yet: ROADMAP.md queue 1,
item 13."""
from repro_torch.serve.engine import GenerationConfig, ServeEngine

__all__ = ["ServeEngine", "GenerationConfig"]
