"""Serving layer of the port: the LM decode engine (``serve.engine``)
and the clustering serve engine (``serve.psc_engine``: shape buckets,
a warm cache, churn), each reusing what it built for every request."""
from repro_torch.serve.engine import GenerationConfig, ServeEngine
from repro_torch.serve.bucketing import (BucketSpec, assemble_batch,
                                         bucket_for, next_pow2)
from repro_torch.serve.churn import (EdgeDelta, apply_edge_delta,
                                     incremental_recluster)
from repro_torch.serve.psc_engine import (ClusterServeEngine, EngineStats,
                                          ServeResult, ServeStats)
from repro_torch.serve.warm_cache import CacheEntry, WarmCache

__all__ = [
    "ServeEngine", "GenerationConfig",
    "BucketSpec", "assemble_batch", "bucket_for", "next_pow2",
    "EdgeDelta", "apply_edge_delta", "incremental_recluster",
    "ClusterServeEngine", "EngineStats", "ServeResult", "ServeStats",
    "CacheEntry", "WarmCache",
]
