"""repro_torch.core — p-spectral clustering on the Grassmann manifold,
with the GraphBLAS-style algebra of ``repro_torch.grblas`` underneath
and a registry of interchangeable solver drivers (``core.solvers``) on
top.

Exports what the reference's ``repro.core`` does (``PSCConfig``,
``PSCResult``, ``p_spectral_cluster``, ``spectral_cluster`` and the
submodules), but lazily: each name is imported on first access through
the module ``__getattr__``, so importing the package imports nothing and
``grblas`` can import ``core.phi`` without a cycle."""
import importlib

_FROM_PSC = ("PSCConfig", "PSCResult", "p_spectral_cluster",
             "spectral_cluster")
_SUBMODULES = ("plap", "metrics", "kmeans", "lobpcg", "grassmann", "phi",
               "solvers")

__all__ = list(_FROM_PSC + _SUBMODULES)


def __getattr__(name):
    if name in _FROM_PSC:
        return getattr(importlib.import_module(f"{__name__}.psc"), name)
    if name in _SUBMODULES:
        return importlib.import_module(f"{__name__}.{name}")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(set(globals()) | set(__all__))
