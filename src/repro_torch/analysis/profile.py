"""The port's profile: which invariant applies where.

Rules are generic AST checks; this module pins them to the port's
actual tree, module for module as the reference's ``profile.py`` pins
them to ``src/repro``.  Paths are module-relative ("core/plap.py" — see
``core.module_rel``, which resolves under ``repro_torch``), matched by
prefix, so the tables read like the package tree.  Fixture files used
by the self-tests fall outside every scope and get the permissive
default — scoped rules are exercised there by naming paths that *look*
scoped (tests construct ModuleContexts with synthetic paths).

Where a table differs from the reference's, the port's layout forced
it, and the comment beside it says how:

* ``SEGMENT_SUM_ALLOWED`` adds ``kernels/``: the port's fixed-order
  segmented sum is a kernel package of its own (``kernels/segment_sum``)
  that grblas calls, where the reference calls ``jax.ops.segment_sum``.
* ``kernels/nvcc.py`` (the build route of every kernel) sits under
  ``kernels/`` and so falls under every ``kernels/`` scope, as the
  reference's Pallas modules do; it is also where the build the
  ``retrace-loop-jit`` rule looks for is defined.
* ``device.py`` has no counterpart in the reference and is in no scope:
  it resolves devices and converts dtype names once a call, on the
  host.
* ``HOST_SYNC_SCOPE`` and ``MUTABLE_DEFAULT_SCOPE`` are new: the
  reference scopes those rules by JAX traces, which eager torch does
  not have (``scopes.py``).
"""
from __future__ import annotations

from typing import Iterable

# ---------------------------------------------------------- purity scopes
# Modules forming the solver/kernel hot path: everything here executes
# in the Newton/Grassmann continuation, so host math libraries are
# banned outright.
SCIPY_BAN = (
    "core/solvers/",
    "core/plap.py",
    "core/grassmann.py",
    "core/lobpcg.py",
    "core/kmeans.py",
    "core/phi.py",
    "multilevel/",
    "kernels/",
    "grblas/semiring.py",
    "serve/bucketing.py",
    "serve/psc_engine.py",
)

# Pure-device modules: numpy itself is banned (torch only).  Host-side
# assembly modules (containers, coarsen, serve queueing) legitimately
# use numpy and are NOT listed.
NUMPY_BAN = (
    "core/plap.py",
    "core/grassmann.py",
    "core/lobpcg.py",
    "core/kmeans.py",
    "core/phi.py",
    "kernels/",
)

# Galerkin products must route api.mxm: no dense matrix products.
DENSE_MATMUL_BAN = ("multilevel/",)

# -------------------------------------------------------- hot-loop scopes
# Modules whose for/while loops run once a solver step (the reference's
# traced scopes have no eager counterpart; the hot path's loops are
# where a host sync costs once an iteration): host-sync looks inside
# their loops, retrace-mutable-default at all their defs.
HOST_SYNC_SCOPE = SCIPY_BAN
MUTABLE_DEFAULT_SCOPE = SCIPY_BAN

# ------------------------------------------------------- boundary scopes
# Raw scatter/index reductions are the algebra's private reduction: only
# the grblas package and the kernel packages (kernels/segment_sum is the
# port's segment_sum) may touch them.
SEGMENT_SUM_ALLOWED = ("grblas/", "kernels/")
SEGMENT_SUM_PKG = "segment_sum"

# The sparse kernel packages are grblas implementation detail — callers
# go through api.mxm/mxv/vxm.  (flash_attention / kmeans_assign are
# dense model kernels outside the GraphBLAS boundary.)
SPARSE_KERNEL_PKGS = ("bsr_spmm", "plap_edge", "sellcs_spmm")
KERNEL_IMPORT_ALLOWED = ("grblas/", "kernels/")

# Backend registry internals (grblas.backends._REGISTRY et al.) are
# private to the package.
BACKEND_PRIVATE_ALLOWED = ("grblas/",)

# ------------------------------------------------------ pad-fold scopes
# Modules that handle padded sparse layouts (ELL / SELL-C-σ / halo):
# raw reductions over a pad axis here must be masked, registered as a
# ring fast path, or capability-gated (inline-suppressed with the gate
# named).
PAD_FOLD_SCOPE = (
    "grblas/backends.py",
    "grblas/dist.py",
    "grblas/semiring.py",
    "kernels/bsr_spmm/",
    "kernels/plap_edge/",
    "kernels/sellcs_spmm/",
)

# ----------------------------------------------------------- dtype scopes
# Device-feeding subsystems: 64-bit dtypes double memory and defeat the
# int32 index layout, so any float64/int64 hardcode here is explicit
# debt (fp64 pipelines opt in per call by passing a dtype).
DTYPE_SCOPE = (
    "grblas/",
    "kernels/",
    "core/",
    "multilevel/",
    "serve/psc_engine.py",
    "serve/bucketing.py",
)

# Layout-build functions must pin dtypes on every tensor constructor
# (torch's default int64 / default float dtype is exactly the silent
# promotion).
LAYOUT_BUILD_PREFIXES = ("_build_",)
LAYOUT_BUILD_MODULES = ("grblas/containers.py",)

# ----------------------------------------------------- registry locations
BACKEND_REGISTRY_MODULE = "grblas/backends.py"
DIST_MODULE = "grblas/dist.py"
SOLVER_REGISTRY_MODULE = "core/solvers/registry.py"
SOLVER_PKG = "core/solvers/"


def in_scope(rel: str, prefixes: Iterable[str]) -> bool:
    return any(rel.startswith(p) for p in prefixes)


def is_sparse_kernel_module(rel: str) -> bool:
    return (rel.startswith("kernels/")
            and len(rel.split("/")) > 1
            and rel.split("/")[1] in SPARSE_KERNEL_PKGS)
