"""API-boundary enforcement.

Every SpMM-shaped operation goes through ``api.mxm/mxv/vxm`` under a
``Descriptor`` — that is the point of the unified execution API and the
reason a new layout is one ``register_backend`` call.  Four leak shapes
are flagged outside the packages that implement it:

* a raw scatter/index reduction (``index_add_``, ``scatter_add_``,
  ``scatter_reduce``, ``index_reduce_``, ``torch.segment_reduce``)
  outside ``grblas/`` and ``kernels/`` — the algebra's private
  reduction (the reference's raw ``jax.ops.segment_sum``); outside the
  packages it bypasses ring dispatch;
* direct use of ``kernels/segment_sum`` (the port's fixed-order
  segmented sum) outside ``grblas/`` and ``kernels/``;
* importing the sparse kernel packages (``kernels/bsr_spmm``,
  ``plap_edge``, ``sellcs_spmm``) outside ``grblas/`` and ``kernels/``
  — kernels are backend implementation detail, reachable only via a
  Descriptor;
* touching ``grblas.backends`` privates (``_REGISTRY``) outside the
  package.
"""
from __future__ import annotations

import ast

from repro_torch.analysis import profile
from repro_torch.analysis.core import PACKAGE, Rule, register_rule
from repro_torch.analysis.scopes import dotted_name

_RAW_REDUCTIONS = frozenset({
    "index_add_", "index_add", "scatter_add_", "scatter_add",
    "scatter_reduce_", "scatter_reduce", "index_reduce_", "index_reduce",
    "segment_reduce",
})


def _kernel_modules(n):
    """Module paths an import statement pulls from ``repro_torch.kernels``:
    ``from repro_torch.kernels import sellcs_spmm`` names the package."""
    if isinstance(n, ast.Import):
        return [a.name for a in n.names]
    mod = n.module or ""
    if mod == f"{PACKAGE}.kernels":
        return [f"{mod}.{a.name}" for a in n.names]
    return [mod]


def _check_boundary(ctx):
    rel = ctx.rel
    reduce_ok = profile.in_scope(rel, profile.SEGMENT_SUM_ALLOWED)
    kernels_ok = profile.in_scope(rel, profile.KERNEL_IMPORT_ALLOWED)
    private_ok = profile.in_scope(rel, profile.BACKEND_PRIVATE_ALLOWED)

    for n in ast.walk(ctx.tree):
        # raw scatter/index reduction outside the algebra and kernels
        if not reduce_ok and isinstance(n, ast.Attribute) \
                and n.attr in _RAW_REDUCTIONS:
            yield ctx.finding(
                "api-boundary", n,
                f"raw {n.attr} outside grblas/ and kernels/ — SpMM-shaped "
                f"reductions go through api.mxm under a ring (a raw "
                f"scatter-add is wrong for non-additive monoids)")
        # sparse kernel and segment_sum imports outside grblas/, kernels/
        if not kernels_ok and isinstance(n, (ast.Import, ast.ImportFrom)):
            for mod in _kernel_modules(n):
                parts = mod.split(".")
                if not (len(parts) >= 3 and parts[0] == PACKAGE
                        and parts[1] == "kernels"):
                    continue
                if parts[2] in profile.SPARSE_KERNEL_PKGS:
                    yield ctx.finding(
                        "api-boundary", n,
                        f"direct import of sparse kernel package "
                        f"{'.'.join(parts[:3])} — kernels are backend "
                        f"implementation detail; dispatch via api.mxm "
                        f"with a Descriptor")
                elif parts[2] == profile.SEGMENT_SUM_PKG:
                    yield ctx.finding(
                        "api-boundary", n,
                        f"direct use of {'.'.join(parts[:3])} outside "
                        f"grblas/ and kernels/ — the segmented sum is the "
                        f"algebra's private reduction; go through api.mxm")
        # backend-registry privates outside grblas/
        if not private_ok and isinstance(n, ast.Attribute) \
                and n.attr == "_REGISTRY":
            base = dotted_name(n.value) or ""
            if base.endswith("backends") or base in ("_backends",):
                yield ctx.finding(
                    "api-boundary", n,
                    "grblas.backends private registry touched outside "
                    "the package — use registered_backends()/"
                    "available_backends()")


register_rule(Rule(
    id="api-boundary",
    summary="SpMM goes through api.mxm; sparse kernels and raw scatter "
            "reductions are grblas/kernels-private",
    invariant="No raw index_add_/scatter_add_/scatter_reduce, no direct "
              "kernels/segment_sum use and no sparse-kernel imports "
              "outside grblas/ and kernels/, and no backend-registry "
              "privates outside grblas/: the unified API's capability "
              "checks (ring kind, layout availability, pad soundness) "
              "only protect call sites that actually dispatch through it.",
    check=_check_boundary,
))
