"""Cross-registry consistency: telemetry coverage of the two dispatch
registries (the telemetry coverage claim of ``obs/``, kept true as
registrants land).

``registry-span`` cross-references three module sets:

* every ``register_backend("<name>", ...)`` in ``grblas/backends.py``,
* every ``register_solver("<name>", ...)`` under ``core/solvers/``,
* every ``span(...)``/``instant(...)`` call site in the scanned tree,
  collecting which ``backend=``/``solver=`` attributes they carry.

A registrant is covered when some span site labels it — either
*dynamically* (the attribute value is an expression like ``be.name`` /
``solver.name`` at a dispatch chokepoint, which covers every current
and future registrant that flows through it) or *literally* (a span
hardcoding the name).  An uncovered registrant means a backend or
driver whose executions are invisible to the ``obs`` telemetry — exactly
the regression this rule exists to catch: deleting the ``grblas.mxm``
span or adding a driver that bypasses ``p_continuation`` silently
un-instruments the stack.
"""
from __future__ import annotations

import ast
from typing import List, Set, Tuple

from repro_torch.analysis import profile
from repro_torch.analysis.core import Rule, register_rule
from repro_torch.analysis.scopes import dotted_name


def _registrations(project, module_prefixes: Tuple[str, ...],
                   reg_call: str) -> List[Tuple]:
    """(name, ctx, node) for every reg_call("name", ...) — call or
    decorator form — in modules under the given prefixes."""
    out = []
    for ctx in project.modules:
        if not profile.in_scope(ctx.rel, module_prefixes):
            continue
        for n in ast.walk(ctx.tree):
            if not isinstance(n, ast.Call):
                continue
            nm = dotted_name(n.func) or ""
            if not (nm == reg_call or nm.endswith("." + reg_call)):
                continue
            if n.args and isinstance(n.args[0], ast.Constant) \
                    and isinstance(n.args[0].value, str):
                out.append((n.args[0].value, ctx, n))
    return out


def _span_labels(project, attr: str) -> Tuple[bool, Set[str]]:
    """(has_dynamic_site, literal_names) across every ``span``/
    ``instant`` call site carrying keyword ``attr``."""
    dynamic = False
    literals: Set[str] = set()
    for ctx in project.modules:
        for n in ast.walk(ctx.tree):
            if not isinstance(n, ast.Call):
                continue
            if not (isinstance(n.func, ast.Attribute)
                    and n.func.attr in ("span", "instant")):
                continue
            for kw in n.keywords:
                if kw.arg != attr:
                    continue
                if isinstance(kw.value, ast.Constant) \
                        and isinstance(kw.value.value, str):
                    literals.add(kw.value.value)
                else:
                    dynamic = True
    return dynamic, literals


def _project_check(project):
    backends = _registrations(
        project, (profile.BACKEND_REGISTRY_MODULE,), "register_backend")
    solvers = _registrations(
        project, (profile.SOLVER_PKG,), "register_solver")
    be_dyn, be_lit = _span_labels(project, "backend")
    so_dyn, so_lit = _span_labels(project, "solver")

    for name, ctx, node in backends:
        if not (be_dyn or name in be_lit):
            yield ctx.finding(
                "registry-span", node,
                f"backend {name!r} has no obs span coverage: no span/"
                f"instant site carries backend=<name> (the grblas.mxm "
                f"dispatch span is gone or bypassed) — obs telemetry "
                f"would not see its executions")
    for name, ctx, node in solvers:
        if not (so_dyn or name in so_lit):
            yield ctx.finding(
                "registry-span", node,
                f"solver driver {name!r} has no obs span coverage: no "
                f"span/instant site carries solver=<name> (the "
                f"solver.level span is gone or bypassed) — obs "
                f"telemetry would not see its levels")
    # the rule is only meaningful if it actually sees the registries —
    # guard against a scan scoped so narrowly it proves nothing
    if not backends and project.get(profile.BACKEND_REGISTRY_MODULE):
        m = project.get(profile.BACKEND_REGISTRY_MODULE)
        yield m.finding(
            "registry-span", m.tree,
            "grblas/backends.py contains no register_backend calls — "
            "registry moved? update repro_torch/analysis/profile.py")


register_rule(Rule(
    id="registry-span",
    summary="every registered backend/driver is visible to obs spans",
    invariant="Each name registered via register_backend (grblas/"
              "backends.py) or register_solver (core/solvers/) is "
              "covered by a span/instant site labelling backend=/"
              "solver= — dynamically at the dispatch chokepoints "
              "(grblas.mxm, solver.level) or literally — so the obs "
              "telemetry coverage claim stays true as registrants land.",
    project_check=_project_check,
))
