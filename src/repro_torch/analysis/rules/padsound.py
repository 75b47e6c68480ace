"""Pad-soundness rule (the capability gates of the padded layouts).

The padded layouts (ELL, SELL-C-σ, the halo exchange's padded pair
slots) store explicit pad entries — (col=row, val=0) self-references —
and fold them together with real entries.  That is sound exactly when
the ring annihilates the pads: registered ``padded`` fast paths declare
it per ring, and the backend capability gates (``_ell_supports``,
``_sellcs_supports``, ``_dist_supports``) refuse rings that don't.

``pad-fold`` is the static face of those gates: inside the padded-
layout modules, a raw reduction carrying a ``dim=`` (or ``axis=``)
argument (the pad-axis fold shape) must be one of

* a ``padded=``/``dense=``/``segment=`` fast path *registered* on a ring
  (``register_ring_fast_paths`` — the ring declares its own soundness),
* inside a kernel function *claimed* by a capability-gated backend
  (imported from ``repro_torch.kernels.*`` by ``grblas/backends.py`` or
  ``grblas/dist.py``; a kernel package imported as a module, ``from
  repro_torch.kernels import sellcs_spmm as K``, claims each ``K.<name>``
  the dispatch module uses — reachability includes same-module helpers),
* visibly masked (the enclosing function applies ``torch.where``/
  ``masked_fill`` or a ``*mask*`` name before or around the fold), or
* inline-suppressed naming the gate that makes it sound.

Anything else is a reduction that will silently include pad slots the
day someone feeds it a ring without a registered fast path.
"""
from __future__ import annotations

import ast
from typing import Set

from repro_torch.analysis import profile
from repro_torch.analysis.core import PACKAGE, Rule, register_rule
from repro_torch.analysis.scopes import dotted_name

_FOLD_FNS = frozenset({"sum", "max", "min", "prod", "mean", "amax", "amin",
                       "nansum", "logsumexp"})
_AXIS_KW = ("dim", "axis")


def _is_fold_call(n: ast.Call):
    """(is_fold, fn_name) for torch.sum(x, dim=..) / x.sum(dim=..)."""
    has_axis = any(kw.arg in _AXIS_KW for kw in n.keywords)
    name = dotted_name(n.func)
    if name:
        head, _, fn = name.rpartition(".")
        if fn in _FOLD_FNS and head in ("torch", "np", "numpy"):
            # positional dim: torch.sum(x, 1)
            return (has_axis or len(n.args) >= 2), name
    if isinstance(n.func, ast.Attribute) and n.func.attr in _FOLD_FNS:
        return (has_axis or len(n.args) >= 1), f".{n.func.attr}"
    return False, ""


def _inside_ring_registration(ctx, node) -> bool:
    for anc in ctx.ancestors(node):
        if isinstance(anc, ast.Call):
            nm = dotted_name(anc.func) or ""
            if nm.endswith("register_ring_fast_paths") or \
                    nm.endswith("RingFastPaths"):
                return True
    return False


def _masked(ctx, node) -> bool:
    """Masking evidence in the enclosing def: a where/masked_fill call
    or a *mask* name anywhere in its body."""
    d = ctx.enclosing_def(node)
    scope = d if d is not None else ctx.tree
    for sub in ast.walk(scope):
        if isinstance(sub, ast.Call):
            nm = dotted_name(sub.func) or ""
            if nm.endswith(".where") or nm.endswith("masked_fill") \
                    or nm.endswith("masked_fill_"):
                return True
        if isinstance(sub, ast.Name) and "mask" in sub.id.lower():
            return True
        if isinstance(sub, ast.Attribute) and "mask" in sub.attr.lower():
            return True
    return False


def _claimed_kernel_names(project) -> Set[str]:
    """Kernel entry points imported from repro_torch.kernels.* by the
    capability-gated dispatch modules (grblas/backends.py, grblas/dist.py)
    — these run only behind a ``supports`` gate.  A kernel package bound
    to a name claims the attributes read off that name."""
    claimed: Set[str] = set()
    for rel in (profile.BACKEND_REGISTRY_MODULE, profile.DIST_MODULE):
        m = project.get(rel)
        if m is None:
            continue
        aliases: Set[str] = set()
        for n in ast.walk(m.tree):
            if isinstance(n, ast.ImportFrom) and n.module \
                    and n.module.startswith(f"{PACKAGE}.kernels"):
                for a in n.names:
                    claimed.add(a.name)
                    if n.module == f"{PACKAGE}.kernels":
                        aliases.add(a.asname or a.name)
        for n in ast.walk(m.tree):
            if isinstance(n, ast.Attribute) and isinstance(n.value, ast.Name) \
                    and n.value.id in aliases:
                claimed.add(n.attr)
    return claimed


def _reachable_from(ctx, roots: Set[str]) -> Set[int]:
    """ids of defs reachable (same module) from any def named in roots:
    direct calls, partial refs, plain name references."""
    by_name = {}
    for n in ast.walk(ctx.tree):
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef)):
            by_name.setdefault(n.name, []).append(n)
    reach: Set[int] = set()
    work = [d for nm in roots for d in by_name.get(nm, [])]
    while work:
        d = work.pop()
        if id(d) in reach:
            continue
        reach.add(id(d))
        for sub in ast.walk(d):
            if isinstance(sub, ast.Name) and sub.id in by_name:
                work.extend(by_name[sub.id])
    return reach


def _project_check(project):
    claimed = _claimed_kernel_names(project)
    for ctx in project.modules:
        rel = ctx.rel
        if not profile.in_scope(rel, profile.PAD_FOLD_SCOPE):
            continue
        exempt_defs: Set[int] = set()
        if profile.is_sparse_kernel_module(rel):
            # package __init__ re-exports: a name claimed from the
            # package claims the def in whichever module defines it
            exempt_defs = _reachable_from(ctx, claimed)
        for n in ast.walk(ctx.tree):
            if not isinstance(n, ast.Call):
                continue
            is_fold, name = _is_fold_call(n)
            if not is_fold:
                continue
            # the fold's own def, or any def it is nested in, is claimed
            if any(id(a) in exempt_defs for a in ctx.ancestors(n)
                   if isinstance(a, (ast.FunctionDef, ast.AsyncFunctionDef,
                                     ast.Lambda))):
                continue
            if _inside_ring_registration(ctx, n):
                continue
            if _masked(ctx, n):
                continue
            yield ctx.finding(
                "pad-fold", n,
                f"raw reduction {name}(dim=...) in a padded-layout "
                f"module — pad slots fold in unless the ring "
                f"annihilates them; mask it, register it as a ring "
                f"fast path, or suppress naming the capability gate "
                f"that makes it sound")


register_rule(Rule(
    id="pad-fold",
    summary="pad-axis reductions are masked, ring-registered, or "
            "capability-gated",
    invariant="In the padded-layout modules (ELL/SELL-C-σ/halo), any raw "
              "dim reduction must be provably pad-sound: registered as "
              "a ring fast path, reachable only through backend "
              "capability gates, or explicitly masked.  Cross-references "
              "the grblas/backends.py supports predicates — the runtime "
              "half of the same invariant.",
    project_check=_project_check,
))
