"""Dtype-hygiene rule.

The port's device containers are caller-dtype values + int32 indices
by construction (the layout builders allocate the target dtype and
int32 directly); float64 pipelines opt in *per call* by passing a
dtype.  The invariant is about what crosses the device boundary — host
numpy staging code routinely (and correctly) uses int64 fold keys and
is not this rule's business.

``dtype-hygiene`` flags, inside the device-feeding subsystems
(``profile.DTYPE_SCOPE``):

* 64-bit dtype references on the **torch** namespace (``torch.float64``,
  ``torch.double``, ``torch.int64``, ``torch.long``, ``torch.uint64``,
  ``torch.complex128``, ``torch.cdouble``) and the ``.double()`` /
  ``.long()`` casts anywhere — device code never hardcodes width; it
  takes the caller's dtype (a comparison, ``X.dtype == torch.float64``,
  or a per-dtype table's key reads the caller's dtype and is not
  flagged) (torch's own index ops that require int64,
  ``gather``/``scatter_add_``, are the structural exception a
  suppression names);
* tensor constructors (``torch.zeros``/``empty``/``as_tensor``/
  ``tensor``/``from_numpy``/...) with no explicit dtype in the layout-
  build functions (``_build_*`` in ``grblas/containers.py``), unless the
  operand is a host array the builder already pinned (a local bound to,
  or an operand that is, an ``.astype()`` or a dtype-carrying
  constructor) — torch's defaults
  (int64 for integer data, float64 for numpy float64 arrays) silently
  double index/value memory, and at the 8M-node scale that is
  gigabytes.

The reference's second check, a numpy 64-bit dtype fed to a jnp
constructor, has no torch counterpart: torch constructors take torch
dtypes only, so the first check covers it.
"""
from __future__ import annotations

import ast

from repro_torch.analysis import profile
from repro_torch.analysis.core import Rule, register_rule
from repro_torch.analysis.scopes import dotted_name

_WIDE = frozenset({"int64", "long", "float64", "double", "uint64",
                   "complex128", "cdouble"})
_WIDE_CASTS = frozenset({"double", "long"})
_NP = ("np", "numpy")
_CONSTRUCTORS = frozenset({"zeros", "ones", "empty", "full", "arange",
                           "as_tensor", "tensor", "asarray", "array",
                           "from_numpy"})
# (fn -> n_positional_args) at which a positional dtype is present
_DTYPE_AT = {
    "torch": {"as_tensor": 2},
    "np": {"zeros": 2, "ones": 2, "empty": 2, "full": 3, "asarray": 2,
           "array": 2, "arange": 4},
}


def _split_api(call: ast.Call):
    """('torch'|'np'|'', fn_name) for a torch/np module-level call."""
    name = dotted_name(call.func) or ""
    head, _, fn = name.rpartition(".")
    if head == "torch":
        return "torch", fn
    if head in _NP:
        return "np", fn
    return "", fn


def _dtype_operand(call: ast.Call):
    """The expression occupying the dtype slot of a constructor call."""
    for kw in call.keywords:
        if kw.arg == "dtype":
            return kw.value
    api, fn = _split_api(call)
    at = _DTYPE_AT.get(api, {}).get(fn)
    if at is not None and len(call.args) >= at:
        return call.args[at - 1]
    return None


def _dtype_reads(tree) -> set:
    """ids of the dtype references that read the caller's dtype rather
    than hardcode one: comparison operands (``X.dtype == torch.float64``,
    ``dt in (torch.float32, torch.float64)``) and per-dtype table keys."""
    out = set()
    for n in ast.walk(tree):
        if isinstance(n, ast.Compare):
            for op in [n.left] + list(n.comparators):
                out.add(id(op))
                if isinstance(op, (ast.Tuple, ast.List, ast.Set)):
                    out.update(id(e) for e in op.elts)
        elif isinstance(n, ast.Dict):
            out.update(id(k) for k in n.keys if k is not None)
    return out


def _check_wide(ctx):
    """64-bit hardcodes that reach the device."""
    reads = _dtype_reads(ctx.tree)
    for n in ast.walk(ctx.tree):
        if (isinstance(n, ast.Attribute) and n.attr in _WIDE
                and dotted_name(n.value) == "torch"
                and id(n) not in reads):
            yield ctx.finding(
                "dtype-hygiene", n,
                f"64-bit device dtype torch.{n.attr} hardcoded — hot-path "
                f"code takes the caller's dtype; widen per call, not in "
                f"the module (or suppress naming why 64-bit is "
                f"structural)")
        elif (isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute)
              and n.func.attr in _WIDE_CASTS and not n.args
              and not n.keywords):
            yield ctx.finding(
                "dtype-hygiene", n,
                f".{n.func.attr}() cast hardcodes a 64-bit device dtype — "
                f"take the caller's dtype (or suppress naming why 64-bit "
                f"is structural)")


def _pinned_locals(fn: ast.AST) -> set:
    """Names bound in ``fn`` by expressions with a pinned dtype: a
    constructor carrying an explicit dtype (kwarg or positional slot)
    or an ``.astype(...)``/``.to(...)`` result."""
    pinned = set()
    for n in ast.walk(fn):
        if not isinstance(n, ast.Assign) or len(n.targets) != 1:
            continue
        tgt = n.targets[0]
        if not isinstance(tgt, ast.Name):
            continue
        if _pinned_expr(n.value):
            pinned.add(tgt.id)
    return pinned


def _pinned_expr(v: ast.AST) -> bool:
    """An ``.astype(...)``/``.to(...)`` result or a constructor carrying
    an explicit dtype."""
    if not isinstance(v, ast.Call):
        return False
    if isinstance(v.func, ast.Attribute) and v.func.attr in ("astype", "to"):
        return True
    return _dtype_operand(v) is not None


def _check_builders(ctx):
    """Layout builders pin dtype on every device-boundary constructor."""
    if ctx.rel not in profile.LAYOUT_BUILD_MODULES:
        return
    for fn in ast.walk(ctx.tree):
        if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        if not fn.name.startswith(profile.LAYOUT_BUILD_PREFIXES):
            continue
        pinned = _pinned_locals(fn)
        for sub in ast.walk(fn):
            if not isinstance(sub, ast.Call):
                continue
            api, f = _split_api(sub)
            if api != "torch" or f not in _CONSTRUCTORS:
                continue
            if _dtype_operand(sub) is not None:
                continue
            arg = sub.args[0] if sub.args else None
            if (isinstance(arg, ast.Name) and arg.id in pinned) \
                    or _pinned_expr(arg):
                continue        # host array already pinned; torch keeps it
            yield ctx.finding(
                "dtype-hygiene", sub,
                f"torch.{f}() without an explicit dtype at the device "
                f"boundary of a layout builder — torch's defaults "
                f"silently widen the layout to int64/float64; pin int32 "
                f"for indices / the target dtype for values")


def _check(ctx):
    if not profile.in_scope(ctx.rel, profile.DTYPE_SCOPE):
        return
    yield from _check_wide(ctx)
    yield from _check_builders(ctx)


register_rule(Rule(
    id="dtype-hygiene",
    summary="no hardcoded 64-bit device dtypes; layout builders pin "
            "every boundary constructor",
    invariant="Device containers are caller-dtype values + int32 indices; "
              "device code never hardcodes torch 64-bit dtypes "
              "(torch.float64/double/int64/long, .double()/.long()) and "
              "layout builders pin dtype on every tensor constructor, so "
              "torch's int64/float64 defaults cannot silently double "
              "index/value memory.",
    check=_check,
))
