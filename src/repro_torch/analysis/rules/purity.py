"""Hot-path purity rules.

``hot-purity``: the continuation hot loop — solver drivers, the
p-Laplacian operator stack, the kernel packages, the serve bucket lane —
stays on torch and the grblas algebra.  A scipy call there is host math
the GraphBLAS formulation forbids (``profile.SCIPY_BAN``); in the
pure-device modules numpy itself is banned (``profile.NUMPY_BAN``),
since every numpy call on device data is a copy to the host and back.
The reference's third check, numpy/scipy inside a traced scope
anywhere, has no counterpart: the port traces nothing (no
``torch.compile``, ``torch.vmap`` or ``torch.jit`` on its path).

The reference's np→jnp fixer is not carried over: np→torch is not a
mechanical rewrite, because torch's dtype defaults (float32, int64) and
device placement differ from numpy's, so each violation needs a human.

``dense-matmul`` is the multilevel contract: Galerkin coarse operators
are built exclusively through ``api.mxm`` — no ``@``, no
``torch.matmul``/``mm``/``bmm``/``einsum``/``tensordot``, and no
``.to_dense()``/``.toarray()`` densification.
"""
from __future__ import annotations

import ast

from repro_torch.analysis import profile
from repro_torch.analysis.core import Rule, register_rule
from repro_torch.analysis.scopes import dotted_name


def _module_of(call_name: str) -> str:
    head = call_name.split(".", 1)[0]
    if head in ("np", "numpy"):
        return "numpy"
    if head in ("scipy", "sp"):
        return "scipy"
    return ""


def _imports(ctx):
    """Imported top-level module names -> canonical library name."""
    out = {}
    for n in ast.walk(ctx.tree):
        if isinstance(n, ast.Import):
            for a in n.names:
                root = a.name.split(".")[0]
                if root in ("numpy", "scipy"):
                    out[a.asname or root] = root
        elif isinstance(n, ast.ImportFrom) and n.module:
            root = n.module.split(".")[0]
            if root in ("numpy", "scipy"):
                out.setdefault(root, root)
    return out


def _check_purity(ctx):
    rel = ctx.rel
    ban_scipy = profile.in_scope(rel, profile.SCIPY_BAN)
    ban_numpy = profile.in_scope(rel, profile.NUMPY_BAN)
    imported = _imports(ctx)

    # import statements in banned modules fail at the import line — the
    # clearest possible location for "this package must not know scipy"
    for n in ast.walk(ctx.tree):
        if isinstance(n, (ast.Import, ast.ImportFrom)):
            names = ([a.name for a in n.names] if isinstance(n, ast.Import)
                     else [n.module or ""])
            for name in names:
                root = name.split(".")[0]
                if root == "scipy" and ban_scipy:
                    yield ctx.finding(
                        "hot-purity", n,
                        "scipy import in a hot-path module — the solver/"
                        "kernel stack runs on the grblas algebra only")
                elif root == "numpy" and ban_numpy:
                    yield ctx.finding(
                        "hot-purity", n,
                        "numpy import in a pure-device module — use torch")

    # calls: banned-module calls anywhere in scoped files
    for n in ast.walk(ctx.tree):
        if not isinstance(n, ast.Call):
            continue
        name = dotted_name(n.func)
        if not name:
            continue
        lib = _module_of(name)
        if not lib or name.split(".", 1)[0] not in (
                set(imported) | {"np", "scipy"}):
            continue
        if lib == "scipy" and ban_scipy:
            yield ctx.finding(
                "hot-purity", n,
                f"scipy call {name}() in a hot-path module")
        elif lib == "numpy" and ban_numpy:
            yield ctx.finding(
                "hot-purity", n,
                f"numpy call {name}() in a pure-device module — use torch")


register_rule(Rule(
    id="hot-purity",
    summary="no numpy/scipy reachable from the solver/kernel hot path",
    invariant="Solver drivers, the plap/grassmann/lobpcg stack, the "
              "kernel packages and the serve bucket lane consume torch "
              "and the grblas algebra (api.mxm rings) only; scipy there "
              "is host math the GraphBLAS formulation forbids, and numpy "
              "in the pure-device modules is a copy to the host and "
              "back.",
    check=_check_purity,
))


_DENSE_FNS = frozenset({
    "matmul", "mm", "bmm", "mv", "dot", "vdot", "inner", "outer",
    "einsum", "tensordot", "addmm", "baddbmm", "chain_matmul",
})
_DENSE_METHODS = frozenset({"matmul", "mm", "bmm", "mv"})
_DENSIFY = frozenset({"toarray", "todense", "to_dense"})


def _check_dense(ctx):
    if not profile.in_scope(ctx.rel, profile.DENSE_MATMUL_BAN):
        return
    for n in ast.walk(ctx.tree):
        if (isinstance(n, ast.BinOp) and isinstance(n.op, ast.MatMult)):
            yield ctx.finding(
                "dense-matmul", n,
                "dense '@' product — Galerkin/coarse operators route "
                "through api.mxm (spgemm backend)")
        elif isinstance(n, ast.Call):
            name = dotted_name(n.func) or ""
            head, _, fn = name.rpartition(".")
            if fn in _DENSE_FNS and head in ("torch", "torch.linalg", "np",
                                             "numpy"):
                yield ctx.finding(
                    "dense-matmul", n,
                    f"dense product {name}() — route through api.mxm")
            elif (isinstance(n.func, ast.Attribute)
                  and n.func.attr in _DENSE_METHODS
                  and head not in ("torch", "torch.linalg", "np", "numpy")):
                yield ctx.finding(
                    "dense-matmul", n,
                    f"dense product .{n.func.attr}() — route through "
                    f"api.mxm")
            elif isinstance(n.func, ast.Attribute) and n.func.attr in _DENSIFY:
                yield ctx.finding(
                    "dense-matmul", n,
                    f"sparse->dense densification (.{n.func.attr}()) in "
                    f"the multilevel package")


register_rule(Rule(
    id="dense-matmul",
    summary="multilevel coarse operators are built via api.mxm only",
    invariant="The Galerkin triple product P^T (W P) and every other "
              "coarse-operator construction goes through the spgemm "
              "backend of api.mxm — no dense '@'/matmul/mm/bmm/einsum/"
              "tensordot and no .to_dense()/.toarray() densification in "
              "repro_torch/multilevel/.",
    check=_check_dense,
))
