"""Rebuild-hazard rules — the static complement of the runtime detector
in ``obs/retrace.py``.

The port's one-build-per-bucket contract (``registry.memoized`` keyed on
the bucket and solver signature) and its one-build-per-process kernels
(``kernels/nvcc.py``: a ``NvccLibrary`` builds on first use and keeps
the opened library) die by a thousand cuts: a kernel library or a
compiled callable constructed per loop iteration, a mutable default
argument changing under a memo key.  The runtime detector sees the
rebuilds after they happen; these rules flag the shapes of code that
cause them before anything runs.

* ``retrace-loop-jit`` — a build or compile executed inside a
  ``for``/``while`` body: ``NvccLibrary(...)`` (each object builds and
  opens its own library; module-level libraries are the memo),
  ``torch.utils.cpp_extension.load``/``load_inline``, ``torch.compile``,
  ``torch.jit.script``/``trace``.  Route through ``registry.memoized``
  or hoist it to module level.
* ``retrace-mutable-default`` — ``def f(x, opts={})`` in a hot module:
  the default is one shared object whose mutation is invisible to every
  memo keyed on the arguments.  Fixed mechanically by the shipped fixer
  (``opts=None`` + a guard line).

The reference's ``retrace-static`` (a jitted signature taking a config
object without ``static_argnames``) has no counterpart: eager torch
keeps no trace cache keyed on arguments.
"""
from __future__ import annotations

import ast

from repro_torch.analysis import profile
from repro_torch.analysis.core import Rule, register_rule
from repro_torch.analysis.scopes import dotted_name

# calls that build a kernel or compile a callable
BUILD_CALLS = frozenset({
    "NvccLibrary", "nvcc.NvccLibrary",
    "torch.utils.cpp_extension.load", "cpp_extension.load",
    "torch.utils.cpp_extension.load_inline", "cpp_extension.load_inline",
    "torch.compile", "torch.jit.script", "torch.jit.trace",
})

# memoization shims that make a loop-local build safe
_MEMO_CALLS = frozenset({"memoized", "registry.memoized"})


def _enclosing_loop(ctx, node):
    for anc in ctx.ancestors(node):
        if isinstance(anc, (ast.For, ast.While, ast.AsyncFor)):
            return anc
        if isinstance(anc, (ast.FunctionDef, ast.AsyncFunctionDef,
                            ast.Lambda)):
            # a def inside the loop is a fresh scope: building inside a
            # *function defined in* a loop is that function's problem at
            # its own call sites
            return None
    return None


def _under_memo(ctx, node) -> bool:
    """Is this build inside a build-callable handed to the registry memo
    (``registry.memoized(key, build)``)?"""
    for anc in ctx.ancestors(node):
        if isinstance(anc, ast.Call):
            nm = dotted_name(anc.func) or ""
            if nm in _MEMO_CALLS or nm.endswith(".memoized"):
                return True
    return False


def _check_loop_jit(ctx):
    for n in ast.walk(ctx.tree):
        if not (isinstance(n, ast.Call) and dotted_name(n.func) in BUILD_CALLS):
            continue
        loop = _enclosing_loop(ctx, n)
        if loop is None or _under_memo(ctx, n):
            continue
        yield ctx.finding(
            "retrace-loop-jit", n,
            f"{dotted_name(n.func)}() constructed inside a loop body — a "
            f"fresh library or compiled callable per iteration builds per "
            f"iteration; hoist it to module level or route through "
            f"registry.memoized")


register_rule(Rule(
    id="retrace-loop-jit",
    summary="no kernel build or compile constructed per loop iteration",
    invariant="The p-continuation and serve lanes hold one built solve "
              "per execution signature (registry.memoized) and one "
              "library per kernel per process (kernels/nvcc.py); "
              "constructing an NvccLibrary, a cpp_extension, "
              "torch.compile or torch.jit inside a for/while body defeats "
              "both, because the object is fresh each pass.",
    check=_check_loop_jit,
))


def _mutable_defaults(d):
    args = d.args
    out = []
    for a, default in zip(
            (args.posonlyargs + args.args)[-len(args.defaults):]
            if args.defaults else [], args.defaults):
        if _is_mutable(default):
            out.append((a.arg, default))
    for a, default in zip(args.kwonlyargs, args.kw_defaults):
        if default is not None and _is_mutable(default):
            out.append((a.arg, default))
    return out


def _is_mutable(node) -> bool:
    if isinstance(node, (ast.List, ast.Dict, ast.Set)):
        return True
    if isinstance(node, ast.Call):
        return dotted_name(node.func) in ("list", "dict", "set")
    return False


def _check_mutable_default(ctx):
    if not profile.in_scope(ctx.rel, profile.MUTABLE_DEFAULT_SCOPE):
        return
    for n in ast.walk(ctx.tree):
        if not isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        for name, default in _mutable_defaults(n):
            yield ctx.finding(
                "retrace-mutable-default", default,
                f"mutable default {name}={ast.unparse(default)} on a "
                f"hot-path def — one shared object whose changes escape "
                f"every memo keyed on the arguments; default to None and "
                f"guard in the body")


def _fix_mutable_default(ctx, findings):
    """Mechanical B006-style repair: ``opts={}`` becomes ``opts=None``
    plus an ``if opts is None: opts = {}`` guard as the first body
    statement.  Only fires on single-line defs whose default literal is
    textually unambiguous on its line."""
    lines = ctx.source.splitlines()
    edits = []     # (def node, param name, default node)
    for n in ast.walk(ctx.tree):
        if not isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        for name, default in _mutable_defaults(n):
            if any(f.line == default.lineno for f in findings):
                edits.append((n, name, default))
    if not edits:
        return None
    changed = False
    # textual edits bottom-up so line numbers stay valid
    for d, name, default in sorted(edits, key=lambda e: -e[2].lineno):
        i = default.lineno - 1
        literal = ast.unparse(default)
        frag = f"{name}={literal}"
        if frag not in lines[i]:
            continue
        lines[i] = lines[i].replace(frag, f"{name}=None", 1)
        body_line = d.body[0].lineno - 1
        indent = " " * (len(lines[body_line])
                        - len(lines[body_line].lstrip()))
        guard = f"{indent}if {name} is None:\n{indent}    {name} = {literal}"
        # insert after a docstring, before the first real statement
        insert_at = body_line
        first = d.body[0]
        if (isinstance(first, ast.Expr)
                and isinstance(first.value, ast.Constant)
                and isinstance(first.value.value, str) and len(d.body) > 1):
            insert_at = d.body[1].lineno - 1
        lines.insert(insert_at, guard)
        changed = True
    return "\n".join(lines) + "\n" if changed else None


register_rule(Rule(
    id="retrace-mutable-default",
    summary="no mutable default arguments on hot-path defs",
    invariant="Defaults on the defs of the hot modules are hashable "
              "constants: a {}/[] default is one "
              "shared mutable object whose content changes invisibly to "
              "the memo keys of registry.memoized and across calls.",
    check=_check_mutable_default,
    fix=_fix_mutable_default,
))
