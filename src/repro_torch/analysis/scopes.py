"""Hot-scope detection: which statements run once a solver-loop step.

The reference's rules key off JAX traced scopes (``jit``/``scan``/
``pallas_call`` bodies).  Eager torch has none of those on its path:
a host sync costs time wherever it sits, and costs most where it runs
once an iteration.  So the host-sync rule shares a different structural
fact, computed once a module by ``ScopeInfo`` and shared via
``ModuleContext.scopes``: in the hot modules (``profile.HOST_SYNC_SCOPE``)

1. the test and body of every ``for``/``while`` and every comprehension
   (defs and lambdas written inside them included), and
2. the bodies of same-module defs called by name from any of these,
   transitively (the closure, as the reference closes over its traced
   scopes; a def merely nested in a reached def is in only if something
   hot calls it).

Cross-module calls are not followed: the callee module is scanned on
its own.  The approximation errs towards flagging: a call the closure
cannot resolve stays outside, but everything lexically in a loop is in.
"""
from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set

from repro_torch.analysis import profile

_DEF_NODES = (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)
LOOP_NODES = (ast.For, ast.AsyncFor, ast.While, ast.ListComp, ast.SetComp,
              ast.DictComp, ast.GeneratorExp)


def dotted_name(node: ast.AST) -> Optional[str]:
    """'a.b.c' for a Name/Attribute chain, else None."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def loop_parts(loop: ast.AST) -> List[ast.AST]:
    """The nodes of ``loop`` that run once an iteration: a for's body
    and else (not its iterable, evaluated once), a while's test and body,
    a comprehension's element, conditions and inner iterables."""
    if isinstance(loop, (ast.For, ast.AsyncFor)):
        return list(loop.body) + list(loop.orelse)
    if isinstance(loop, ast.While):
        return [loop.test] + list(loop.body) + list(loop.orelse)
    out: List[ast.AST] = []
    for i, g in enumerate(loop.generators):
        out.extend(g.ifs)
        if i > 0:
            out.append(g.iter)
    if isinstance(loop, ast.DictComp):
        out += [loop.key, loop.value]
    else:
        out.append(loop.elt)
    return out


def _walk_own(node: ast.AST):
    """``ast.walk(node)``, except that a def's walk skips the bodies of
    the defs nested in it (a loop's statements are walked whole: what is
    written in a loop runs there)."""
    if not isinstance(node, _DEF_NODES):
        yield from ast.walk(node)
        return
    todo = [node]
    while todo:
        cur = todo.pop()
        yield cur
        todo.extend(c for c in ast.iter_child_nodes(cur)
                    if not isinstance(c, _DEF_NODES))


class ScopeInfo:
    """Per-module hot-scope map (see module docstring for the rules)."""

    def __init__(self, ctx):
        self.ctx = ctx
        self.hot_defs: Set[int] = set()
        self.hot_nodes: Set[int] = set()
        if profile.in_scope(ctx.rel, profile.HOST_SYNC_SCOPE):
            self._build()

    def _build(self) -> None:
        by_name: Dict[str, List[ast.AST]] = {}
        for n in ast.walk(self.ctx.tree):
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef)):
                by_name.setdefault(n.name, []).append(n)
            # lambdas bound to a simple name participate in lookup too
            elif (isinstance(n, ast.Assign) and len(n.targets) == 1
                  and isinstance(n.targets[0], ast.Name)
                  and isinstance(n.value, ast.Lambda)):
                by_name.setdefault(n.targets[0].id, []).append(n.value)
        work: List[ast.AST] = []
        for n in ast.walk(self.ctx.tree):
            if isinstance(n, LOOP_NODES):
                for part in loop_parts(n):
                    work.append(part)
                    self.hot_nodes.update(id(sub) for sub in ast.walk(part))
        # closure: defs called by name from hot code are hot
        seen: Set[int] = set()
        while work:
            node = work.pop()
            if id(node) in seen:
                continue
            seen.add(id(node))
            for sub in _walk_own(node):
                if isinstance(sub, ast.Call) and isinstance(sub.func,
                                                           ast.Name):
                    for d in by_name.get(sub.func.id, []):
                        if id(d) not in self.hot_defs:
                            self.hot_defs.add(id(d))
                            work.append(d)

    def is_hot(self, node: ast.AST) -> bool:
        """Does ``node`` run once a loop iteration of a hot module
        (lexically in a loop, or in a def the loops reach)?"""
        if id(node) in self.hot_nodes:
            return True
        d = self.ctx.enclosing_def(node)
        return d is not None and id(d) in self.hot_defs
