"""Host-sync rule: no device-to-host read once a solver-loop step.

In eager torch every read of a CUDA tensor's value on the host blocks
until the card has finished all queued work, and then the host has to
queue the next kernels from scratch: the card idles for the round trip.
Inside a hot loop (``analysis.scopes``: the loops of the hot modules and
what they call) that is once an iteration.  ``host-sync`` flags, there:

* ``.item()``, ``.tolist()``, ``.cpu()``, ``.numpy()``, ``.to("cpu")``;
* ``torch.cuda.synchronize()``, ``torch.equal``/``torch.allclose``
  (both return a Python bool), ``np.asarray``/``np.array`` of a value;
* ``float()``/``int()``/``bool()``/``complex()`` of a non-literal;
* a Python ``if``/``while``/``assert``/conditional expression whose test
  is a tensor — an implicit ``bool(tensor)`` (the reference's separate
  ``traced-branch`` rule; in eager torch it is the same sync, so it is
  folded in here under this id).

Telling a tensor from a Python number without types errs towards
flagging.  An operand counts as a Python value only when it is a
literal, reads names only through static metadata (``.shape``,
``.ndim``, ``.dtype``, ``.device``, ``.size()``, ``.numel()``,
``.dim()``, ``len()``), or is a name the enclosing def binds to one: a
parameter annotated ``int``/``float``/``bool``/``str``, a ``range()``
loop counter, or a name assigned only literals.  Everything else —
attributes of results, call results, unannotated parameters — is taken
for a tensor.  A test is a tensor when it calls a ``torch.`` function
(other than the host-valued ones: ``torch.is_*``, ``torch.cuda.*``,
``torch.distributed.*``, dtype/device queries) or a tensor reduction
method (``.any()``, ``.all()``, ``.max()`` ...) outside an explicit
concretizer, which is flagged on its own.
"""
from __future__ import annotations

import ast

from repro_torch.analysis.core import Rule, register_rule
from repro_torch.analysis.scopes import dotted_name

_CONCRETIZERS = ("float", "int", "bool", "complex")
_PULL_METHODS = frozenset({"item", "tolist", "cpu", "numpy"})
_PULL_CALLS = frozenset({
    "np.asarray", "np.array", "numpy.asarray", "numpy.array",
    "torch.equal", "torch.allclose", "torch.is_nonzero",
})
# attribute/call names that yield static python values even on tensors
_STATIC_ATTRS = frozenset({"ndim", "shape", "dtype", "device", "is_cuda",
                           "requires_grad"})
_STATIC_METHODS = frozenset({"size", "numel", "dim", "stride",
                             "element_size", "nelement"})
_PY_ANNOTATIONS = frozenset({"int", "float", "bool", "str"})
_MODULES = frozenset({"torch", "np", "numpy", "math"})
# torch namespaces and functions whose results are host values
_HOST_TORCH_PREFIXES = ("torch.cuda.", "torch.distributed.",
                        "torch.backends.", "torch.compiler.", "torch.jit.")
_HOST_TORCH_CALLS = frozenset({
    "torch.finfo", "torch.iinfo", "torch.device", "torch.dtype",
    "torch.Size", "torch.get_default_dtype",
    "torch.are_deterministic_algorithms_enabled",
})
# tensor methods whose result is a tensor a python test would bool()
_TENSOR_TEST_METHODS = frozenset({
    "any", "all", "max", "min", "sum", "mean", "norm", "amax", "amin",
    "isnan", "isinf", "isfinite", "count_nonzero", "abs",
})


def _annotation_is_python(ann) -> bool:
    """int / float / bool / str, or Optional[...] of one."""
    if ann is None:
        return False
    name = dotted_name(ann)
    if name in _PY_ANNOTATIONS:
        return True
    if isinstance(ann, ast.Subscript) and dotted_name(ann.value) in (
            "Optional", "typing.Optional"):
        return _annotation_is_python(ann.slice)
    if isinstance(ann, ast.Constant) and isinstance(ann.value, str):
        return ann.value in _PY_ANNOTATIONS
    return False


def _python_names(ctx, node) -> set:
    """Names bound to Python values in the defs enclosing ``node``:
    parameters annotated with a Python scalar type, ``range()`` loop
    counters, and names assigned only literals."""
    names, assigned = set(), {}
    d = ctx.enclosing_def(node)
    while d is not None:
        args = d.args
        for a in args.posonlyargs + args.args + args.kwonlyargs:
            if _annotation_is_python(a.annotation):
                names.add(a.arg)
        for sub in ast.walk(d):
            if (isinstance(sub, (ast.For, ast.comprehension))
                    and isinstance(sub.target, ast.Name)
                    and isinstance(sub.iter, ast.Call)
                    and dotted_name(sub.iter.func) == "range"):
                names.add(sub.target.id)
            elif isinstance(sub, ast.Assign):
                for t in sub.targets:
                    if isinstance(t, ast.Name):
                        ok = isinstance(sub.value, ast.Constant)
                        assigned[t.id] = assigned.get(t.id, True) and ok
            elif (isinstance(sub, ast.AugAssign)
                  and isinstance(sub.target, ast.Name)):
                ok = isinstance(sub.value, ast.Constant)
                assigned[sub.target.id] = assigned.get(sub.target.id,
                                                       True) and ok
        d = ctx.enclosing_def(d)
    return names | {n for n, ok in assigned.items() if ok}


def _static_only(node: ast.AST, python_names) -> bool:
    """True when every name read in ``node`` is a known Python value, a
    module constant (``torch.float64``, ``math.pi``) or goes through
    static metadata (shape/ndim/dtype/size()/len()); a ``torch.`` call
    yields a tensor."""
    class V(ast.NodeVisitor):
        dynamic = False

        def visit_Attribute(self, a):
            if a.attr in _STATIC_ATTRS:
                return          # don't descend: x.shape is static
            if (dotted_name(a) or "").split(".")[0] in _MODULES:
                return          # a module constant
            self.generic_visit(a)

        def visit_Call(self, c):
            name = dotted_name(c.func) or ""
            if name == "len":
                return          # len(tuple or tensor) is a Python int
            if (isinstance(c.func, ast.Attribute)
                    and c.func.attr in _STATIC_METHODS):
                return          # x.size(0) / x.numel(): Python ints
            if _torch_tensor_call(name):
                self.dynamic = True
                return
            self.generic_visit(c)

        def visit_Name(self, nm):
            if nm.id not in python_names and nm.id not in _MODULES:
                self.dynamic = True

    v = V()
    v.visit(node)
    return not v.dynamic


def _torch_tensor_call(name: str) -> bool:
    """A ``torch.`` function whose result is a tensor."""
    return (name.startswith("torch.")
            and not name.startswith(_HOST_TORCH_PREFIXES)
            and name not in _HOST_TORCH_CALLS
            and not name.startswith("torch.is_"))


def _explicit_pull(n: ast.Call) -> bool:
    """An explicit concretizer or pull (flagged at its own call)."""
    name = dotted_name(n.func) or ""
    if isinstance(n.func, ast.Name) and n.func.id in _CONCRETIZERS:
        return True
    if isinstance(n.func, ast.Attribute) and n.func.attr in _PULL_METHODS:
        return True
    return name in _PULL_CALLS


def _tensor_test(test: ast.AST) -> bool:
    """Does ``test`` evaluate a tensor that python would bool()?"""
    def walk(node):
        if isinstance(node, ast.Call) and _explicit_pull(node):
            return False        # the explicit pull is flagged on its own
        if isinstance(node, ast.Call):
            if _torch_tensor_call(dotted_name(node.func) or ""):
                return True
            if (isinstance(node.func, ast.Attribute)
                    and node.func.attr in _TENSOR_TEST_METHODS
                    and not node.args and not node.keywords):
                return True
        return any(walk(c) for c in ast.iter_child_nodes(node))
    return walk(test)


def _check_hostsync(ctx):
    scopes = ctx.scopes
    for n in ast.walk(ctx.tree):
        if isinstance(n, (ast.If, ast.While, ast.Assert, ast.IfExp)):
            if scopes.is_hot(n.test) and _tensor_test(n.test):
                what = {"If": "if", "While": "while", "Assert": "assert",
                        "IfExp": "conditional expression"}[type(n).__name__]
                yield ctx.finding(
                    "host-sync", n,
                    f"python {what} on a tensor inside a hot loop — an "
                    f"implicit bool(tensor), one device sync per pass; "
                    f"keep the decision on the device (torch.where) or "
                    f"test every few steps")
            continue
        if not (isinstance(n, ast.Call) and scopes.is_hot(n)):
            continue
        name = dotted_name(n.func) or ""
        if (isinstance(n.func, ast.Attribute)
                and n.func.attr in _PULL_METHODS and not n.args):
            yield ctx.finding(
                "host-sync", n,
                f".{n.func.attr}() inside a hot loop — a device-to-host "
                f"copy that waits for the card once a pass; keep the value "
                f"on the device or read it after the loop")
        elif (isinstance(n.func, ast.Attribute) and n.func.attr == "to"
                and n.args and isinstance(n.args[0], ast.Constant)
                and n.args[0].value == "cpu"):
            yield ctx.finding(
                "host-sync", n,
                ".to('cpu') inside a hot loop — a device-to-host copy that "
                "waits for the card once a pass")
        elif name == "torch.cuda.synchronize":
            yield ctx.finding(
                "host-sync", n,
                f"{name}() inside a hot loop — the host waits for the card "
                f"once a pass")
        elif name in _PULL_CALLS:
            if not (n.args and _static_only(n.args[0],
                                            _python_names(ctx, n))):
                yield ctx.finding(
                    "host-sync", n,
                    f"{name}() inside a hot loop reads a tensor on the "
                    f"host — a device sync once a pass")
        elif (isinstance(n.func, ast.Name) and n.func.id in _CONCRETIZERS
                and n.args and not isinstance(n.args[0], ast.Constant)
                and not _static_only(n.args[0], _python_names(ctx, n))):
            yield ctx.finding(
                "host-sync", n,
                f"{n.func.id}() of a value that may be a tensor inside a "
                f"hot loop — a device sync once a pass; keep it a tensor "
                f"or read it after the loop")


register_rule(Rule(
    id="host-sync",
    summary="no device-to-host reads inside the hot path's loops",
    invariant="Code that runs once a solver-loop step (the loops of the "
              "hot modules and what they call in the same module) "
              "never calls .item()/"
              ".tolist()/.cpu()/.numpy(), float()/int()/bool() of a "
              "tensor, torch.cuda.synchronize(), or branches in python "
              "on a tensor — each blocks the host on the card once an "
              "iteration, which no kernel benchmark shows.",
    check=_check_hostsync,
))
