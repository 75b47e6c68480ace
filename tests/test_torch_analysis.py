"""Self-tests for the port's pscheck (``repro_torch.analysis``), mirroring
``tests/test_analysis.py``.

Every kept rule gets a *positive* fixture (a minimal torch snippet that
violates the invariant and must be flagged) and a *negative* fixture
(the compliant counterpart that must stay silent).  Contexts are built
with synthetic ``repro_torch``-relative paths so the scope tables in
``analysis/profile.py`` apply without touching the real tree; the
end-to-end channels (suppressions, meta-rules, baseline, fixers, CLI)
run against real temp files.  Where a channel is framework-agnostic the
reference (``repro.analysis``, pure AST like the port's) is run on the
same input and must agree.  The gate pins ``src/repro_torch`` clean
modulo ``pscheck_torch_baseline.json``.
"""
import json
import os
import shutil
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

pytest.importorskip("torch")  # the reference-only CI has no torch

from repro import analysis as ref_analysis
from repro.analysis.core import ModuleContext as RefModuleContext
from repro.analysis.core import parse_suppressions as ref_parse_suppressions
from repro_torch import analysis
from repro_torch.analysis.core import (ModuleContext, ProjectContext,
                                       parse_suppressions)

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "src" / "repro_torch"
BASELINE = REPO / "pscheck_torch_baseline.json"


def _ctx(rel: str, source: str) -> ModuleContext:
    """A parsed module at a synthetic repro_torch-relative path (never
    read from disk — source is given)."""
    return ModuleContext(Path("/fx/repro_torch") / rel,
                         source=textwrap.dedent(source))


def _findings(rule_id: str, *ctxs):
    rule = analysis.registered_rules()[rule_id]
    out = []
    for ctx in ctxs:
        if rule.check is not None:
            out.extend(rule.check(ctx))
    if rule.project_check is not None:
        out.extend(rule.project_check(ProjectContext(list(ctxs))))
    return [f for f in out if f.rule == rule_id]


def _rules_of(findings):
    return sorted({f.rule for f in findings})


# ------------------------------------------------------------- hot-purity

def test_hot_purity_positive():
    bad = _ctx("core/solvers/newtonish.py", """
        import torch
        import scipy.sparse.linalg as spla
        from scipy.sparse.linalg import eigsh

        def run(A, k):
            return torch.as_tensor(scipy.linalg.eigh(A)[0]), spla
    """)
    dev = _ctx("core/lobpcg.py", """
        import numpy as np
        import torch

        def ortho(x):
            return torch.as_tensor(np.linalg.qr(x)[0])
    """)
    fs = _findings("hot-purity", bad, dev)
    msgs = " ".join(f.message for f in fs)
    assert "scipy import" in msgs          # banned outright in core/solvers/
    assert "scipy call scipy.linalg.eigh()" in msgs
    assert "numpy import in a pure-device module" in msgs
    assert "numpy call np.linalg.qr()" in msgs
    assert any(f.symbol == "run" for f in fs)


def test_hot_purity_negative():
    # torch-only solver code, numpy in a hot module that only bans
    # scipy, and *host-side* numpy in an unscoped module
    good = _ctx("core/solvers/ok.py", """
        import numpy as np
        import torch

        def run(x, sizes):
            return torch.sum(x * x), np.cumsum(sizes)
    """)
    host = _ctx("serve/queue.py", """
        import numpy as np

        def enqueue(items):
            return np.asarray(items)      # host assembly: legitimate
    """)
    assert _findings("hot-purity", good, host) == []


def test_hot_purity_ships_no_fixer(tmp_path):
    """The reference's np->jnp fixer is dropped: np->torch is not
    mechanical (dtype defaults and device placement differ)."""
    assert analysis.registered_rules()["hot-purity"].fix is None
    f = tmp_path / "repro_torch" / "core" / "plap.py"
    f.parent.mkdir(parents=True)
    f.write_text(textwrap.dedent("""
        import numpy as np

        def norm(x):
            return np.sqrt(np.sum(x * x))
    """))
    before = f.read_text()
    assert analysis.apply_fixes([f], rules=["hot-purity"]) == {}
    assert f.read_text() == before
    assert _rules_of(analysis.run([f], rules=["hot-purity"])) == [
        "hot-purity"]


# ----------------------------------------------------------- dense-matmul

def test_dense_matmul_positive():
    bad = _ctx("multilevel/galerkin.py", """
        import torch

        def coarse(P, A):
            dense = A.to_dense()
            Q = torch.mm(P.T, dense)
            return Q @ torch.einsum('ij,jk->ik', dense, P)
    """)
    msgs = " ".join(f.message for f in _findings("dense-matmul", bad))
    assert "'@'" in msgs and "einsum" in msgs and "torch.mm" in msgs
    assert "to_dense" in msgs


def test_dense_matmul_negative():
    # api.mxm routing in multilevel is the contract; '@' outside the
    # multilevel package (scf's small V.T @ U) is not this rule's scope
    good = _ctx("multilevel/galerkin.py", """
        from repro_torch.grblas import api

        def coarse(P, W, desc):
            WP = api.mxm(W, P.dense, desc=desc)
            return api.mxm(P.transpose(), WP, desc=desc)
    """)
    elsewhere = _ctx("core/solvers/scf.py", """
        import torch

        def rayleigh(V, U):
            return torch.mm(V.T, U) + V.T @ U
    """)
    assert _findings("dense-matmul", good, elsewhere) == []


# -------------------------------------------------------------- host-sync

def test_host_sync_positive():
    bad = _ctx("core/lobpcg.py", """
        import numpy as np
        import torch

        def solve(step, X, tol, iters: int):
            for it in range(iters):
                X, res = step(X)
                a = float(torch.max(res))
                b = res.item()
                c = res.tolist()
                d = np.asarray(res)
                e = X.cpu().numpy()
                torch.cuda.synchronize()
            return X
    """)
    fs = _findings("host-sync", bad)
    msgs = " ".join(f.message for f in fs)
    for what in ("float() of a value", ".item()", ".tolist()",
                 "np.asarray()", ".cpu()", ".numpy()",
                 "torch.cuda.synchronize()"):
        assert what in msgs, what
    assert all("hot loop" in f.message for f in fs)
    assert {f.symbol for f in fs} == {"solve"}


def test_host_sync_negative():
    good = _ctx("core/lobpcg.py", """
        import torch

        def solve(step, X, iters: int, tol: float):
            n = 0
            for it in range(iters):
                X, res = step(X)
                w = int(X.shape[1]) + int(it) + int(n) + int(tol)
                f64 = int(X.dtype == torch.float64)
                m = float(X.numel()) + len(res)
                n += 1
            return X, float(torch.max(res))   # after the loop: fine

        def host_read(res):
            return float(res.fval)            # no loop: fine
    """)
    unscoped = _ctx("graphs/mmio.py", """
        def read(lines):
            return [float(x) for x in lines]  # not a hot module
    """)
    assert _findings("host-sync", good, unscoped) == []


def test_host_sync_implicit_bool_positive():
    """The reference's traced-branch, folded into host-sync: python
    control flow on a tensor is an implicit bool(tensor)."""
    bad = _ctx("core/grassmann.py", """
        import torch

        def minimize(step, U):
            while torch.linalg.norm(U) > 1e-6:
                U = step(U)
                if (U < 0).any():
                    U = -U
                assert torch.isfinite(U).all()
            return U
    """)
    fs = _findings("host-sync", bad)
    kinds = sorted(f.message.split(" on a tensor")[0] for f in fs)
    assert kinds == ["python assert", "python if", "python while"]
    assert all("implicit bool(tensor)" in f.message for f in fs)


def test_host_sync_implicit_bool_negative():
    good = _ctx("core/grassmann.py", """
        import torch

        def minimize(step, U, mode="fast"):
            for it in range(10):
                if mode == "fast":                  # python compare
                    U = step(U)
                if torch.cuda.is_available():       # host-valued torch
                    U = U + 0
                U = torch.where(U < 0, -U, U)       # stays on the device
            return U

        def once(U):
            if torch.any(U < 0):                    # not in a loop
                return -U
            return U
    """)
    assert _findings("host-sync", good) == []


def test_host_sync_reaches_same_module_callees():
    """A def called by name from a hot loop is hot (once an iteration);
    a def merely nested in it is not, unless something hot calls it."""
    ctx = _ctx("core/kmeans.py", """
        def _step(X):
            return float(X.sum())

        def _view(metric):
            def fget(self):
                return int(self.read(metric))
            return property(fget)

        def lloyd(X, iters):
            views = [_view(m) for m in ("a", "b")]
            for _ in range(iters):
                X = X + _step(X)
            return X
    """)
    fs = _findings("host-sync", ctx)
    assert [(f.symbol, f.message.split()[0]) for f in fs] == [
        ("_step", "float()")]


def test_host_sync_in_comprehensions_and_while_tests():
    """A comprehension is a loop; a while's test runs every pass; a
    torch.equal / .to('cpu') reads the card as surely as .item()."""
    ctx = _ctx("serve/bucketing.py", """
        import torch

        def pad(mats, tol, ref):
            out = [m.to("cpu") for m in mats]
            flags = {i: torch.equal(m, ref) for i, m in enumerate(mats)}
            while float(tol.max()) > 1e-3:
                tol = tol / 2
            return out, flags
    """)
    fs = _findings("host-sync", ctx)
    assert sorted(f.message.split(" inside")[0] for f in fs) == [
        ".to('cpu')", "float() of a value that may be a tensor",
        "torch.equal()"]


# -------------------------------------------------------- retrace-loop-jit

def test_retrace_loop_jit_positive():
    bad = _ctx("serve/engine.py", """
        import torch
        from repro_torch.kernels.nvcc import NvccLibrary

        def sweep(fns, x, sources):
            out = []
            for fn in fns:
                out.append(torch.compile(fn)(x))
            for src in sources:
                lib = NvccLibrary("k", src, {})
                out.append(lib.load())
            return out
    """)
    fs = _findings("retrace-loop-jit", bad)
    assert len(fs) == 2 and all("memoized" in f.message for f in fs)
    assert {f.message.split("(")[0] for f in fs} == {"torch.compile",
                                                     "NvccLibrary"}


def test_retrace_loop_jit_negative():
    good = _ctx("serve/engine.py", """
        import torch
        from repro_torch.core.solvers import registry
        from repro_torch.kernels.nvcc import NvccLibrary

        LIBRARY = NvccLibrary("k", "k.cu", {})       # module level: once

        def sweep(fn, xs):
            cfn = torch.compile(fn)                  # hoisted: one build
            return [cfn(x) for x in xs]

        def memo_sweep(keys, build):
            out = []
            for k in keys:
                out.append(registry.memoized(k, lambda: torch.compile(build)))
                LIBRARY.load()                       # memoized per process
            return out

        def per_source(sources):
            return [lambda: NvccLibrary("k", s, {}) for s in sources]
    """)
    assert _findings("retrace-loop-jit", good) == []


# -------------------------------------------------- retrace-mutable-default

def test_retrace_mutable_default_positive():
    hot = _ctx("core/solvers/scf.py", """
        def step(x, opts={}):
            return x
    """)
    kernel = _ctx("kernels/segment_sum/segment_sum.py", """
        def launch(x, *, seen=list()):
            return x
    """)
    fs = _findings("retrace-mutable-default", hot, kernel)
    assert sorted(f.message.split()[2] for f in fs) == ["opts={}",
                                                        "seen=list()"]


def test_retrace_mutable_default_negative():
    good = _ctx("core/solvers/scf.py", """
        def step(x, opts=None):
            return x
    """)
    host = _ctx("graphs/mmio.py", """
        def host_helper(x, acc=[]):    # not a hot module: not this rule's job
            acc.append(x)
            return acc
    """)
    assert _findings("retrace-mutable-default", good, host) == []


def test_retrace_mutable_default_fixer(tmp_path):
    f = tmp_path / "repro_torch" / "serve" / "psc_engine.py"
    f.parent.mkdir(parents=True)
    f.write_text(textwrap.dedent("""
        def step(x, opts={}):
            \"\"\"Doc.\"\"\"
            return x
    """))
    changed = analysis.apply_fixes([f], rules=["retrace-mutable-default"])
    assert f in changed
    src = f.read_text()
    assert "opts=None" in src
    assert "if opts is None:" in src
    # the guard lands after the docstring and the repaired module is clean
    assert src.index('"""Doc."""') < src.index("if opts is None:")
    assert _findings("retrace-mutable-default",
                     ModuleContext(f, source=src)) == []


# ------------------------------------------------------------ api-boundary

def test_api_boundary_positive():
    bad = _ctx("core/aggregate.py", """
        import torch
        from repro_torch.kernels.sellcs_spmm import sellcs_spmm
        from repro_torch.kernels import bsr_spmm as K
        from repro_torch.kernels.segment_sum import segment_sum
        from repro_torch.grblas import backends as _backends

        def fold(x, ids, n):
            orig = _backends._REGISTRY["coo"]
            out = torch.zeros(n).index_add_(0, ids, x)
            return out.scatter_add_(0, ids, x), orig
    """)
    fs = _findings("api-boundary", bad)
    msgs = " ".join(f.message for f in fs)
    assert "raw index_add_" in msgs and "raw scatter_add_" in msgs
    assert "sellcs_spmm" in msgs and "bsr_spmm" in msgs
    assert "direct use of repro_torch.kernels.segment_sum" in msgs
    assert "private registry" in msgs


def test_api_boundary_negative():
    # the same shapes inside grblas/ and kernels/ are the implementation
    grblas = _ctx("grblas/api.py", """
        from repro_torch.kernels import sellcs_spmm as K
        from repro_torch.kernels.segment_sum import segment_sum
        from repro_torch.grblas import backends as _backends

        def execute(out, x, ids):
            _ = _backends._REGISTRY
            return out.index_add_(0, ids, x)
    """)
    kernel = _ctx("kernels/segment_sum/segment_sum.py", """
        def segment_sum_ref(out, x, ids):
            return out.index_add_(0, ids.long(), x)
    """)
    dense = _ctx("core/kmeans.py", """
        from repro_torch.kernels.kmeans_assign import kmeans_assign
    """)
    assert _findings("api-boundary", grblas, kernel, dense) == []


# ---------------------------------------------------------------- pad-fold

def test_pad_fold_positive():
    bad = _ctx("grblas/semiring.py", """
        import torch

        def fold_rows(padded_vals, contrib):
            return torch.sum(padded_vals, dim=1) + contrib.amax(axis=1)
    """)
    fs = _findings("pad-fold", bad)
    assert len(fs) == 2 and all("pad slots" in f.message for f in fs)


def test_pad_fold_negative_masked_and_registered():
    good = _ctx("grblas/semiring.py", """
        import torch

        def fold_rows(vals, cols, n):
            valid = torch.where(cols < n, vals, 0.0)
            return torch.sum(valid, dim=1)

        register_ring_fast_paths(
            "plus_times",
            dense=lambda vals: torch.sum(vals, dim=1),
        )
    """)
    assert _findings("pad-fold", good) == []


def test_pad_fold_negative_capability_gated_kernel():
    # a kernel entry point read off a kernel package imported by
    # grblas/backends.py runs only behind a supports gate — its internal
    # folds (and those of the plain twins it reaches) are claimed
    backends = _ctx("grblas/backends.py", """
        def _sellcs(A, X):
            from repro_torch.kernels import sellcs_spmm as K
            return K.sellcs_spmm(A, X)
    """)
    kernel = _ctx("kernels/sellcs_spmm/sellcs_spmm.py", """
        import torch

        def sellcs_spmm(cols, vals, X):
            return sellcs_spmm_ref(cols, vals, X)

        def sellcs_spmm_ref(cols, vals, X):
            return torch.sum(vals[..., None] * X[cols.long()], dim=1)

        def unclaimed(vals):
            return vals.sum(1)
    """)
    fs = _findings("pad-fold", backends, kernel)
    assert [f.symbol for f in fs] == ["unclaimed"]


# ------------------------------------------------------------ dtype-hygiene

def test_dtype_hygiene_positive():
    bad = _ctx("core/phi.py", """
        import torch

        def widen(x, n):
            a = torch.zeros(n, dtype=torch.float64)
            b = x.long()
            c = x.to(torch.int64)
            return a, b, c.double()
    """)
    builder = _ctx("grblas/containers.py", """
        import numpy as np
        import torch

        def _build_ell(self, cols):
            self.ell_cols = torch.as_tensor(cols)     # unpinned boundary
            self.ell_ptr = torch.from_numpy(np.cumsum(cols))
    """)
    fs = _findings("dtype-hygiene", bad, builder)
    msgs = " ".join(f.message for f in fs)
    assert "torch.float64" in msgs and "torch.int64" in msgs
    assert ".long() cast" in msgs and ".double() cast" in msgs
    assert "torch.as_tensor() without an explicit dtype" in msgs
    assert "torch.from_numpy() without an explicit dtype" in msgs


def test_dtype_hygiene_negative():
    # host-side 64-bit staging is the intended architecture: numpy fold
    # keys are pinned to 32-bit at the torch boundary; reading the
    # caller's dtype (a comparison, a per-dtype table) hardcodes nothing
    host = _ctx("multilevel/coarsen.py", """
        import numpy as np

        def match(rows, cols):
            key = rows.astype(np.int64) * (1 << 32) + cols
            return np.unique(key)
    """)
    reads = _ctx("kernels/bsr_spmm/bsr_spmm.py", """
        import torch

        WIDTHS = {torch.float32: (4, 8), torch.float64: (2, 4)}

        def launch(X):
            f64 = int(X.dtype == torch.float64)
            assert X.dtype in (torch.float32, torch.float64)
            return WIDTHS[X.dtype], f64
    """)
    builder = _ctx("grblas/containers.py", """
        import numpy as np
        import torch

        def _build_ell(self, n, w, dtype, dev):
            cols = np.empty((n, w), np.int32)
            self.ell_cols = torch.as_tensor(cols, device=dev)  # pinned
            self.ell_vals = torch.zeros((n, w), dtype=dtype, device=dev)
            self.ell_ptr = torch.as_tensor(np.arange(n).astype(np.int32))
    """)
    assert _findings("dtype-hygiene", host, reads, builder) == []


# ------------------------------------------------------------ registry-span

def test_registry_span_positive():
    backends = _ctx("grblas/backends.py", """
        @register_backend("coo", priority=20, supports=None)
        def _coo():
            pass
    """)
    solvers = _ctx("core/solvers/newton.py", """
        @register_solver("newton", p_min=1.0, p_max=2.0)
        def newton_minimize_at_p(state):
            pass
    """)
    fs = _findings("registry-span", backends, solvers)
    msgs = " ".join(f.message for f in fs)
    assert len(fs) == 2 and "'coo'" in msgs and "'newton'" in msgs


def test_registry_span_negative_dynamic_chokepoint():
    backends = _ctx("grblas/backends.py", """
        @register_backend("coo", priority=20, supports=None)
        def _coo():
            pass

        @register_backend("sellcs", priority=0, supports=None)
        def _sellcs():
            pass
    """)
    api = _ctx("grblas/api.py", """
        def mxm(A, X, be, tr):
            with tr.span("grblas.mxm", cat="grblas", backend=be.name):
                return be.execute(A, X)
    """)
    assert _findings("registry-span", backends, api) == []


def test_registry_span_guards_registry_relocation():
    # backends.py with zero register_backend calls: the rule proves
    # nothing and says so rather than passing vacuously
    moved = _ctx("grblas/backends.py", """
        def nothing_here():
            pass
    """)
    fs = _findings("registry-span", moved)
    assert len(fs) == 1 and "registry moved" in fs[0].message


# -------------------------------------------- suppressions and meta-rules

def _write_module(tmp_path, rel, source):
    f = tmp_path / "repro_torch" / rel
    f.parent.mkdir(parents=True, exist_ok=True)
    f.write_text(textwrap.dedent(source))
    return f


def test_suppression_with_reason_silences(tmp_path):
    f = _write_module(tmp_path, "multilevel/probe.py", """
        def probe(A, B):
            # pscheck: disable=dense-matmul (3x3 diagnostic block, not a coarse operator)
            return A @ B
    """)
    assert analysis.run([f], rules=["dense-matmul"]) == []


def test_suppression_same_line_form(tmp_path):
    f = _write_module(tmp_path, "multilevel/probe.py", """
        def probe(A, B):
            return A @ B  # pscheck: disable=dense-matmul (tiny diagnostic)
    """)
    assert analysis.run([f], rules=["dense-matmul"]) == []


def test_suppression_without_reason_is_flagged(tmp_path):
    f = _write_module(tmp_path, "multilevel/probe.py", """
        def probe(A, B):
            return A @ B  # pscheck: disable=dense-matmul
    """)
    rules = _rules_of(analysis.run([f], rules=["dense-matmul"]))
    assert rules == ["suppression-reason"]


def test_unused_suppression_is_flagged(tmp_path):
    f = _write_module(tmp_path, "multilevel/probe.py", """
        def probe(A, B):
            # pscheck: disable=dense-matmul (left over after the fix)
            return A + B
    """)
    fs = analysis.run([f], rules=["dense-matmul"])
    assert _rules_of(fs) == ["unused-suppression"]
    assert "delete the directive" in fs[0].message


def test_parse_error_is_a_finding(tmp_path):
    f = _write_module(tmp_path, "multilevel/broken.py", """
        def probe(A, B:
            return A
    """)
    fs = analysis.run([f])
    assert _rules_of(fs) == ["parse-error"]


# ----------------------------------------------------------------- baseline

def _mk_finding(**kw):
    base = dict(rule="dense-matmul", path="multilevel/x.py", line=3, col=4,
                message="dense '@' product", symbol="probe")
    base.update(kw)
    return analysis.Finding(**base)


def test_baseline_round_trip_and_split(tmp_path):
    bl = tmp_path / "baseline.json"
    known = _mk_finding()
    analysis.write_baseline([known], bl)
    data = json.loads(bl.read_text())
    assert data["version"] == 1 and len(data["entries"]) == 1
    # key is (rule, path, symbol, message) — line moves are invisible
    moved = _mk_finding(line=99)
    fresh = _mk_finding(path="multilevel/y.py")
    new, stale = analysis.apply_baseline([moved, fresh],
                                         analysis.load_baseline(bl))
    assert new == [fresh] and stale == []


def test_baseline_is_shrink_only(tmp_path):
    bl = tmp_path / "baseline.json"
    analysis.write_baseline([_mk_finding()], bl)
    # the violation is gone but the ledger entry remains: stale -> error
    new, stale = analysis.apply_baseline([], analysis.load_baseline(bl))
    assert new == [] and len(stale) == 1
    with pytest.raises(AssertionError, match="shrink the ledger"):
        analysis.assert_clean([], baseline=bl)


def test_assert_clean_reports_findings(tmp_path):
    f = _write_module(tmp_path, "multilevel/probe.py", """
        def probe(A, B):
            return A @ B
    """)
    with pytest.raises(AssertionError, match="dense-matmul"):
        analysis.assert_clean([f], rules=["dense-matmul"])


# ---------------------------------------------------------------------- CLI

def _cli(*args, cwd=None):
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO / "src")
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis", *args],
        capture_output=True, text=True, env=env, cwd=cwd or REPO,
        timeout=120)


def test_cli_list_rules():
    res = _cli("--list-rules")
    assert res.returncode == 0
    for rid in ("hot-purity", "host-sync", "retrace-loop-jit",
                "retrace-mutable-default", "api-boundary", "pad-fold",
                "dtype-hygiene", "registry-span", "dense-matmul"):
        assert rid in res.stdout
    assert "[has fixer]" in res.stdout


def test_cli_exit_codes_and_json(tmp_path):
    bad = _write_module(tmp_path, "multilevel/probe.py", """
        def probe(A, B):
            return A @ B
    """)
    res = _cli(str(bad), "--rules", "dense-matmul", "--json")
    assert res.returncode == 1
    payload = json.loads(res.stdout)
    assert payload["findings"][0]["rule"] == "dense-matmul"
    assert payload["stale_baseline"] == []
    good = _write_module(tmp_path, "multilevel/ok.py", """
        def probe(A, B):
            return A
    """)
    assert _cli(str(good)).returncode == 0
    assert _cli(str(good), "--update-baseline").returncode == 2


def test_cli_fails_on_a_stray_sync_in_the_newton_loop(tmp_path):
    """A copy of the port, clean modulo the committed baseline; then a
    stray .item() in a loop of core/solvers/newton.py makes the CLI
    exit non-zero, naming it."""
    tree = tmp_path / "repro_torch"
    shutil.copytree(PORT, tree, ignore=shutil.ignore_patterns(
        "__pycache__", "csrc"))
    findings, stale = analysis.apply_baseline(
        analysis.run([tree]), analysis.load_baseline(BASELINE))
    assert findings == [] and stale == []
    newton = tree / "core" / "solvers" / "newton.py"
    src = newton.read_text()
    anchor = "    return SolverReport("
    assert src.count(anchor) == 1
    newton.write_text(src.replace(
        anchor, "    for _ in range(2):\n        res.fval.item()\n" + anchor))
    res = _cli(str(tree), "--baseline", str(BASELINE), "--json")
    assert res.returncode == 1
    payload = json.loads(res.stdout)
    assert [(f["rule"], f["path"], f["symbol"])
            for f in payload["findings"]] == [
        ("host-sync", "core/solvers/newton.py", "newton_minimize_at_p")]


# --------------------------------------------- parity with the reference

@pytest.mark.parametrize("line,expected", [
    ("x = 1  # pscheck: disable=host-sync (read once after the loop)",
     (("host-sync",), "read once after the loop")),
    ("# pscheck: disable=pad-fold, dtype-hygiene (gated by _dist_supports)",
     (("pad-fold", "dtype-hygiene"), "gated by _dist_supports")),
    ("#pscheck:disable=dense-matmul", (("dense-matmul",), "")),
    ("x = 1  # pscheck: enable=host-sync (no such verb)", None),
    ("x = 1  # pscheck disable=host-sync (missing colon)", None),
    ("# pscheck: disable=host-sync (reason) trailing words", None),
])
def test_directive_parser_matches_reference(line, expected):
    port = [(s.line, s.rules, s.reason) for s in parse_suppressions(line)]
    ref = [(s.line, s.rules, s.reason)
           for s in ref_parse_suppressions(line)]
    assert port == ref
    assert port == ([] if expected is None else [(1,) + expected])


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_baseline_loads_in_the_other_package(tmp_path, writer):
    findings = [_mk_finding(), _mk_finding(line=7),
                _mk_finding(rule="host-sync", path="core/lobpcg.py",
                            symbol="lobpcg", message="float() of ...")]
    bl = tmp_path / "baseline.json"
    if writer == "port":
        analysis.write_baseline(findings, bl)
        other = ref_analysis.load_baseline(bl)
    else:
        ref_analysis.write_baseline(
            [ref_analysis.Finding(**vars(f)) for f in findings], bl)
        other = analysis.load_baseline(bl)
    mine = (analysis.load_baseline(bl) if writer == "port"
            else ref_analysis.load_baseline(bl))
    assert other == mine
    assert other[("dense-matmul", "multilevel/x.py", "probe",
                  "dense '@' product")] == 2


_PARITY_FIXTURES = {
    "hot-purity": ("core/solvers/driver.py", """
        import scipy.sparse.linalg as spla
        from scipy.linalg import eigh

        def solve(A, k):
            vals, vecs = scipy.linalg.eigh(A)
            return spla.eigsh(A, k), vals
    """),
    "retrace-mutable-default": ("core/plap.py", """
        import jax
        import torch

        @jax.jit
        def step(x, opts={}, *, seen=[]):
            return x

        @torch.compile
        def other(x, ok=None):
            return x
    """),
}


@pytest.mark.parametrize("rule_id", sorted(_PARITY_FIXTURES))
def test_rule_reports_what_the_reference_reports(rule_id):
    """On one fixture both packages flag the same (rule, line) — the
    reference's side runs as tests/test_analysis.py runs it (pure AST,
    on the CPU)."""
    rel, src = _PARITY_FIXTURES[rule_id]
    src = textwrap.dedent(src)
    port = _findings(rule_id, ModuleContext(Path("/fx/repro_torch") / rel,
                                            source=src))
    rule = ref_analysis.registered_rules()[rule_id]
    ref = list(rule.check(RefModuleContext(Path("/fx/repro") / rel,
                                           source=src)))
    assert port, "the fixture must be flagged"
    assert (sorted((f.rule, f.line) for f in port)
            == sorted((f.rule, f.line) for f in ref))


def test_module_rel_resolves_under_repro_torch():
    """The defect that blinds the reference's copy on the port: its
    module_rel keys on a ``repro`` directory and returns a bare file
    name for ``repro_torch`` paths, so no scope matches."""
    p = Path("/x/src/repro_torch/core/solvers/newton.py")
    assert analysis.module_rel(p) == "core/solvers/newton.py"
    assert ref_analysis.module_rel(p) == "newton.py"
    assert analysis.module_rel(Path("/x/tests/fixture.py")) == "fixture.py"


# -------------------------------------------------------------- repo gate

def test_every_rule_has_invariant_and_fixture_coverage():
    """Structural pin: each registered rule documents its invariant, and
    this module carries a positive + negative fixture for it (grep our
    own test names — adding a rule without fixtures fails here)."""
    here = Path(__file__).read_text()
    for rid, rule in analysis.registered_rules().items():
        assert rule.invariant and rule.summary, rid
        slug = rid.replace("-", "_")
        assert f"test_{slug}_positive" in here, rid
        assert f"test_{slug}_negative" in here, rid


def test_every_reference_rule_is_decided_in_the_docstring():
    """All 11 reference rules appear in the package docstring, each
    kept, changed, folded or dropped; the dropped and folded ones are
    not registered."""
    doc = analysis.__doc__
    ref_ids = sorted(ref_analysis.registered_rules())
    assert len(ref_ids) == 11
    verdicts = ("**kept", "**changed", "**folded", "**dropped")
    for rid in ref_ids:
        entry = doc.split(f"* ``{rid}`` — ", 1)
        assert len(entry) == 2, rid
        assert entry[1].lstrip().startswith(verdicts), rid
    port_ids = set(analysis.registered_rules())
    assert port_ids == set(ref_ids) - {"retrace-static", "traced-branch"}


def test_baseline_holds_the_solver_loop_host_syncs():
    """The two loop-step syncs a later optimisation of the solver loops
    removes: LOBPCG's convergence read and the RTR loop's gradnorm."""
    keys = {(rule, path, symbol)
            for rule, path, symbol, _ in analysis.load_baseline(BASELINE)}
    assert ("host-sync", "core/lobpcg.py", "lobpcg") in keys
    assert ("host-sync", "core/grassmann.py", "rtr_minimize") in keys


def test_src_repro_torch_is_clean_modulo_baseline():
    """The port's lint gate, as a tier-1 test: zero unbaselined pscheck
    findings in src/repro_torch and zero stale ledger entries."""
    analysis.assert_clean([PORT], baseline=BASELINE)
