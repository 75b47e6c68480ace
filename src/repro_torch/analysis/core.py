"""pscheck core: findings, suppression directives, rule registry, runner
(the port's copy of ``repro.analysis.core``; it imports nothing of the
reference, and nothing of the code it checks).

The analyzer is a library first (``repro_torch.analysis.run(paths, rules) ->
list[Finding]``), a CLI second (``python -m repro_torch.analysis``), and a
pytest assertion third (``assert_clean``).  Every invariant is a
registered ``Rule``: one id, one docstring stating the invariant, one AST
check, and (where a rewrite is mechanical) one fixer.

Three enforcement channels, strictest first:

* a violation with no escape hatch is an **error** — the gate fails
  (``tests/test_torch_analysis.py``);
* an *intentional* violation carries an inline directive on its line
  (or the line above)::

      # pscheck: disable=rule-id (reason the invariant does not apply)

  the reason string is mandatory (``suppression-reason``) and a
  directive that stops matching anything is itself an error
  (``unused-suppression``) — suppressions cannot rot;
* a *known* violation that predates the analyzer lives in the committed
  baseline file (``pscheck_torch_baseline.json``).  The baseline is
  shrink-only: a baselined finding that disappears while its entry
  remains fails the run, so the debt ledger can only go down.

Baseline entries are keyed on (rule, module path, enclosing symbol,
message) — never on line numbers — so unrelated edits don't churn the
ledger.
"""
from __future__ import annotations

import ast
import dataclasses
import json
import re
from pathlib import Path
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple


# ---------------------------------------------------------------- findings

@dataclasses.dataclass(frozen=True)
class Finding:
    """One rule violation at one source location."""

    rule: str
    path: str                   # module-relative path ("core/plap.py")
    line: int
    col: int
    message: str
    severity: str = "error"     # "error" | "warning"
    symbol: str = "<module>"    # enclosing def qualname

    def baseline_key(self) -> Tuple[str, str, str, str]:
        return (self.rule, self.path, self.symbol, self.message)

    def format(self) -> str:
        return (f"{self.path}:{self.line}:{self.col}: {self.severity}: "
                f"[{self.rule}] {self.message} (in {self.symbol})")


# ------------------------------------------------------------- suppressions

_DIRECTIVE = re.compile(
    r"#\s*pscheck:\s*disable=(?P<rules>[A-Za-z0-9_,\- ]+?)"
    r"(?:\s*\((?P<reason>[^)]*)\))?\s*$")


@dataclasses.dataclass
class Suppression:
    line: int                   # 1-based line the directive sits on
    rules: Tuple[str, ...]
    reason: str
    used_by: set = dataclasses.field(default_factory=set)

    def covers(self, rule: str, line: int) -> bool:
        """A directive covers its own line and the line directly below
        (standalone-comment form)."""
        return rule in self.rules and line in (self.line, self.line + 1)


def parse_suppressions(source: str) -> List[Suppression]:
    out = []
    for i, text in enumerate(source.splitlines(), start=1):
        m = _DIRECTIVE.search(text)
        if m:
            rules = tuple(r.strip() for r in m.group("rules").split(",")
                          if r.strip())
            out.append(Suppression(line=i, rules=rules,
                                   reason=(m.group("reason") or "").strip()))
    return out


# ---------------------------------------------------------------- contexts

PACKAGE = "repro_torch"     # the directory module paths are relative to

def module_rel(path: Path) -> str:
    """Stable display/baseline path: the part under the ``repro_torch``
    package when there is one (checkout-root independent), else the
    file name.  Every scope table in ``profile.py`` is keyed on this
    path, so a file outside a ``repro_torch`` directory is in no
    scope."""
    parts = Path(path).parts
    for i in range(len(parts) - 1, -1, -1):
        if parts[i] == PACKAGE:
            return "/".join(parts[i + 1:])
    return Path(path).name


class ModuleContext:
    """One parsed module: source, AST with parent links, suppressions,
    and the lazily-built hot-scope map rules share."""

    def __init__(self, path: Path, source: Optional[str] = None):
        self.path = Path(path)
        self.rel = module_rel(self.path)
        self.source = self.path.read_text() if source is None else source
        self.lines = self.source.splitlines()
        self.tree = ast.parse(self.source, filename=str(self.path))
        self.suppressions = parse_suppressions(self.source)
        self._parents: Dict[int, ast.AST] = {}
        for parent in ast.walk(self.tree):
            for child in ast.iter_child_nodes(parent):
                self._parents[id(child)] = parent
        self._scopes = None

    # -- structure -------------------------------------------------------
    def parent(self, node: ast.AST) -> Optional[ast.AST]:
        return self._parents.get(id(node))

    def ancestors(self, node: ast.AST):
        cur = self.parent(node)
        while cur is not None:
            yield cur
            cur = self.parent(cur)

    def enclosing_def(self, node: ast.AST):
        for anc in self.ancestors(node):
            if isinstance(anc, (ast.FunctionDef, ast.AsyncFunctionDef,
                                ast.Lambda)):
                return anc
        return None

    def qualname(self, node: ast.AST) -> str:
        names = []
        cur = node
        while cur is not None:
            if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef)):
                names.append(cur.name)
            elif isinstance(cur, ast.Lambda):
                names.append("<lambda>")
            elif isinstance(cur, ast.ClassDef):
                names.append(cur.name)
            cur = self.parent(cur)
        return ".".join(reversed(names)) or "<module>"

    @property
    def scopes(self):
        if self._scopes is None:
            from repro_torch.analysis.scopes import ScopeInfo
            self._scopes = ScopeInfo(self)
        return self._scopes

    # -- findings --------------------------------------------------------
    def finding(self, rule: str, node: ast.AST, message: str,
                severity: str = "error") -> Finding:
        return Finding(rule=rule, path=self.rel,
                       line=getattr(node, "lineno", 1),
                       col=getattr(node, "col_offset", 0),
                       message=message, severity=severity,
                       symbol=self.qualname(node))


class ProjectContext:
    """The whole scanned file set — what cross-file rules see."""

    def __init__(self, modules: Sequence[ModuleContext]):
        self.modules = list(modules)
        self._by_rel = {m.rel: m for m in self.modules}

    def get(self, rel: str) -> Optional[ModuleContext]:
        return self._by_rel.get(rel)


# ------------------------------------------------------------ rule registry

@dataclasses.dataclass(frozen=True)
class Rule:
    """One machine-checked invariant.

    ``check`` runs per module; ``project_check`` runs once over the
    whole file set (cross-registry rules).  ``fix`` — present only
    where the rewrite is mechanical and safe — takes (ctx, findings)
    and returns the repaired source, or None to decline.
    """

    id: str
    summary: str                # one line, for --list-rules
    invariant: str              # the invariant this encodes
    check: Optional[Callable[[ModuleContext], Iterable[Finding]]] = None
    project_check: Optional[
        Callable[[ProjectContext], Iterable[Finding]]] = None
    fix: Optional[Callable[[ModuleContext, List[Finding]],
                           Optional[str]]] = None


_RULES: Dict[str, Rule] = {}

# meta-rules: emitted by the runner itself, always on, never selectable off
META_RULES = ("unused-suppression", "suppression-reason", "parse-error")


def register_rule(rule: Rule) -> Rule:
    if rule.id in _RULES:
        raise ValueError(f"duplicate rule id {rule.id!r}")
    _RULES[rule.id] = rule
    return rule


def registered_rules() -> Dict[str, Rule]:
    _load_rules()
    return dict(_RULES)


def resolve_rules(rules=None) -> List[Rule]:
    table = registered_rules()
    if rules is None:
        return list(table.values())
    out = []
    for r in rules:
        if isinstance(r, Rule):
            out.append(r)
            continue
        if r not in table:
            raise ValueError(
                f"unknown rule {r!r}; registered: {sorted(table)}")
        out.append(table[r])
    return out


_LOADED = False


def _load_rules():
    global _LOADED
    if not _LOADED:
        _LOADED = True
        import repro_torch.analysis.rules  # noqa: F401  (registers on import)


# ----------------------------------------------------------------- running

def collect_files(paths) -> List[Path]:
    files: List[Path] = []
    for p in paths:
        p = Path(p)
        if p.is_dir():
            files.extend(sorted(
                f for f in p.rglob("*.py")
                if "__pycache__" not in f.parts and "_vendor" not in f.parts))
        else:
            files.append(p)
    seen, uniq = set(), []
    for f in files:
        if f not in seen:
            seen.add(f)
            uniq.append(f)
    return uniq


def _parse_modules(files) -> Tuple[List[ModuleContext], List[Finding]]:
    mods, findings = [], []
    for f in files:
        try:
            mods.append(ModuleContext(f))
        except SyntaxError as e:
            findings.append(Finding(
                rule="parse-error", path=module_rel(f),
                line=e.lineno or 1, col=e.offset or 0,
                message=f"syntax error: {e.msg}"))
    return mods, findings


def run(paths, rules=None, *, meta: bool = True) -> List[Finding]:
    """Analyze ``paths`` (files or directories) under ``rules`` (default:
    every registered rule).  Returns unsuppressed findings; inline
    ``# pscheck: disable=`` directives filter matching findings and are
    themselves checked (mandatory reason, no dead directives) when
    ``meta`` is on."""
    selected = resolve_rules(rules)
    mods, findings = _parse_modules(collect_files(paths))
    project = ProjectContext(mods)

    raw: List[Finding] = []
    for rule in selected:
        if rule.check is not None:
            for m in mods:
                raw.extend(rule.check(m))
        if rule.project_check is not None:
            raw.extend(rule.project_check(project))

    selected_ids = {r.id for r in selected}
    by_rel = {m.rel: m for m in mods}
    for f in raw:
        m = by_rel.get(f.path)
        sup = _matching_suppression(m, f) if m is not None else None
        if sup is not None:
            sup.used_by.add(f.rule)
        else:
            findings.append(f)

    if meta:
        for m in mods:
            for sup in m.suppressions:
                if not sup.reason:
                    findings.append(Finding(
                        rule="suppression-reason", path=m.rel,
                        line=sup.line, col=0,
                        message="disable directive needs a reason: "
                                "# pscheck: disable=<rule> (why)"))
                dead = [r for r in sup.rules
                        if r in selected_ids and r not in sup.used_by]
                if dead and not sup.used_by:
                    findings.append(Finding(
                        rule="unused-suppression", path=m.rel,
                        line=sup.line, col=0,
                        message=f"directive disables {', '.join(dead)} but "
                                f"suppresses nothing — fix is done, delete "
                                f"the directive"))
    return sorted(findings, key=lambda f: (f.path, f.line, f.col, f.rule))


def _matching_suppression(m: ModuleContext, f: Finding):
    for sup in m.suppressions:
        if sup.covers(f.rule, f.line):
            return sup
    return None


# ---------------------------------------------------------------- baseline

def load_baseline(path) -> Dict[Tuple[str, str, str, str], int]:
    """Baseline as {finding key: allowed count}."""
    data = json.loads(Path(path).read_text())
    out: Dict[Tuple[str, str, str, str], int] = {}
    for e in data.get("entries", []):
        key = (e["rule"], e["path"], e.get("symbol", "<module>"),
               e["message"])
        out[key] = out.get(key, 0) + int(e.get("count", 1))
    return out


def write_baseline(findings: Sequence[Finding], path) -> None:
    counts: Dict[Tuple[str, str, str, str], int] = {}
    for f in findings:
        counts[f.baseline_key()] = counts.get(f.baseline_key(), 0) + 1
    entries = [
        {"rule": k[0], "path": k[1], "symbol": k[2], "message": k[3],
         "count": n}
        for k, n in sorted(counts.items())]
    Path(path).write_text(json.dumps(
        {"version": 1,
         "comment": "pscheck debt ledger — shrink-only; regenerate with "
                    "python -m repro_torch.analysis --update-baseline",
         "entries": entries}, indent=2) + "\n")


def apply_baseline(findings: Sequence[Finding], baseline
                   ) -> Tuple[List[Finding], List[Tuple]]:
    """Split ``findings`` against a baseline mapping.  Returns
    (unbaselined findings, stale baseline keys) — stale = an entry whose
    violation no longer exists, which must be removed from the ledger
    (shrink-only enforcement)."""
    budget = dict(baseline)
    new: List[Finding] = []
    for f in findings:
        k = f.baseline_key()
        if budget.get(k, 0) > 0:
            budget[k] -= 1
        else:
            new.append(f)
    stale = [k for k, n in budget.items() if n > 0]
    return new, stale


# ------------------------------------------------------------------- fixes

def apply_fixes(paths, rules=None, *, write: bool = True
                ) -> Dict[Path, str]:
    """Run every selected rule that ships a fixer and apply the repairs.
    Returns {path: new source} for each changed file (written in place
    unless ``write=False``)."""
    selected = [r for r in resolve_rules(rules) if r.fix is not None]
    changed: Dict[Path, str] = {}
    for f in collect_files(paths):
        try:
            ctx = ModuleContext(f)
        except SyntaxError:
            continue
        src = ctx.source
        for rule in selected:
            if rule.check is None:
                continue
            findings = [x for x in rule.check(ctx)
                        if _matching_suppression(ctx, x) is None]
            if not findings:
                continue
            fixed = rule.fix(ctx, findings)
            if fixed is not None and fixed != ctx.source:
                ctx = ModuleContext(f, source=fixed)
        if ctx.source != src:
            changed[f] = ctx.source
            if write:
                f.write_text(ctx.source)
    return changed


# ------------------------------------------------------------ pytest facing

def assert_clean(paths, rules=None, *, baseline=None) -> None:
    """One-line invariant assertion for tests: raise AssertionError with
    the formatted findings unless ``paths`` is clean under ``rules``
    (modulo the baseline file, when given — stale baseline entries fail
    too)."""
    findings = run(paths, rules)
    stale: List[Tuple] = []
    if baseline is not None:
        findings, stale = apply_baseline(findings, load_baseline(baseline))
    msgs = [f.format() for f in findings]
    msgs += [f"stale baseline entry (violation fixed — shrink the ledger): "
             f"{k[0]} {k[1]} {k[3]}" for k in stale]
    assert not msgs, "pscheck violations:\n  " + "\n  ".join(msgs)
