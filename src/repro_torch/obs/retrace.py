"""Rebuild detection over the solver registry's build memo (port of
``repro.obs.retrace``).

The port runs eagerly and compiles nothing, so its unit is the *build*:
``registry.mark_trace(key)`` records one each time a memoized callable
is made.  The serve engine's per-bucket batched solve is the port's one
memoized build (keys ``("serve", mode, n, nnz, k) + solver signature``),
made once per (bucket key, solver signature).  This module reads that
log:

  * :class:`RetraceDetector` — a bookmark into ``SOLVER_TRACES`` with
    per-key build counts and per-site groupings,
  * :func:`assert_no_retrace` — a context manager for steady-state
    regions: any new build inside the block raises :class:`RetraceError`
    naming the keys,
  * the ``compiles_total{site=...}`` counter on the DEFAULT metrics
    registry and the ``compile`` instant on the active tracer, both
    emitted by ``registry.mark_trace`` itself.

The registry is imported at call time: ``obs.trace`` and ``obs.metrics``
sit below the solver stack, this module above it.
"""
from __future__ import annotations

import contextlib
from typing import Dict, List, Tuple


def _registry():
    from repro_torch.core.solvers import registry
    return registry


class RetraceError(AssertionError):
    """A memoized region was built again (or more often than allowed)."""


def _sitename(key) -> str:
    return str(key[0]) if isinstance(key, tuple) and key else str(key)


class RetraceDetector:
    """Bookmark ``SOLVER_TRACES`` at construction; every build recorded
    after it is this detector's."""

    def __init__(self):
        self._base = len(_registry().SOLVER_TRACES)

    def traces(self) -> List[tuple]:
        """Keys built since construction, in order."""
        return list(_registry().SOLVER_TRACES[self._base:])

    def compiles(self) -> Dict[tuple, int]:
        """Build count per full memo key."""
        out: Dict[tuple, int] = {}
        for k in self.traces():
            out[k] = out.get(k, 0) + 1
        return out

    def by_site(self) -> Dict[str, int]:
        """Build count per site (the key's head: "serve", ...)."""
        out: Dict[str, int] = {}
        for k in self.traces():
            s = _sitename(k)
            out[s] = out.get(s, 0) + 1
        return out

    def serve_buckets(self) -> Dict[Tuple, int]:
        """Build count per serve (bucket, solver) key: one each is the
        engine's contract."""
        return {k: v for k, v in self.compiles().items()
                if _sitename(k) == "serve"}

    def assert_at_most(self, max_per_key: int = 1) -> None:
        bad = {k: v for k, v in self.compiles().items() if v > max_per_key}
        if bad:
            lines = "\n".join(f"  {v}x {k}" for k, v in bad.items())
            raise RetraceError(
                f"retrace detected: {len(bad)} key(s) built more than "
                f"{max_per_key}x since detector start:\n{lines}")

    def assert_no_retrace(self) -> None:
        """No key built since construction."""
        fresh = self.compiles()
        if fresh:
            lines = "\n".join(f"  {v}x {k}" for k, v in fresh.items())
            raise RetraceError(
                f"retrace detected: {sum(fresh.values())} unexpected "
                f"build(s):\n{lines}")


@contextlib.contextmanager
def assert_no_retrace():
    """Steady-state guard: the block must make no new build.

    >>> eng.submit(...); eng.poll()        # build every bucket first
    >>> with assert_no_retrace():
    ...     eng.submit(...); eng.poll()    # reuse only, or RetraceError
    """
    det = RetraceDetector()
    yield det
    det.assert_no_retrace()
