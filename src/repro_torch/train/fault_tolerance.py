"""Fault tolerance for long runs.  Port of the reference's
``repro.train.fault_tolerance`` (pure Python, copied, not imported).

1. Preemption handling: SIGTERM / SIGINT set a flag; the host loop
   checkpoints at the next step boundary and exits cleanly.
2. Crash-restart: ``run_with_restarts`` wraps the step loop; on an
   exception it restores the latest checkpoint and continues, with
   exponential backoff and a retry budget.  With atomic checkpoints this
   loses at most one step of work.
3. Straggler detection: ``StepWatchdog`` records each step's wall time
   and flags steps slower than ``factor`` x the trailing median.
4. Resume: the data pipeline is stateless by step
   (``data.SyntheticTokens.batch_at``), so a resume at step k replays no
   data and skips none.
"""
from __future__ import annotations

import signal
import statistics
import time
from typing import Callable, Optional

from repro_torch.train.checkpoint import CheckpointManager


class PreemptionGuard:
    """Installs signal handlers; ``should_stop`` is polled by the loop."""

    def __init__(self, signals=(signal.SIGTERM, signal.SIGINT)):
        self._stop = False
        self._prev = {}
        for s in signals:
            try:
                self._prev[s] = signal.signal(s, self._handler)
            except (ValueError, OSError):   # non-main thread etc.
                pass

    def _handler(self, signum, frame):
        self._stop = True

    @property
    def should_stop(self) -> bool:
        return self._stop

    def restore(self):
        for s, h in self._prev.items():
            signal.signal(s, h)


class StepWatchdog:
    def __init__(self, factor: float = 3.0, window: int = 32):
        self.factor = factor
        self.window = window
        self.times = []
        self.straggler_steps = []

    def record(self, step: int, seconds: float) -> bool:
        """Returns True if this step is a straggler."""
        slow = False
        if len(self.times) >= 8:
            med = statistics.median(self.times[-self.window:])
            slow = seconds > self.factor * med
            if slow:
                self.straggler_steps.append((step, seconds, med))
        self.times.append(seconds)
        return slow


def run_with_restarts(loop_body: Callable[[int, object], object],
                      state, manager: CheckpointManager,
                      start_step: int, end_step: int,
                      save_every: int = 100,
                      max_restarts: int = 5,
                      guard: Optional[PreemptionGuard] = None,
                      on_restore: Optional[Callable] = None,
                      backoff_base: float = 0.01,
                      backoff_cap: float = 2.0,
                      sleep_fn: Callable[[float], None] = time.sleep):
    """Run ``state = loop_body(step, state)`` with checkpoint/restart.

    loop_body must keep all its state in ``state``.  Returns
    (final_step, state, report); the report records every restart's
    exception (``errors`` / ``last_error``) and what each retry restored
    from (``restored_from``: a checkpoint step, or "initial" for the
    explicit no-checkpoint reset: before the first save a crash rewinds
    to the caller's (start_step, state), not to whatever half-advanced
    state the failed iteration left behind).  The reset hands back the
    caller's state object itself, so a body that updates its state in
    place (the port's train step does) must take a copy first.  Backoff
    is ``min(backoff_base * 2^restarts, backoff_cap)`` seconds through
    ``sleep_fn`` (injectable, so tests run deterministic and
    sleep-free)."""
    report = {"restarts": 0, "preempted": False, "saved_at": [],
              "errors": [], "last_error": None, "restored_from": []}
    state0 = state
    step = start_step
    restarts = 0
    while step < end_step:
        try:
            state = loop_body(step, state)
            step += 1
            if step % save_every == 0 or step == end_step:
                manager.save(step, state)
                report["saved_at"].append(step)
            if guard is not None and guard.should_stop:
                manager.save(step, state)
                report["saved_at"].append(step)
                report["preempted"] = True
                break
        except KeyboardInterrupt:
            raise
        except Exception as exc:
            restarts += 1
            report["restarts"] = restarts
            report["errors"].append(f"step {step}: "
                                    f"{type(exc).__name__}: {exc}")
            report["last_error"] = exc
            if restarts > max_restarts:
                raise
            sleep_fn(min(backoff_base * 2.0 ** restarts, backoff_cap))
            latest = manager.latest()
            if latest is not None:
                state, _ = manager.restore(latest, state)
                step = latest
                report["restored_from"].append(latest)
            else:
                # no checkpoint exists yet: the retry must not continue
                # from the possibly-corrupt mid-crash state; reset
                # explicitly to the caller's initial (step, state)
                state = state0
                step = start_step
                report["restored_from"].append("initial")
            if on_restore is not None:
                state = on_restore(state)
    return step, state, report
