"""Fault tolerance: supervised training, straggler watch, failure
injection -- the port of ``repro/runtime/fault_tolerance.py``.

* ``Supervisor`` wraps the step loop: on any step exception it restores
  the newest complete checkpoint and replays (the data pipeline is
  deterministic in the step, so replay is exact), up to ``max_restarts``.
* ``StragglerWatch`` flags steps beyond ``k`` MADs of the trailing window.
* ``FailureInjector`` fails chosen steps once each, to prove the restore
  path end to end.
"""
from __future__ import annotations

import dataclasses
import logging
import time
from collections import deque
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

from ..checkpoint.checkpoint import CheckpointManager

log = logging.getLogger("repro_torch.ft")


class InjectedFailure(RuntimeError):
    pass


@dataclasses.dataclass
class FailureInjector:
    fail_steps: Sequence[int] = ()
    _fired: set = dataclasses.field(default_factory=set)

    def maybe_fail(self, step: int):
        if step in self.fail_steps and step not in self._fired:
            self._fired.add(step)
            raise InjectedFailure(f"injected failure at step {step}")


class StragglerWatch:
    def __init__(self, window: int = 32, k: float = 4.0):
        self.window = deque(maxlen=window)
        self.k = k
        self.flags: list = []

    def observe(self, step: int, seconds: float) -> bool:
        """Returns True if this step is a straggler."""
        if len(self.window) >= 8:
            med = sorted(self.window)[len(self.window) // 2]
            mad = sorted(abs(t - med) for t in self.window)[
                len(self.window) // 2]
            if seconds > med + self.k * max(mad, 0.05 * med, 1e-6):
                self.flags.append((step, seconds, med))
                self.window.append(seconds)
                return True
        self.window.append(seconds)
        return False


class Supervisor:
    """Restart-on-failure wrapper around a step function."""

    def __init__(self, ckpt: CheckpointManager, *, save_every: int = 50,
                 max_restarts: int = 5,
                 injector: Optional[FailureInjector] = None):
        self.ckpt = ckpt
        self.save_every = save_every
        self.max_restarts = max_restarts
        self.injector = injector
        self.restarts = 0
        self.stragglers = StragglerWatch()

    def run(self, state: Any, step_fn: Callable[[Any, int], Any],
            n_steps: int, *, start_step: int = 0,
            on_metrics: Optional[Callable[[int, Dict], None]] = None
            ) -> Tuple[Any, int]:
        """state -> final state.  ``step_fn(state, step) -> (state,
        metrics)``; the batch is derived from ``step`` inside step_fn,
        which is what makes replay after a restore exact."""
        step = start_step
        while step < n_steps:
            try:
                t0 = time.time()
                if self.injector is not None:
                    self.injector.maybe_fail(step)
                state, metrics = step_fn(state, step)
                dt = time.time() - t0
                if self.stragglers.observe(step, dt):
                    log.warning("straggler step %d: %.3fs", step, dt)
                if on_metrics is not None:
                    on_metrics(step, metrics)
                step += 1
                if step % self.save_every == 0:
                    self.ckpt.save(step, state, extra={"step": step})
            except Exception as e:  # noqa: BLE001 -- the whole point
                self.restarts += 1
                if self.restarts > self.max_restarts:
                    raise
                log.warning("step %d failed (%r); restoring", step, e)
                latest = self.ckpt.latest_step()
                if latest is None:
                    # nothing saved yet: restart from the initial step
                    step = start_step
                    continue
                state, step, _ = self.ckpt.restore(state)
        self.ckpt.save(n_steps, state, extra={"step": n_steps})
        return state, step
