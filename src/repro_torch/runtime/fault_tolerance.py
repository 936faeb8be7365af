"""Fault-tolerance runtime: checkpoint manager and supervised step loop,
as the JAX package's ``runtime/fault_tolerance.py``.

* ``CheckpointManager``: periodic saves written by a background thread,
  so the step loop never waits on the disk; a retention window;
  restore-or-init. The port's train step updates its state in place, so a
  save first copies the state to host memory (synchronously) and the
  thread writes that copy; the JAX package's immutable arrays need no copy.
* ``run_with_recovery``: on a step failure it restores the newest
  checkpoint and replays from its step; with the deterministic data
  pipeline that is an exact resume. Before the first checkpoint it
  rebuilds the initial state from its seed (``reinit``), since the steps
  have updated the state it was given in place.

* straggler mitigation: ``core.perfmodel.StragglerTracker``, re-exported
  here for runtime users, as in the JAX package.
"""
from __future__ import annotations

import os
import shutil
import threading
from dataclasses import dataclass, field
from typing import Any, Callable, Optional

from ..ckpt.checkpoint import (
    available_steps,
    host_snapshot,
    latest_step,
    restore_checkpoint,
    save_checkpoint,
)
from ..core.perfmodel import StragglerTracker  # re-export for runtime users

__all__ = ["CheckpointManager", "run_with_recovery", "StragglerTracker"]


@dataclass
class CheckpointManager:
    directory: str
    save_every: int = 100
    keep: int = 3
    async_save: bool = True
    _thread: Optional[threading.Thread] = field(default=None, repr=False)
    _error: Optional[BaseException] = field(default=None, repr=False)

    def maybe_save(self, step: int, state: Any, force: bool = False) -> bool:
        if not force and (self.save_every <= 0 or step % self.save_every != 0):
            return False
        self.wait()  # one in-flight save at a time
        snapshot = host_snapshot(state)  # the next step updates ``state`` in place

        def work():
            try:
                save_checkpoint(self.directory, step, snapshot)
                self._gc()
            except BaseException as e:  # surfaced on the next wait()
                self._error = e

        if self.async_save:
            self._thread = threading.Thread(target=work, daemon=True)
            self._thread.start()
        else:
            work()
            self._raise_if_failed()
        return True

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        self._raise_if_failed()

    def _raise_if_failed(self):
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _gc(self):
        steps = available_steps(self.directory)
        for s in steps[: -self.keep] if self.keep > 0 else []:
            shutil.rmtree(os.path.join(self.directory, f"step_{s}"), ignore_errors=True)

    def restore_latest(self, template: Any):
        """Returns (template filled in place, step), or (None, None) when no
        checkpoint exists."""
        self.wait()
        s = latest_step(self.directory)
        if s is None:
            return None, None
        return restore_checkpoint(self.directory, s, template), s


def run_with_recovery(
    step_fn: Callable[[Any, int], Any],
    init_state: Any,
    n_steps: int,
    manager: CheckpointManager,
    *,
    start_step: int = 0,
    max_restarts: int = 3,
    on_restore: Optional[Callable[[int], None]] = None,
    reinit: Optional[Callable[[], Any]] = None,
):
    """Supervised loop: state = step_fn(state, step). On an exception the
    newest checkpoint is restored into the state and the loop replays from
    its step. Where there is no checkpoint to return to, ``reinit()``
    rebuilds ``init_state`` (the steps have updated it in place) and the
    loop replays from ``start_step``; without ``reinit`` the exception
    propagates."""
    state = init_state
    step = start_step
    restarts = 0
    while step < n_steps:
        try:
            state = step_fn(state, step)
            step += 1
            manager.maybe_save(step, state)
        except KeyboardInterrupt:
            raise
        except Exception:
            restarts += 1
            if restarts > max_restarts:
                raise
            restored, s = manager.restore_latest(state)
            if restored is None:
                if reinit is None:
                    raise
                state, step = reinit(), start_step
            else:
                state, step = restored, s
            if on_restore is not None:
                on_restore(step)
    manager.maybe_save(step, state, force=True)
    manager.wait()
    return state, step
