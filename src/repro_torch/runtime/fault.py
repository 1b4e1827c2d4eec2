"""Fault-tolerant training supervisor (port of `repro.runtime.fault`).

The supervisor owns the restart loop:

  - every step may run under a watchdog deadline; a straggling step
    raises StragglerTimeout (the step is re-executed, the local meaning
    of re-dispatching it to a spare);
  - on failure the loop restores the latest checkpoint and replays from
    the restored step: the deterministic pipeline (data.pipeline) and a
    deterministic train step make the replay exact, bit for bit;
  - failure injection (`inject_failure_at`) exists so the recovery path
    is tested, not aspirational.

Failures are `StragglerTimeout` and `RuntimeError`, which torch's CUDA
errors and `torch.cuda.OutOfMemoryError` subclass.  The train step
updates the state in place, so a step that fails part way leaves a
state the next restore replaces; with no checkpoint yet the loop starts
over from step 0 on the state it holds, as the reference's does.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable, Optional

import torch

from repro_torch.core.tree import leaves

from . import checkpoint as ckpt


class StragglerTimeout(RuntimeError):
    pass


@dataclasses.dataclass
class SupervisorConfig:
    ckpt_dir: str
    ckpt_every: int = 100
    max_failures: int = 10
    step_deadline_s: Optional[float] = None   # watchdog (None = off)
    async_save: bool = True


def block_until_ready(tree):
    """Wait for the card's work on any CUDA tensor of `tree`."""
    for leaf in leaves(tree):
        if torch.is_tensor(leaf) and leaf.device.type == "cuda":
            torch.cuda.synchronize(leaf.device)
            return


class Supervisor:
    def __init__(self, cfg: SupervisorConfig, *, state):
        """state: the initial train state tree."""
        self.cfg = cfg
        self.state = state
        self.saver = ckpt.AsyncSaver()
        self.failures = 0
        self.inject_failure_at: Optional[int] = None   # test hook
        self.events: list = []

    # ---- internals ----------------------------------------------------------
    def _run_with_watchdog(self, fn, *args):
        if self.cfg.step_deadline_s is None:
            return fn(*args)
        result, exc = [], []

        def target():
            try:
                out = fn(*args)
                block_until_ready(out)
                result.append(out)
            except Exception as e:                      # pragma: no cover
                exc.append(e)

        t = threading.Thread(target=target, daemon=True)
        t.start()
        t.join(self.cfg.step_deadline_s)
        if t.is_alive():
            raise StragglerTimeout(
                f"step exceeded {self.cfg.step_deadline_s}s deadline")
        if exc:
            raise exc[0]
        return result[0]

    def _restore(self):
        step = ckpt.latest_step(self.cfg.ckpt_dir)
        if step is None:
            self.events.append(("restart_from_scratch", None))
            return 0
        self.state, step = ckpt.restore(self.cfg.ckpt_dir, self.state)
        self.events.append(("restored", step))
        return step + 1

    # ---- main loop ----------------------------------------------------------
    def run(self, train_step: Callable, batch_fn: Callable, n_steps: int,
            *, start_step: int = 0, on_metrics: Optional[Callable] = None):
        """Runs train_step(state, batch_fn(step)) for steps [start, n)."""
        step = start_step
        while step < n_steps:
            try:
                if self.inject_failure_at is not None \
                        and step == self.inject_failure_at:
                    self.inject_failure_at = None
                    raise RuntimeError("injected failure (test hook)")
                t0 = time.monotonic()
                self.state, metrics = self._run_with_watchdog(
                    train_step, self.state, batch_fn(step))
                if on_metrics:
                    on_metrics(step, metrics, time.monotonic() - t0)
                if (step + 1) % self.cfg.ckpt_every == 0 \
                        or step + 1 == n_steps:
                    if self.cfg.async_save:
                        self.saver.save(self.state, step, self.cfg.ckpt_dir)
                    else:
                        ckpt.save(self.state, step, self.cfg.ckpt_dir)
                step += 1
            except (StragglerTimeout, RuntimeError) as e:
                self.failures += 1
                self.events.append(("failure", step, repr(e)))
                if self.failures > self.cfg.max_failures:
                    raise
                self.saver.join()
                step = self._restore()
        self.saver.join()
        return self.state
