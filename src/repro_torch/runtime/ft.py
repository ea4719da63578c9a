"""Fault tolerance: fault injection for chaos runs, and the training
supervisor (checkpoint, restart on failure, straggler detection).

`FaultInjector` is a copy of the reference's `repro.runtime.ft.FaultInjector`
(plain Python, seeded). `Supervisor` is the reference's over the port's
`train.checkpoint`; a restore writes the checkpoint into the live state's
tensors in place, because the port's train step updates the model's
parameters in place.
"""
from __future__ import annotations

import dataclasses
import random
import time
from typing import Callable

import torch

from repro_torch.train.checkpoint import CheckpointManager

__all__ = ["FaultInjector", "SuperviseResult", "Supervisor"]


class FaultInjector:
    """Fault schedule for the training supervisor and for the match
    service's and the worker pool's chaos runs, in two composable modes:

      * deterministic — raise at the given step indices (`fail_at`), sleep
        at others (`straggle_at`); each index fires at most once, so a
        restarted run that replays the same step is not killed again;
      * probabilistic — every `check()` draws from a private
        `random.Random(rng_seed)` and raises with probability `fail_rate`.
        The draw sequence depends only on the seed and the number of
        `check()` calls, so a chaos run is reproducible from
        (rng_seed, fail_rate) instead of a hand-enumerated index set.

    Both modes raise RuntimeError; `faults_fired` counts probabilistic
    fires (deterministic ones are in `fired`).

    Process-level chaos (the out-of-process worker pool,
    `runtime.workers`): `kill_worker_at` marks dispatch indices
    whose worker is SIGKILLed mid-bucket (`kill_worker()` — real process
    death, recovered by pipe-EOF detection + respawn), and `hang_at`
    maps dispatch indices to seconds the executing worker sleeps before
    starting (`hang()` — indistinguishable from a wedged enumeration, so
    the pool watchdog must SIGKILL it past its deadline). Both fire at
    most once per index, like `fail_at`: the re-issued bucket gets a
    fresh dispatch index anyway, and a restarted run replaying an index
    is not killed again."""

    def __init__(self, fail_at: set[int] | None = None,
                 straggle_at: dict[int, float] | None = None, *,
                 fail_rate: float = 0.0, rng_seed: int = 0,
                 kill_worker_at: set[int] | None = None,
                 hang_at: dict[int, float] | None = None):
        if not 0.0 <= fail_rate < 1.0:
            raise ValueError(f"fail_rate must be in [0, 1), got {fail_rate}")
        self.fail_at = set(fail_at or ())
        self.straggle_at = dict(straggle_at or {})
        self.fired: set[int] = set()
        self.fail_rate = fail_rate
        self.rng = random.Random(rng_seed)
        self.faults_fired = 0
        self.kill_worker_at = set(kill_worker_at or ())
        self.hang_at = dict(hang_at or {})
        self.kills_fired: set[int] = set()
        self.hangs_fired: set[int] = set()

    def check(self, step: int) -> None:
        """Raise RuntimeError if a fault is scheduled (or drawn) for this
        call; otherwise return. Called once per supervised step/dispatch."""
        if step in self.fail_at and step not in self.fired:
            self.fired.add(step)
            raise RuntimeError(f"injected fault at step {step}")
        if self.fail_rate and self.rng.random() < self.fail_rate:
            self.faults_fired += 1
            raise RuntimeError(
                f"injected probabilistic fault at step {step} "
                f"(fire #{self.faults_fired})")

    def delay(self, step: int) -> float:
        """Seconds of injected straggle for this step (0.0 when none)."""
        return self.straggle_at.get(step, 0.0)

    def kill_worker(self, step: int) -> bool:
        """True if the worker executing this dispatch should be SIGKILLed
        (fires at most once per index)."""
        if step in self.kill_worker_at and step not in self.kills_fired:
            self.kills_fired.add(step)
            return True
        return False

    def hang(self, step: int) -> float:
        """Seconds the worker executing this dispatch should wedge before
        starting (0.0 when none; fires at most once per index)."""
        if step in self.hang_at and step not in self.hangs_fired:
            self.hangs_fired.add(step)
            return self.hang_at[step]
        return 0.0


@dataclasses.dataclass
class SuperviseResult:
    state: object
    steps_run: int
    restarts: int
    stragglers: list[int]
    history: list[dict]


def _restore_into(state, restored) -> None:
    """Copy every leaf of `restored` into the same leaf of `state`, in
    place: the step function keeps using the tensors it holds (the model's
    parameters, the optimizer's moments), so new tensors would not reach
    it."""
    if isinstance(state, dict):
        for k in state:
            _restore_into(state[k], restored[k])
    elif isinstance(state, (list, tuple)):
        for a, b in zip(state, restored):
            _restore_into(a, b)
    else:
        with torch.no_grad():
            state.copy_(restored)


class Supervisor:
    def __init__(self, ckpt_dir: str, *, ckpt_every: int = 10, keep: int = 3,
                 max_restarts: int = 8, deadline_factor: float = 4.0):
        self.mgr = CheckpointManager(ckpt_dir, keep=keep,
                                     interval_steps=ckpt_every)
        self.max_restarts = max_restarts
        self.deadline_factor = deadline_factor

    def _restore(self, state):
        """The manifest of the newest checkpoint, written into `state`'s
        tensors, or None when there is none."""
        restored, manifest = self.mgr.restore_or_none(state)
        if restored is not None:
            _restore_into(state, restored)
        return manifest

    def run(self, state, step_fn: Callable, batch_fn: Callable,
            n_steps: int, *,
            injector: FaultInjector | None = None) -> SuperviseResult:
        """step_fn(state, batch) -> (state, metrics), where state is a
        tree of tensors the step reads (and may update in place);
        batch_fn(step) -> batch (deterministic — replayable). Resumes from
        the newest checkpoint; on a failed step, restores the newest one
        and replays from its next_step."""
        manifest = self._restore(state)
        start = 0
        if manifest is not None:
            start = int(manifest["extra"].get("next_step", manifest["step"]))
        restarts = 0
        stragglers: list[int] = []
        history: list[dict] = []
        times: list[float] = []
        step = start
        while step < n_steps:
            try:
                if injector is not None:
                    injector.check(step)
                t0 = time.perf_counter()
                if injector is not None:
                    time.sleep(injector.delay(step))
                batch = batch_fn(step)
                state, metrics = step_fn(state, batch)
                metrics = {k: float(v) for k, v in metrics.items()}
                dt = time.perf_counter() - t0
                # trailing mean excludes the first (compile-heavy) step
                ref = times[1:] if len(times) > 1 else times
                if ref and dt > self.deadline_factor * (sum(ref) / len(ref)):
                    stragglers.append(step)
                times.append(dt)
                history.append({"step": step, **metrics})
                step += 1
                self.mgr.maybe_save(step, state,
                                    extra={"next_step": step})
            except Exception:   # noqa: BLE001 — any step failure → restart
                restarts += 1
                if restarts > self.max_restarts:
                    raise
                manifest = self._restore(state)
                step = (0 if manifest is None else
                        int(manifest["extra"].get("next_step",
                                                  manifest["step"])))
        self.mgr.maybe_save(step, state, extra={"next_step": step},
                            force=True)
        self.mgr.wait()
        return SuperviseResult(state=state, steps_run=step - start,
                               restarts=restarts, stragglers=stragglers,
                               history=history)
