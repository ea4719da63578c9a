"""Fault injection for the match runtime's chaos runs.

`FaultInjector` is a copy of the reference's `repro.runtime.ft.FaultInjector`
(plain Python, seeded). The reference's training `Supervisor` lives in the
same module but needs a checkpoint manager of the training stack, so it
comes with the port's training slice.
"""
from __future__ import annotations

import random

__all__ = ["FaultInjector"]


class FaultInjector:
    """Fault schedule for the match service's and the worker pool's chaos
    runs (and, with the training slice, a training supervisor), in two
    composable modes:

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
