"""The match runtime of the port: the queue, the always-on service and the
worker pool, copies of the reference's `repro.runtime` modules over the
port's `api` (so every device step runs through the port's `Matcher`, on
the card unless given `device="cpu"`).

    from repro_torch.runtime import MatchQueueRuntime, MatchService

  * `queue`   — `MatchQueueRuntime`: a drained queue of queries with
                re-issue, checkpoints and standing queries rolled forward
                through `Matcher.count_delta`; `execute_chunk`.
  * `service` — `MatchService`: admission with backpressure, deadline- and
                priority-aware buckets, tenants, crash recovery
                (`ServiceSupervisor`) and the open-loop driver.
  * `workers` — `WorkerPool`: spawned executor processes, each with its own
                CUDA context, a watchdog and respawn.
  * `ft`      — `FaultInjector`, the chaos schedule of the three above,
                and the training `Supervisor` (`repro_torch.runtime.ft`).
"""
from .ft import FaultInjector
from .queue import MatchQueueRuntime, QueryItem, StandingQuery, execute_chunk
from .service import (MatchService, ServiceConfig, ServiceSupervisor,
                      arrival_schedule, open_loop)
from .workers import WorkerPool

__all__ = ["FaultInjector", "MatchQueueRuntime", "QueryItem",
           "StandingQuery", "execute_chunk", "MatchService", "ServiceConfig",
           "ServiceSupervisor", "arrival_schedule", "open_loop", "WorkerPool"]
