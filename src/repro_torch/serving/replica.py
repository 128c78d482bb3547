"""Replica: one full serving-engine stack behind a routable facade
(PyTorch port of `repro.serving.replica`).

The unit a cluster router places work onto. Each replica owns a
COMPLETE engine — scheduler, block manager, runner, its own paged
device pools — exactly the paper's distribution model: all per-token
state (paged KV blocks, recurrent slot snapshots, the content-hash
prefix index) stays replica-LOCAL, and the only things that ever cross
the replica boundary are placement decisions (a Request) and
completions/stream events coming back. Nothing else is shared, so
replicas never synchronize with each other.

The weights are the one thing replicas may share: params already on
the engine's device in the compute dtype pass through every runner
untouched (`lm.cast_params` returns such a tensor as it is), so N
replicas built from one cast tree hold one copy of the weights and N
sets of pools. Cast once before building them (the serve CLI does).

What the router reads from a replica:

  snapshot()       a ReplicaSnapshot of occupancy telemetry — queue
                   depth, active/free slots, free blocks, cached-block
                   count (built on the scheduler's SchedulerStats
                   accessor, not internals)
  probe_prefix()   the prefix-affinity signal: how many leading tokens
                   of a prompt this replica's BlockAllocator already
                   holds (a read-only `match_prefix` content-hash
                   probe)

What the router does to a replica:

  submit()/step()  place a request / advance the engine one iteration
  take_queued()    drain: pull queued-but-unadmitted requests back out
                   so a disabled replica's backlog can requeue on the
                   rest of the cluster (admitted requests keep their
                   slots and finish where they are — placement is
                   sticky for a request's lifetime)
  begin_run(t0)    reset per-run telemetry and align this replica's
                   clock with the cluster clock so timestamps merge
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.observability import NULL_OBS, Observability
from repro_torch.serving.scheduler import Completion, Request, SchedulerStats


@dataclasses.dataclass(frozen=True)
class ReplicaSnapshot:
    """Occupancy/telemetry snapshot of one replica (router input):
    replica identity + the scheduler's structured SchedulerStats,
    re-exposed as flat read-only properties for placement code."""
    replica_id: int
    enabled: bool
    stats: SchedulerStats

    @property
    def queue_depth(self) -> int:     # placed here, not yet admitted
        return self.stats.queue_depth

    @property
    def active_slots(self) -> int:
        return self.stats.active_slots

    @property
    def free_slots(self) -> int:
        return self.stats.free_slots

    @property
    def free_blocks(self) -> int:     # allocatable KV blocks
        return self.stats.free_blocks

    @property
    def cached_blocks(self) -> int:   # cached-free warm prefix blocks
        return self.stats.cached_blocks

    @property
    def indexed_blocks(self) -> int:  # blocks published in the index
        return self.stats.indexed_blocks

    @property
    def spilled_blocks(self) -> int:  # blocks demoted to the host tier
        return self.stats.spilled_blocks

    @property
    def load(self) -> int:
        """Slot + queue occupancy — the least-loaded placement signal."""
        return self.stats.load


class Replica:
    """One engine stack with an id, an enable/drain bit, and the
    occupancy + affinity probes the router places on. All engine
    keyword arguments (`device` among them: default CUDA) pass through
    to `ServingEngine`."""

    def __init__(self, params, cfg, *, replica_id: int = 0,
                 obs: Observability = NULL_OBS, **engine_kwargs):
        self.replica_id = replica_id
        self.enabled = True
        # each replica publishes through a view of the shared recorder
        # scoped to its id: replica-labeled instruments, pid=replica_id
        # tracks in the exported trace
        self.engine = ServingEngine(
            params, cfg, obs=(obs or NULL_OBS).scoped(replica_id),
            **engine_kwargs)
        self.placed = 0               # requests currently owned (net of
        #                               drained requeues) — telemetry

    # ------------------------------------------------------------------
    # engine pass-throughs
    # ------------------------------------------------------------------

    @property
    def scheduler(self):
        return self.engine.scheduler

    @property
    def num_slots(self) -> int:
        return self.engine.num_slots

    @property
    def has_work(self) -> bool:
        return self.engine.has_work

    def submit(self, req: Request) -> None:
        self.engine.submit(req)
        self.placed += 1

    def step(self) -> None:
        self.engine.step()

    def begin_run(self, t0: Optional[float] = None) -> None:
        self.engine.begin_run(t0)
        self.placed = 0

    def align_clock(self, t0: float) -> None:
        """Adopt the cluster clock origin without resetting telemetry
        (mid-run activation — see ServingEngine.align_clock)."""
        self.engine.align_clock(t0)

    def reset_prefix_cache(self) -> None:
        self.engine.reset_prefix_cache()

    # ------------------------------------------------------------------
    # router probes
    # ------------------------------------------------------------------

    def snapshot(self) -> ReplicaSnapshot:
        return ReplicaSnapshot(replica_id=self.replica_id,
                               enabled=self.enabled,
                               stats=self.engine.stats())

    def probe_prefix(self, prompt) -> int:
        """Affinity signal: leading tokens of `prompt` this replica's
        allocator already holds (read-only content-hash probe — takes
        no references, revives nothing, capped at len(prompt) - 1 like
        admission's own accounting). Tokens whose blocks were demoted
        to the host tier count too — the replica can revive them on
        admission, so they are real affinity the router should see.
        0 when the replica has prefix caching off."""
        if not self.engine.prefix_cache:
            return 0
        prompt = np.asarray(prompt)
        match = self.engine.allocator.match_prefix(prompt, promote=False)
        cached = match.tokens(self.engine.block_size) + match.spilled_tokens
        return min(cached, len(prompt) - 1)

    # ------------------------------------------------------------------
    # drain / completion collection
    # ------------------------------------------------------------------

    def take_queued(self) -> List[Request]:
        """Pull queued-but-unadmitted requests out (drain/failover);
        the router requeues them elsewhere. Active slots keep running."""
        out = self.engine.scheduler.take_queued()
        self.placed -= len(out)
        return out

    def take_completions(self) -> List[Completion]:
        done = self.engine.scheduler.completions
        self.engine.scheduler.completions = []
        return done
