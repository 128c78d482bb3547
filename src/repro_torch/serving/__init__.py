"""Continuous-batching serving subsystem (PyTorch port of `repro.serving`).

The same three layers as the JAX package — `engine.ServingEngine` over
`scheduler.Scheduler`, `block_manager.BlockAllocator` and
`runner.ModelRunner` — with the host layers copied unchanged and the
runner dispatching eagerly to the port's CUDA kernels.

Above the engine sits the CLUSTER layer, host code copied from the JAX
package: `Replica` (`replica.py`) wraps one full engine stack (its own
device pools and prefix cache) behind occupancy / affinity probes,
`Router` (`router.py`) fronts a cluster-wide queue with round-robin,
least-loaded and prefix-affinity placement, backpressure, sticky
placement and drain / failover, and `Autoscaler` (`autoscaler.py`)
grows and shrinks the replica set from queue depth or, with
`slo.SLOSignal` as its controller, from the TTFT burn rate. Replicas
built from one weight tree cast to the compute dtype share it on the
device.
"""
from repro_torch.serving.block_manager import BlockAllocator, PrefixMatch
from repro_torch.serving.engine import (Completion, Request, ServingEngine,
                                        multi_tenant_requests,
                                        repetitive_requests,
                                        shared_prefix_requests, summarize,
                                        synthetic_requests)
from repro_torch.serving.replica import Replica, ReplicaSnapshot
from repro_torch.serving.router import (POLICIES, Router, normalize_policy,
                                        summarize_cluster)
from repro_torch.serving.runner import ModelRunner
from repro_torch.serving.sampling import SamplingParams
from repro_torch.serving.scheduler import (Scheduler, SchedulerStats,
                                           StreamEvent)

__all__ = ["ServingEngine", "Request", "Completion", "SamplingParams",
           "StreamEvent", "SchedulerStats", "synthetic_requests",
           "shared_prefix_requests", "repetitive_requests",
           "multi_tenant_requests", "summarize",
           "Replica", "ReplicaSnapshot", "Router", "POLICIES",
           "normalize_policy", "summarize_cluster",
           "BlockAllocator", "PrefixMatch", "ModelRunner", "Scheduler"]
