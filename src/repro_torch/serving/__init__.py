"""Continuous-batching serving subsystem (PyTorch port of `repro.serving`).

The same three layers as the JAX package — `engine.ServingEngine` over
`scheduler.Scheduler`, `block_manager.BlockAllocator` and
`runner.ModelRunner` — with the host layers copied unchanged and the
runner dispatching eagerly to the port's CUDA kernels. The cluster layer
(replica / router / autoscaler) is a later slice.
"""
from repro_torch.serving.block_manager import BlockAllocator, PrefixMatch
from repro_torch.serving.engine import (Completion, Request, ServingEngine,
                                        repetitive_requests,
                                        shared_prefix_requests, summarize,
                                        synthetic_requests)
from repro_torch.serving.runner import ModelRunner
from repro_torch.serving.sampling import SamplingParams
from repro_torch.serving.scheduler import (Scheduler, SchedulerStats,
                                           StreamEvent)

__all__ = ["ServingEngine", "Request", "Completion", "SamplingParams",
           "StreamEvent", "SchedulerStats", "synthetic_requests",
           "shared_prefix_requests", "repetitive_requests", "summarize",
           "BlockAllocator", "PrefixMatch", "ModelRunner", "Scheduler"]
