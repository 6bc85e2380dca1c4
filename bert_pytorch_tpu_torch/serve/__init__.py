"""Online inference subsystem of the port: a bucketed
:class:`InferenceEngine`, the dynamically micro-batching :class:`Batcher`,
per-task pre/post-processing (:mod:`.tasks`), the pipelined dispatch plane
(:class:`ServingService`), a stdlib JSON-over-HTTP front end
(:mod:`.http`), serve telemetry (:class:`ServeTelemetry`) and request
tracing with the Prometheus /metricsz export (:class:`TraceCollector`);
and the serving fleet over replicas of ``run_server``: the
:class:`Supervisor` (:class:`ReplicaSpec` per replica), the front-tier
:class:`Router` (:func:`make_router_server`), the autoscaler, the model
registry and the canary rollout (:mod:`.autoscaler`, :mod:`.registry`,
:mod:`.rollout`). The fleet modules are stdlib-only and load by file path
too, so a fleet's parent process need not import torch
(``tools/chaos_serve.py``).
"""

from bert_pytorch_tpu_torch.serve.batcher import Batcher, BatcherFull, Request
from bert_pytorch_tpu_torch.serve.engine import (BatchPlan, InferenceEngine,
                                                 StagedBatch, TaskSpec)
from bert_pytorch_tpu_torch.serve.http import make_server
from bert_pytorch_tpu_torch.serve.router import (Router, RouterShed,
                                                 make_router_server)
from bert_pytorch_tpu_torch.serve.service import (ServiceDraining,
                                                  ServingService)
from bert_pytorch_tpu_torch.serve.stats import ServeTelemetry
from bert_pytorch_tpu_torch.serve.supervisor import ReplicaSpec, Supervisor
from bert_pytorch_tpu_torch.serve.tasks import TASK_NAMES, build_handlers
from bert_pytorch_tpu_torch.serve.tracing import TraceCollector

__all__ = [
    "Batcher",
    "BatcherFull",
    "BatchPlan",
    "InferenceEngine",
    "ReplicaSpec",
    "Request",
    "Router",
    "RouterShed",
    "ServeTelemetry",
    "ServiceDraining",
    "ServingService",
    "StagedBatch",
    "Supervisor",
    "TaskSpec",
    "TraceCollector",
    "TASK_NAMES",
    "build_handlers",
    "make_router_server",
    "make_server",
]
