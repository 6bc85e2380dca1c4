"""Online inference subsystem of the port: a bucketed
:class:`InferenceEngine`, the dynamically micro-batching :class:`Batcher`,
per-task pre/post-processing (:mod:`.tasks`), the pipelined dispatch plane
(:class:`ServingService`), a stdlib JSON-over-HTTP front end
(:mod:`.http`), serve telemetry (:class:`ServeTelemetry`) and request
tracing with the Prometheus /metricsz export (:class:`TraceCollector`).
"""

from bert_pytorch_tpu_torch.serve.batcher import Batcher, BatcherFull, Request
from bert_pytorch_tpu_torch.serve.engine import (BatchPlan, InferenceEngine,
                                                 StagedBatch, TaskSpec)
from bert_pytorch_tpu_torch.serve.http import make_server
from bert_pytorch_tpu_torch.serve.service import (ServiceDraining,
                                                  ServingService)
from bert_pytorch_tpu_torch.serve.stats import ServeTelemetry
from bert_pytorch_tpu_torch.serve.tasks import TASK_NAMES, build_handlers
from bert_pytorch_tpu_torch.serve.tracing import TraceCollector

__all__ = [
    "Batcher",
    "BatcherFull",
    "BatchPlan",
    "InferenceEngine",
    "Request",
    "ServeTelemetry",
    "ServiceDraining",
    "ServingService",
    "StagedBatch",
    "TaskSpec",
    "TraceCollector",
    "TASK_NAMES",
    "build_handlers",
    "make_server",
]
