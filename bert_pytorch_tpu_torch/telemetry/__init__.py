"""Training telemetry of the port: the runner half of the JAX package's
``telemetry/``.

Step-time decomposition with CUDA-event device time (step_timer), bounded
``torch.profiler`` trace windows (profiler), allocator watermarks
(memory), failure sentinels + heartbeat (sentinels), grad health and the
divergence monitor (model_stats), and the versioned JSONL record schema
(schema, a copy of the JAX package's). ``TrainTelemetry`` (runner) is the
facade every training entry point threads its loop through; ``from_args``
(cli) builds it from the runners' flags.
"""

from bert_pytorch_tpu_torch.telemetry.cli import (add_cli_args,
                                                  default_jsonl_path,
                                                  from_args, stats_every)
from bert_pytorch_tpu_torch.telemetry.memory import MemorySampler
from bert_pytorch_tpu_torch.telemetry.model_stats import (DivergenceError,
                                                          DivergenceMonitor,
                                                          grad_health,
                                                          health_record,
                                                          is_due,
                                                          step_with_health)
from bert_pytorch_tpu_torch.telemetry.profiler import (ProfilerWindow,
                                                       parse_profile_spec)
from bert_pytorch_tpu_torch.telemetry.runner import TrainTelemetry
from bert_pytorch_tpu_torch.telemetry.schema import (SCHEMA_VERSION,
                                                     validate_file,
                                                     validate_record)
from bert_pytorch_tpu_torch.telemetry.sentinels import (FailureSentinel,
                                                        Heartbeat,
                                                        HeartbeatWatchdog,
                                                        NonFiniteError)
from bert_pytorch_tpu_torch.telemetry.step_timer import (CudaEventClock,
                                                         StepTimer)

__all__ = [
    "CudaEventClock",
    "DivergenceError",
    "DivergenceMonitor",
    "FailureSentinel",
    "Heartbeat",
    "HeartbeatWatchdog",
    "MemorySampler",
    "NonFiniteError",
    "ProfilerWindow",
    "SCHEMA_VERSION",
    "StepTimer",
    "TrainTelemetry",
    "add_cli_args",
    "default_jsonl_path",
    "from_args",
    "grad_health",
    "health_record",
    "is_due",
    "parse_profile_spec",
    "stats_every",
    "step_with_health",
    "validate_file",
    "validate_record",
]
