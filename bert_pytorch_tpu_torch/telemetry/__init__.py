"""Training telemetry of the port: the runner half of the JAX package's
``telemetry/``.

Step-time decomposition with CUDA-event device time (step_timer), bounded
``torch.profiler`` trace windows (profiler), allocator watermarks
(memory), failure sentinels + heartbeat (sentinels), grad health and the
divergence monitor (model_stats), and the versioned JSONL record schema
(schema, a copy of the JAX package's); the debug planes: the crash flight
recorder (flightrec), the live introspection hub and its debug server
(introspect), the host sampler and on-demand capture controller behind
``POST /profilez`` (sampler), and the kernel-build compile records
(compile_events). ``TrainTelemetry`` (runner) is the facade every
training entry point threads its loop through; ``from_args`` (cli) builds
it from the runners' flags.
"""

from bert_pytorch_tpu_torch.telemetry.cli import (add_cli_args,
                                                  default_jsonl_path,
                                                  from_args, stats_every)
from bert_pytorch_tpu_torch.telemetry.compile_events import CompileMonitor
from bert_pytorch_tpu_torch.telemetry.flightrec import (FlightRecorder,
                                                        read_postmortem)
from bert_pytorch_tpu_torch.telemetry.introspect import (IntrospectionHub,
                                                         make_debug_server,
                                                         start_debug_server)
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
from bert_pytorch_tpu_torch.telemetry.sampler import (CaptureController,
                                                      ThreadSampler)
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
    "CaptureController",
    "CompileMonitor",
    "CudaEventClock",
    "DivergenceError",
    "DivergenceMonitor",
    "FailureSentinel",
    "FlightRecorder",
    "Heartbeat",
    "HeartbeatWatchdog",
    "IntrospectionHub",
    "MemorySampler",
    "NonFiniteError",
    "ProfilerWindow",
    "SCHEMA_VERSION",
    "StepTimer",
    "ThreadSampler",
    "TrainTelemetry",
    "add_cli_args",
    "default_jsonl_path",
    "from_args",
    "grad_health",
    "health_record",
    "is_due",
    "make_debug_server",
    "parse_profile_spec",
    "read_postmortem",
    "stats_every",
    "start_debug_server",
    "step_with_health",
    "validate_file",
    "validate_record",
]
