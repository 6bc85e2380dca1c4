"""The concurrency registry: every shared mutable attribute of the port's
background-thread subsystems, with its declared guard — the JAX
package's ``analysis/concurrency.py`` over the port's modules, plus the
threads and locks only the port has.

This is the single place the port states its lock discipline.
``analysis/lock_discipline.py`` reads these entries and flags, per
owning module, any access that breaks the declared discipline
(LK501/LK502/LK503). Review memory does not scale; a registry the linter
enforces does.

Three guard kinds:

* ``lock`` — the attribute may only be read or written inside a
  ``with <lock>:`` block (any of the ``locks`` names; a Condition
  wraps its lock, so either spelling of the same mutex is accepted).
  ``allow`` lists functions where unguarded access is fine —
  ``__init__`` (no other thread can hold a reference yet) being the
  canonical case.

* ``frozen`` — the attribute is bound once in ``__init__`` and never
  reassigned; cross-thread sharing is safe because the *binding* is
  immutable (the object it names does its own locking). Any later
  assignment is a violation: it would race every reader.

* ``confined`` — the attribute belongs to ONE thread. ``forbidden_in``
  names the functions that run on *other* threads (thread targets, and
  autograd's backward thread for gradient hooks); any access there is a
  violation. This documents single-owner state honestly instead of
  wrapping it in a lock it does not need on the hot path.

Entries are keyed by module path suffix (repo-relative, '/'-separated)
and, for instance attributes, the owning class. Keep this registry in
sync with the modules it names — ``tests/test_torch_lint.py`` fails on
an entry whose module, class or function is gone, and an unregistered
shared attribute is invisible to the checker.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Tuple


@dataclass(frozen=True)
class Entry:
    module: str                    # path suffix, e.g. "utils/checkpoint.py"
    attr: str                      # global name, or self.<attr> with cls
    kind: str                      # "lock" | "frozen" | "confined"
    cls: str = ""                  # owning class ("" = module global)
    locks: Tuple[str, ...] = ()    # accepted guard names (kind="lock")
    allow: Tuple[str, ...] = ()    # functions where unguarded access is OK
    forbidden_in: Tuple[str, ...] = field(default=())  # kind="confined"
    why: str = ""                  # one-line rationale (docs + messages)


REGISTRY: Tuple[Entry, ...] = (
    # -- utils/checkpoint.py: async checkpoint writer ----------------------
    # The per-directory pending-write registry is touched by the train
    # loop (save/join) and by every background writer thread's error
    # handler.
    Entry("bert_pytorch_tpu_torch/utils/checkpoint.py", "_pending_saves",
          kind="lock", locks=("_pending_lock",),
          why="train loop + background writer threads mutate the "
              "per-directory pending-write map"),
    Entry("bert_pytorch_tpu_torch/utils/checkpoint.py", "_pending_errors",
          kind="lock", locks=("_pending_lock",),
          why="background writer threads append errors the next save/join "
              "raises"),

    # -- data/device_prefetch.py: double-buffered H2D staging --------------
    # The gauges and iterator state are CONSUMER-thread property; the
    # producer communicates only through the Queue and the stop Event
    # (both internally synchronized). Confinement, not locking, is the
    # discipline — a per-step lock on the hot path would buy nothing.
    Entry("bert_pytorch_tpu_torch/data/device_prefetch.py", "_stats",
          cls="DevicePrefetcher", kind="confined",
          forbidden_in=("_produce",),
          why="telemetry gauges read/reset by the consumer (snapshot/"
              "_observe); the producer must stay off them"),
    Entry("bert_pytorch_tpu_torch/data/device_prefetch.py", "_last_h2d_wait_s",
          cls="DevicePrefetcher", kind="confined",
          forbidden_in=("_produce",),
          why="h2d attribution handoff between __next__ and "
              "pop_h2d_wait_s, both consumer-side"),
    Entry("bert_pytorch_tpu_torch/data/device_prefetch.py", "_done",
          cls="DevicePrefetcher", kind="confined",
          forbidden_in=("_produce",),
          why="iterator-exhausted latch owned by the consumer; the "
              "producer signals completion via the queue sentinel"),
    Entry("bert_pytorch_tpu_torch/data/device_prefetch.py", "_thread",
          cls="DevicePrefetcher", kind="confined",
          forbidden_in=("_produce",),
          why="created in __next__ and joined in close(), both "
              "consumer-side; the thread never touches its own handle. "
              "close() joins for a second and abandons a producer stuck "
              "inside a pull from the source (daemon teardown ends it; "
              "the JAX prefetcher does the same)"),

    # -- data/loader.py: the in-process batch producer ---------------------
    # _iter_thread's producer (the nested ``produce``) reads the sampler
    # and dataset and talks to the consumer only through the bounded
    # Queue and the stop Event; the consumer joins it when the epoch is
    # left. The gauges are consumer property, as the prefetcher's are.
    Entry("bert_pytorch_tpu_torch/data/loader.py", "_stats",
          cls="DataLoader", kind="confined", forbidden_in=("produce",),
          why="queue-wait gauges written by the consumer (_observe_get) "
              "and read/reset by snapshot(); the producer must stay off "
              "them"),
    Entry("bert_pytorch_tpu_torch/data/loader.py", "worker_first_batch_s",
          cls="DataLoader", kind="confined", forbidden_in=("produce",),
          why="per-worker start latency of the multi-process path, "
              "written by the consumer only"),
    Entry("bert_pytorch_tpu_torch/data/loader.py", "dataset",
          cls="DataLoader", kind="frozen",
          why="read by the producer thread (and pickled to spawned "
              "workers) while the consumer iterates; a rebind would race "
              "the producer"),
    Entry("bert_pytorch_tpu_torch/data/loader.py", "sampler",
          cls="DataLoader", kind="frozen",
          why="iterated by the producer thread while the consumer reads "
              "its index for resume; the binding must not move"),

    # -- data/dataset.py: the HDF5 shard loader thread ---------------------
    # _async_load_file starts a thread on _load_hdf5 that reads the NEXT
    # shard into _next_file_data (or _next_file_error); __getitem__ takes
    # them only after joining that thread, so the hand-off is ordered by
    # the join (a discipline the three kinds here cannot state: the two
    # slots are therefore left out). Everything else is the consumer's.
    Entry("bert_pytorch_tpu_torch/data/dataset.py", "data",
          cls="ShardedPretrainingDataset", kind="confined",
          forbidden_in=("_load_hdf5", "_read_shard"),
          why="the current shard, swapped in by __getitem__ after the "
              "join; the loader thread only fills the next one"),
    Entry("bert_pytorch_tpu_torch/data/dataset.py", "_rng",
          cls="ShardedPretrainingDataset", kind="confined",
          forbidden_in=("_load_hdf5", "_read_shard"),
          why="per-sample masking generator reseeded by __getitem__"),
    Entry("bert_pytorch_tpu_torch/data/dataset.py", "file_idx",
          cls="ShardedPretrainingDataset", kind="confined",
          forbidden_in=("_load_hdf5", "_read_shard"),
          why="the walk over the shard ring, advanced by __getitem__"),
    Entry("bert_pytorch_tpu_torch/data/dataset.py", "next_file_idx",
          cls="ShardedPretrainingDataset", kind="confined",
          forbidden_in=("_load_hdf5", "_read_shard"),
          why="the shard the loader thread was started on, chosen by "
              "the consumer"),
    Entry("bert_pytorch_tpu_torch/data/dataset.py", "_next_file_thread",
          cls="ShardedPretrainingDataset", kind="confined",
          forbidden_in=("_load_hdf5", "_read_shard"),
          why="started and joined by the consumer; the thread never "
              "touches its own handle"),
    Entry("bert_pytorch_tpu_torch/data/dataset.py", "on_fault",
          cls="ShardedPretrainingDataset", kind="frozen",
          why="the loader thread reports shard-read retries through it "
              "(_emit_fault) while the consumer reads; a rebind would "
              "race the thread"),

    # -- telemetry/runner.py: the facade shared with the watchdog ----------
    # The watchdog daemon thread calls self.emit -> self.sink.write_record
    # concurrently with the train loop; safety rests on these bindings
    # never changing after __init__ (JSONLHandler locks its own file).
    Entry("bert_pytorch_tpu_torch/telemetry/runner.py", "sink",
          cls="TrainTelemetry", kind="frozen",
          why="read concurrently by the watchdog thread via emit(); a "
              "rebind would race every background emitter"),
    Entry("bert_pytorch_tpu_torch/telemetry/runner.py", "watchdog",
          cls="TrainTelemetry", kind="frozen",
          why="step_done notes liveness on it from the train loop while "
              "its own thread polls; the binding must be stable"),
    Entry("bert_pytorch_tpu_torch/telemetry/runner.py", "introspect",
          cls="TrainTelemetry", kind="frozen",
          why="emit() tees records into the hub from the train loop AND "
              "background emitters (watchdog) while debug-server HTTP "
              "threads read snapshots; the hub locks itself, the binding "
              "must not move"),
    Entry("bert_pytorch_tpu_torch/telemetry/runner.py", "flight_recorder",
          cls="TrainTelemetry", kind="frozen",
          why="emit() notes records into the ring from every emitting "
              "thread; the recorder locks itself, the binding must not "
              "move"),
    Entry("bert_pytorch_tpu_torch/telemetry/runner.py", "capture",
          cls="TrainTelemetry", kind="frozen",
          why="debug-plane HTTP threads arm it while the train loop "
              "ticks it every step boundary; the controller locks its "
              "own state, the binding must not move"),

    # -- telemetry/introspect.py: train loop vs debug-plane HTTP threads ---
    # The hub's single state dict is the debug plane's ONLY shared
    # mutable state: note_step (train loop) and observe_record (any
    # emitting thread, incl. the watchdog) write while /healthz /statsz
    # /metricsz handlers snapshot it from HTTP worker threads.
    Entry("bert_pytorch_tpu_torch/telemetry/introspect.py", "_state",
          cls="IntrospectionHub", kind="lock", locks=("_lock",),
          why="train loop + background emitters write the live snapshot "
              "while debug-server HTTP threads render it"),
    Entry("bert_pytorch_tpu_torch/telemetry/introspect.py", "capture",
          cls="IntrospectionHub", kind="frozen",
          why="attached once at wiring (TrainTelemetry.__init__, before "
              "the debug server starts) and then read by /profilez and "
              "/statsz HTTP threads; the controller locks its own state"),

    # -- telemetry/sampler.py: the host sampler + capture controller -------
    # The sampler's tallies are written by its own daemon thread per tick
    # and folded by result() after stop() joins — but stop() may race one
    # final in-flight tick, so every touch locks; _sample_once_locked
    # runs with the lock held (the suffix contract). The controller's
    # phase dict is the arm/disarm handshake: any HTTP worker arms it
    # while the owning boundary loop (train step / serve dispatch) ticks
    # it — only the phase state is shared, the trace begin/end and the
    # sampler lifecycle are serialized by boundary-loop ownership.
    Entry("bert_pytorch_tpu_torch/telemetry/sampler.py", "_samples",
          cls="ThreadSampler", kind="lock", locks=("_lock",),
          allow=("_sample_once_locked",),
          why="tick counter bumped by the sampler thread, read by "
              "result() and the _run bound check"),
    Entry("bert_pytorch_tpu_torch/telemetry/sampler.py", "_counts",
          cls="ThreadSampler", kind="lock", locks=("_lock",),
          allow=("_sample_once_locked",),
          why="self-time tallies written per tick, folded by result()"),
    Entry("bert_pytorch_tpu_torch/telemetry/sampler.py", "_stacks",
          cls="ThreadSampler", kind="lock", locks=("_lock",),
          allow=("_sample_once_locked",),
          why="collapsed-stack exemplars written with the tallies"),
    Entry("bert_pytorch_tpu_torch/telemetry/sampler.py", "_state",
          cls="CaptureController", kind="lock", locks=("_lock",),
          why="arm() (any HTTP worker thread) flips idle->armed while "
              "tick() (the owning boundary loop) advances armed->active"
              "->idle and status() snapshots it from /statsz threads"),
    Entry("bert_pytorch_tpu_torch/telemetry/sampler.py", "_sampler",
          cls="CaptureController", kind="lock", locks=("_lock",),
          why="active-phase sampler handle published by tick() and "
              "cleared on collect; shared so status/teardown paths "
              "never see a half-built sampler"),

    # -- telemetry/profiler.py: the process-wide trace latch ---------------
    # torch.profiler traces are a process-wide singleton: one latch under
    # one lock is the whole discipline — begin() refuses (returns False)
    # instead of stacking a second trace, whichever plane asks.
    Entry("bert_pytorch_tpu_torch/telemetry/profiler.py", "_TRACE_ACTIVE",
          kind="lock", locks=("_TRACE_LOCK",),
          why="startup windows and on-demand captures (train loop, serve "
              "dispatch loop) race for the one process-wide "
              "torch.profiler trace; the latch decides who wins"),

    # -- telemetry/flightrec.py: every emitting thread vs flush paths ------
    # The ring (and its accounting) is written by the train loop /
    # dispatch thread and every background emitter via note_record,
    # while incident/periodic/atexit/excepthook flushes read it — one
    # lock; *_locked helpers run with it held (the suffix contract).
    Entry("bert_pytorch_tpu_torch/telemetry/flightrec.py", "_ring",
          cls="FlightRecorder", kind="lock", locks=("_lock",),
          allow=("_append_locked", "_payload_locked"),
          why="noted by every emitting thread, drained by flush paths "
              "(incident, periodic, atexit, excepthook)"),
    Entry("bert_pytorch_tpu_torch/telemetry/flightrec.py", "_bytes",
          cls="FlightRecorder", kind="lock", locks=("_lock",),
          allow=("_append_locked", "_payload_locked"),
          why="byte-bound accounting updated with the ring"),
    Entry("bert_pytorch_tpu_torch/telemetry/flightrec.py", "_dropped",
          cls="FlightRecorder", kind="lock", locks=("_lock",),
          allow=("_append_locked", "_payload_locked"),
          why="eviction counter updated with the ring"),
    Entry("bert_pytorch_tpu_torch/telemetry/flightrec.py", "_noted",
          cls="FlightRecorder", kind="lock", locks=("_lock",),
          allow=("_append_locked", "_payload_locked"),
          why="note counter updated with the ring"),
    Entry("bert_pytorch_tpu_torch/telemetry/flightrec.py", "_unflushed",
          cls="FlightRecorder", kind="lock", locks=("_lock",),
          allow=("_append_locked",),
          why="atexit-overwrite guard: reset by flushes, bumped by notes"),
    Entry("bert_pytorch_tpu_torch/telemetry/flightrec.py", "_incident",
          cls="FlightRecorder", kind="lock", locks=("_lock",),
          why="clean-close file-removal decision shared by note/flush/"
              "close paths"),
    Entry("bert_pytorch_tpu_torch/telemetry/flightrec.py", "_closed",
          cls="FlightRecorder", kind="lock", locks=("_lock",),
          why="close() (teardown thread) flips it while emitters note"),
    Entry("bert_pytorch_tpu_torch/telemetry/flightrec.py", "_last_flush",
          cls="FlightRecorder", kind="lock", locks=("_lock",),
          why="periodic-flush cadence shared by every noting thread"),
    Entry("bert_pytorch_tpu_torch/telemetry/flightrec.py", "_last_reason",
          cls="FlightRecorder", kind="lock", locks=("_lock",),
          why="flush bookkeeping read by the atexit guard"),
    Entry("bert_pytorch_tpu_torch/telemetry/flightrec.py", "_flush_seq",
          cls="FlightRecorder", kind="lock", locks=("_lock",),
          why="payload build order, stamped with the ring state it "
              "captured"),
    Entry("bert_pytorch_tpu_torch/telemetry/flightrec.py", "_written_seq",
          cls="FlightRecorder", kind="lock", locks=("_write_lock",),
          why="newest payload on disk: a descheduled periodic flush "
              "must never clobber a newer crash payload"),

    # -- telemetry/collector.py: background loop vs manual passes ----------
    # collect_once may be driven by a test/harness thread while the
    # background loop runs — the lock serializes whole passes, so the
    # target table, tailers, pass counter, and output handle are only
    # ever touched by the pass that holds it. The *_locked helpers run
    # with it held (the suffix contract).
    Entry("bert_pytorch_tpu_torch/telemetry/collector.py", "_targets",
          cls="FleetCollector", kind="lock", locks=("_lock",),
          why="per-target sample state is rewritten every pass; a "
              "manual pass and the loop thread must never interleave"),
    Entry("bert_pytorch_tpu_torch/telemetry/collector.py", "_tails",
          cls="FleetCollector", kind="lock", locks=("_lock",),
          why="tailer offsets advance per pass; interleaved passes "
              "would double-read or skip sink records"),
    Entry("bert_pytorch_tpu_torch/telemetry/collector.py", "_passes",
          cls="FleetCollector", kind="lock", locks=("_lock",),
          allow=("_feed_stitch_locked", "_flush_stitch_locked"),
          why="pass counter bumped by whichever thread runs the pass; "
              "the stitch helpers read it for the orphan-grace clock "
              "with _lock held (the _locked suffix is their contract)"),
    Entry("bert_pytorch_tpu_torch/telemetry/collector.py", "_stitch_pending",
          cls="FleetCollector", kind="lock", locks=("_lock",),
          allow=("_feed_stitch_locked", "_flush_stitch_locked",
                 "_stitch_record"),
          why="pending trace joins fed by whichever thread drains the "
              "tailers and drained by close() on the control thread; "
              "the _locked helpers (and _stitch_record, called only "
              "from _flush_stitch_locked) run with _lock held"),
    Entry("bert_pytorch_tpu_torch/telemetry/collector.py", "_stitch_finalized",
          cls="FleetCollector", kind="lock", locks=("_lock",),
          why="close() may race a manual pass; the flag makes the "
              "force-drain exactly-once"),
    Entry("bert_pytorch_tpu_torch/telemetry/collector.py", "_out_f",
          cls="FleetCollector", kind="lock", locks=("_lock",),
          allow=("_write_locked",),
          why="timeline writes are serialized per pass; stop() closes "
              "the handle while a pass could otherwise be writing"),

    # -- serve/supervisor.py: the supervisor's own heartbeat ---------------
    # Beaten only from poll_once (the monitor thread, or the fake-clock
    # test driving passes); safety rests on the binding being stable —
    # the same contract as the serve dispatch loop's heartbeat.
    Entry("bert_pytorch_tpu_torch/serve/supervisor.py", "_heartbeat",
          cls="Supervisor", kind="frozen",
          why="beaten by the monitor thread's poll pass while start()/"
              "stop() run on control-plane threads; the binding must "
              "never change after __init__"),

    # -- telemetry/sentinels.py: the watchdog's own shared state -----------
    Entry("bert_pytorch_tpu_torch/telemetry/sentinels.py", "_last",
          cls="HeartbeatWatchdog", kind="lock", locks=("_lock",),
          why="written by the train loop (note), read by the watchdog "
              "thread (check)"),
    Entry("bert_pytorch_tpu_torch/telemetry/sentinels.py", "_flagged",
          cls="HeartbeatWatchdog", kind="lock", locks=("_lock",),
          why="re-arm latch shared by note (train loop) and check "
              "(watchdog thread)"),
    Entry("bert_pytorch_tpu_torch/telemetry/sentinels.py", "stalls_flagged",
          cls="HeartbeatWatchdog", kind="lock", locks=("_lock",),
          why="stall counter incremented by the watchdog thread, read by "
              "runners/tests"),

    # -- serve/service.py: HTTP workers vs stage threads vs signal handler -
    Entry("bert_pytorch_tpu_torch/serve/service.py", "_draining",
          cls="ServingService", kind="lock", locks=("_state_lock",),
          why="flipped by begin_drain (signal handler / run_server) while "
              "every HTTP worker reads it in submit/health"),
    Entry("bert_pytorch_tpu_torch/serve/service.py", "_threads",
          cls="ServingService", kind="lock", locks=("_state_lock",),
          why="start/stop rebind the stage-thread list while HTTP workers "
              "read liveness through dispatch_alive for /healthz"),
    Entry("bert_pytorch_tpu_torch/serve/service.py", "_forming",
          cls="ServingService", kind="lock", locks=("_state_lock",),
          why="forming-batch depth gauge written by the assembler stage, "
              "read by /healthz and /metricsz scrape threads"),
    Entry("bert_pytorch_tpu_torch/serve/service.py", "_stage_inflight",
          cls="ServingService", kind="lock", locks=("_state_lock",),
          why="per-stage in-flight batch markers written by the executor "
              "and completion threads, swept by stop()'s fail-or-flush "
              "drain on the caller's thread"),
    Entry("bert_pytorch_tpu_torch/serve/service.py", "_handoff",
          cls="ServingService", kind="frozen",
          why="depth-1 staged-batch queue shared by the assembler and "
              "executor stages (a Queue locks itself); the binding must "
              "never change after __init__"),
    Entry("bert_pytorch_tpu_torch/serve/service.py", "_completed_q",
          cls="ServingService", kind="frozen",
          why="executed-batch queue shared by the executor and completion "
              "stages plus stop()'s flush; the binding must never change "
              "after __init__"),
    Entry("bert_pytorch_tpu_torch/serve/service.py", "_hungry",
          cls="ServingService", kind="frozen",
          why="executor-is-waiting event read by the assembler's "
              "admission window (an Event locks itself); the binding "
              "must never change after __init__"),
    Entry("bert_pytorch_tpu_torch/serve/service.py", "_batches_assembled",
          cls="ServingService", kind="confined",
          forbidden_in=("_execute_loop", "_complete_loop", "_loop",
                        "submit", "health", "metrics_text"),
          why="admit_hold chaos-hook counter owned by the assembler "
              "stage; no other stage or scrape path may touch it"),
    Entry("bert_pytorch_tpu_torch/serve/service.py", "_last_exec_end",
          cls="ServingService", kind="confined",
          forbidden_in=("_assemble_loop", "_complete_loop",
                        "submit", "health", "metrics_text"),
          why="serial-mode executor-gap timestamp owned by the single "
              "device-calling thread (the pipelined executor keeps its "
              "own local)"),

    # -- serve/batcher.py: request FIFO + gauges ---------------------------
    Entry("bert_pytorch_tpu_torch/serve/batcher.py", "_pending",
          cls="Batcher", kind="lock", locks=("_cond", "_lock"),
          allow=("_take_head_task_locked",),
          why="HTTP workers append, the dispatch thread drains; "
              "_take_head_task_locked is called with _cond held (the "
              "_locked suffix is the contract its name states)"),
    Entry("bert_pytorch_tpu_torch/serve/batcher.py", "_inflight",
          cls="Batcher", kind="lock", locks=("_cond", "_lock"),
          allow=("_take_head_task_locked",),
          why="popped-but-unfinished accounting: the dispatch thread "
              "pops/requeues/finishes while stop()'s drain loop reads "
              "unfinished() from another thread (the requeue-during-"
              "drain fix)"),
    Entry("bert_pytorch_tpu_torch/serve/batcher.py", "depth_max",
          cls="Batcher", kind="lock", locks=("_cond", "_lock"),
          why="gauge updated under submit/requeue, read by telemetry"),
    Entry("bert_pytorch_tpu_torch/serve/batcher.py", "submitted",
          cls="Batcher", kind="lock", locks=("_cond", "_lock"),
          why="gauge updated by every submitting thread"),
    Entry("bert_pytorch_tpu_torch/serve/batcher.py", "_closed",
          cls="Batcher", kind="lock", locks=("_cond", "_lock"),
          why="close() (drain path) flips it while submit/next_batch "
              "check it"),

    # -- serve/tracing.py: dispatch thread vs /metricsz scrapes ------------
    # The per-task stats map is the request tracer's ONLY shared mutable
    # state: observe() (dispatch thread) and observe_error() (HTTP worker
    # threads) mutate it while metrics_text()/phase_snapshot() (/metricsz
    # and /statsz scrape threads) iterate it.
    Entry("bert_pytorch_tpu_torch/serve/tracing.py", "_tasks",
          cls="TraceCollector", kind="lock", locks=("_lock",),
          why="dispatch-thread observe + HTTP-worker observe_error mutate "
              "the per-task aggregates while scrape threads render "
              "/metricsz and /statsz from them"),

    # -- serve/service.py: the dispatch loop's heartbeat -------------------
    # The Heartbeat object itself is only ever beaten by one thread at a
    # time (start() before the loop thread exists, then the loop, then
    # stop() after the join); safety rests on the binding being stable.
    Entry("bert_pytorch_tpu_torch/serve/service.py", "_heartbeat",
          cls="ServingService", kind="frozen",
          why="beaten by the dispatch loop while stop()/start() run on "
              "other threads; the binding must never change after "
              "__init__ (beats are serialized by the thread lifecycle)"),
    Entry("bert_pytorch_tpu_torch/serve/service.py", "capture",
          cls="ServingService", kind="frozen",
          why="armed by /profilez HTTP workers while the dispatch/"
              "completion loop ticks it at the same boundary the "
              "heartbeat rides; the controller locks its own state, the "
              "binding must not move"),

    # -- serve/stats.py: dispatch thread vs /statsz scrapes ----------------
    Entry("bert_pytorch_tpu_torch/serve/stats.py", "total_requests",
          cls="ServeTelemetry", kind="lock", locks=("_lock",),
          why="observe_batch (dispatch thread) increments while HTTP "
              "workers snapshot for /statsz"),
    Entry("bert_pytorch_tpu_torch/serve/stats.py", "total_batches",
          cls="ServeTelemetry", kind="lock", locks=("_lock",),
          why="same writer/reader split as total_requests"),
    Entry("bert_pytorch_tpu_torch/serve/stats.py", "total_errors",
          cls="ServeTelemetry", kind="lock", locks=("_lock",),
          why="observe_error is called from HTTP worker threads too"),
    Entry("bert_pytorch_tpu_torch/serve/stats.py", "_cold_start",
          cls="ServeTelemetry", kind="lock", locks=("_lock",),
          why="engine-startup stats written once by observe_cold_start "
              "(the thread that ran warmup) while HTTP workers read them "
              "via snapshot() for /statsz"),
    Entry("bert_pytorch_tpu_torch/serve/stats.py", "_tracer",
          cls="ServeTelemetry", kind="lock", locks=("_lock",),
          why="attached once by the service before dispatch starts, read "
              "by snapshot()/finish() on scrape and shutdown threads"),

    # -- serve/router.py: scrape thread vs router worker threads -----------
    # One lock guards the whole router: the background scrape rewrites
    # replica health while every concurrent request thread balances on
    # it (_admit/_pick_hedge), feeds the latency history, and bumps the
    # window/run counters; dispatch/hedge worker threads release
    # in-flight slots through the same table.
    Entry("bert_pytorch_tpu_torch/serve/router.py", "_replicas",
          cls="Router", kind="lock", locks=("_lock",),
          allow=("_window_record_locked",),
          why="scrape thread rewrites health/queue gauges while request "
              "threads pick replicas and mutate inflight counts; "
              "_window_record_locked runs with _lock held (the _locked "
              "suffix is its contract)"),
    Entry("bert_pytorch_tpu_torch/serve/router.py", "_latencies",
          cls="Router", kind="lock", locks=("_lock",),
          why="dispatch worker threads append successful-request "
              "latencies while request threads read the hedge-threshold "
              "percentile from them"),
    Entry("bert_pytorch_tpu_torch/serve/router.py", "_win",
          cls="Router", kind="lock", locks=("_lock",),
          why="window accumulator: every request thread folds its "
              "outcome in; flush_window (any thread) swaps it out"),
    Entry("bert_pytorch_tpu_torch/serve/router.py", "_run",
          cls="Router", kind="lock", locks=("_lock",),
          why="run-level accumulator shared by request threads and "
              "/statsz snapshot readers"),
    Entry("bert_pytorch_tpu_torch/serve/router.py", "_trace_seq",
          cls="Router", kind="lock", locks=("_lock",),
          why="trace-id sequence bumped by every concurrent request "
              "thread in _mint_trace; a duplicate id would stitch two "
              "requests into one tree"),
    Entry("bert_pytorch_tpu_torch/serve/router.py", "_heartbeat",
          cls="Router", kind="frozen",
          why="beaten from the scrape thread (plus one final flush in "
              "stop() after that thread is joined); Heartbeat.beat is "
              "single-owner, so safety rests on the binding never "
              "moving"),
    Entry("bert_pytorch_tpu_torch/serve/router.py", "_split",
          cls="Router", kind="lock", locks=("_lock",),
          why="rollout controller installs/widens/clears the canary "
              "split while every request thread reads it for cohort "
              "assignment and folds outcomes into its accumulators; "
              "split_window swaps the cohorts out from the observe "
              "loop's thread"),
    Entry("bert_pytorch_tpu_torch/serve/router.py", "_version_requests",
          cls="Router", kind="lock", locks=("_lock",),
          why="per-version counters bumped by every admitting/hedging "
              "request thread while /metricsz and /statsz scrape "
              "threads snapshot them"),
    Entry("bert_pytorch_tpu_torch/serve/router.py", "_next_target_index",
          cls="Router", kind="lock", locks=("_lock",),
          why="monotone target-index mint bumped by add_target "
              "(autoscaler thread) while the scrape thread and request "
              "threads walk the table it indexes; a reused index would "
              "alias two replicas' stats"),

    # -- serve/engine.py: the swappable params slot ------------------------
    # _swap_lock makes (spec.params, serving_version, _swap_epoch) one
    # atomic unit: swap_params flips all three in one acquisition while
    # the executor thread captures all three in one acquisition — a
    # mixed read (new params, old version) is the torn serve the
    # _torn_serves counter exists to falsify.
    Entry("bert_pytorch_tpu_torch/serve/engine.py", "serving_version",
          cls="InferenceEngine", kind="lock", locks=("_swap_lock",),
          why="swap_params (control/HTTP thread) flips it with the "
              "params reference while the executor thread captures "
              "both for the forward pass and /statsz reports it"),
    Entry("bert_pytorch_tpu_torch/serve/engine.py", "_swap_epoch",
          cls="InferenceEngine", kind="lock", locks=("_swap_lock",),
          why="bumped per flip; the executor re-reads it after the "
              "forward pass to detect a torn capture"),
    Entry("bert_pytorch_tpu_torch/serve/engine.py", "_swaps",
          cls="InferenceEngine", kind="lock", locks=("_swap_lock",),
          why="swap counter written by swap_params, read by "
              "swap_stats() from scrape threads"),
    Entry("bert_pytorch_tpu_torch/serve/engine.py", "_torn_serves",
          cls="InferenceEngine", kind="lock", locks=("_swap_lock",),
          why="executor increments on a detected torn capture while "
              "scrape threads read it for /statsz (the rollout's "
              "zero-tolerance gate)"),
    Entry("bert_pytorch_tpu_torch/serve/engine.py", "_swap_inflight",
          cls="InferenceEngine", kind="lock", locks=("_swap_lock",),
          why="single-swap admission flag: concurrent /swapz callers "
              "race to set it; the loser gets SwapBusy (409)"),

    # -- serve/supervisor.py: monitor thread vs control-plane callers ------
    # The replica table (and every _Replica field reached through it) is
    # written by the monitor thread's poll pass while start/stop/status
    # run on the caller's thread.
    Entry("bert_pytorch_tpu_torch/serve/supervisor.py", "_replicas",
          cls="Supervisor", kind="lock", locks=("_lock",),
          why="monitor thread reaps/restarts/kills replicas while "
              "start()/stop()/status() read and mutate the same table "
              "from control-plane threads"),
    Entry("bert_pytorch_tpu_torch/serve/supervisor.py", "_next_index",
          cls="Supervisor", kind="lock", locks=("_lock",),
          why="monotone replica-index mint bumped by add_replica "
              "(autoscaler thread) while the monitor thread walks the "
              "table; an index reuse would alias a drained replica's "
              "heartbeat/postmortem baselines onto a fresh incarnation"),

    # -- serve/autoscaler.py: control loop vs status readers ---------------
    # The controller's decision state (evidence counters, cooldown
    # bookkeeping, the membership chain tail) is mutated by the loop
    # thread's tick() while status() snapshots it from the chaos
    # harness / HTTP threads; the fleet adapter's pending-drain list is
    # shared between tick() (reap) and whatever thread began the drain.
    Entry("bert_pytorch_tpu_torch/serve/autoscaler.py", "_pending_drains",
          cls="ElasticFleet", kind="lock", locks=("_lock",),
          why="two-phase drains: begin_drain appends while tick()'s "
              "reap_drained sweeps and draining() is read from status "
              "threads"),
    Entry("bert_pytorch_tpu_torch/serve/autoscaler.py", "_reds",
          cls="AutoscalerController", kind="lock", locks=("_lock",),
          why="consecutive-red evidence counter bumped/reset by tick() "
              "while status() reads it"),
    Entry("bert_pytorch_tpu_torch/serve/autoscaler.py", "_greens",
          cls="AutoscalerController", kind="lock", locks=("_lock",),
          why="consecutive-green evidence counter bumped/reset by "
              "tick() while status() reads it"),
    Entry("bert_pytorch_tpu_torch/serve/autoscaler.py", "_ticks",
          cls="AutoscalerController", kind="lock", locks=("_lock",),
          why="tick counter bumped by the loop thread, read by "
              "status()"),
    Entry("bert_pytorch_tpu_torch/serve/autoscaler.py", "_scale_ups",
          cls="AutoscalerController", kind="lock", locks=("_lock",),
          why="action counter bumped by tick(), read by status()"),
    Entry("bert_pytorch_tpu_torch/serve/autoscaler.py", "_scale_downs",
          cls="AutoscalerController", kind="lock", locks=("_lock",),
          why="action counter bumped by tick(), read by status()"),
    Entry("bert_pytorch_tpu_torch/serve/autoscaler.py", "_last_scale_at",
          cls="AutoscalerController", kind="lock", locks=("_lock",),
          allow=("_cooldown_remaining",),
          why="cooldown anchor written on every scaling action, read by "
              "the next tick's cooldown check (_cooldown_remaining runs "
              "with _lock held — tick() only calls it inside the "
              "decision block)"),
    Entry("bert_pytorch_tpu_torch/serve/autoscaler.py", "_last_direction",
          cls="AutoscalerController", kind="lock", locks=("_lock",),
          why="thrash detection reads the previous action's direction "
              "while tick() rewrites it"),
    Entry("bert_pytorch_tpu_torch/serve/autoscaler.py", "_last_after",
          cls="AutoscalerController", kind="lock", locks=("_lock",),
          why="membership chain tail (exogenous-drift baseline) carried "
              "between ticks, read by status()"),
    Entry("bert_pytorch_tpu_torch/serve/autoscaler.py", "_last_emitted",
          cls="AutoscalerController", kind="lock", locks=("_lock",),
          why="hold-dedup key carried between ticks on the loop "
              "thread; guarded because status readers share the lock"),
    Entry("bert_pytorch_tpu_torch/serve/autoscaler.py", "_thrash",
          cls="AutoscalerController", kind="lock", locks=("_lock",),
          why="the structurally-impossible counter (zero-tolerance "
              "gate): bumped by tick(), asserted on by the chaos "
              "harness via status()"),
    Entry("bert_pytorch_tpu_torch/serve/autoscaler.py", "_last_error",
          cls="AutoscalerController", kind="lock", locks=("_lock",),
          why="loop-thread actuation/scrape errors surfaced to "
              "status() readers"),

    # -- serve/rollout.py: observe loop vs status readers ------------------
    # One lock guards the whole stage state: observe() runs on a
    # scheduler thread while status() is read from HTTP handlers and
    # start() from the control plane.
    Entry("bert_pytorch_tpu_torch/serve/rollout.py", "_stage",
          cls="RolloutController", kind="lock", locks=("_lock",),
          why="observe() advances it while status() renders it from "
              "HTTP handler threads"),
    Entry("bert_pytorch_tpu_torch/serve/rollout.py", "_greens",
          cls="RolloutController", kind="lock", locks=("_lock",),
          why="consecutive-green counter bumped/reset by observe() "
              "while status() reads it"),
    Entry("bert_pytorch_tpu_torch/serve/rollout.py", "_state",
          cls="RolloutController", kind="lock", locks=("_lock",),
          why="idle/canary/promoted/rolled_back transitions from "
              "start()/observe() while status() and the next observe() "
              "check it"),
    Entry("bert_pytorch_tpu_torch/serve/rollout.py", "_windows",
          cls="RolloutController", kind="lock", locks=("_lock",),
          why="window counter bumped per observation, read by "
              "status()"),

    # -- serve/registry.py: manifest cache ---------------------------------
    Entry("bert_pytorch_tpu_torch/serve/registry.py", "_cache",
          cls="ModelRegistry", kind="lock", locks=("_lock",),
          allow=("_read_locked", "_write_locked"),
          why="publish/set_state write-through while list_versions/get "
              "read from rollout, CLI, and HTTP threads; disk is the "
              "source of truth, the cache only skips re-reads"),

    # -- ops/kernels/autotune.py: the geometry-winners registry ------------
    # The process-global winners table is written by the serve engine's
    # startup (load/measure) and read by every kernel call (the port has
    # no trace time); a pipelined dispatch plane launches from its
    # executor thread while a test/control thread may load or clear
    # winners, so every touch goes through the module lock.
    Entry("bert_pytorch_tpu_torch/ops/kernels/autotune.py", "_winners",
          kind="lock", locks=("_lock",),
          why="engine startup loads/measures winners while kernel calls "
              "look geometry up from whichever thread launches"),

    # -- ops/kernels/build.py: the kernel library cache --------------------
    # Libraries are built and loaded at first use from whichever thread
    # launches first: the serving stages, the trainers' loop and
    # autograd's backward thread all reach load(); the cache and its
    # build directory are shared under the module lock.
    Entry("bert_pytorch_tpu_torch/ops/kernels/build.py", "_libraries",
          kind="lock", locks=("_lock",),
          why="loaded CDLLs by name, filled by load()/load_host() from "
              "any launching thread (autograd's included) and read by "
              "ensure()"),

    # -- telemetry/compile_events.py: build and kernel-cost notes ----------
    # report_build and note_kernel arrive from whichever thread builds or
    # launches — for the backward kernels that is autograd's thread —
    # while the loop thread installs monitors and runs instrumented calls.
    Entry("bert_pytorch_tpu_torch/telemetry/compile_events.py",
          "_installed", kind="lock", locks=("_lock",),
          why="monitors installed/uninstalled by the loop and serving "
              "threads while builds on any thread report to them"),
    Entry("bert_pytorch_tpu_torch/telemetry/compile_events.py", "_calls",
          kind="lock", locks=("_lock",),
          why="instrumented calls running, pushed and popped by the loop "
              "thread; kernel notes from autograd's thread (which has no "
              "thread-local call) find the innermost one here"),

    # -- parallel/overlap.py: the bucketed gradient reducer ----------------
    # With overlap on, every parameter's post-accumulate-grad hook
    # (_on_grad, and the _launch_locked it triggers) runs on autograd's
    # backward thread, while arm()/finish() run on the loop thread before
    # and after the backward; the bucket state is touched under one lock.
    Entry("bert_pytorch_tpu_torch/parallel/overlap.py", "_armed",
          cls="GradReducer", kind="lock", locks=("_lock",),
          why="set by arm() on the loop thread, read by the gradient hooks "
              "on autograd's thread, cleared by finish()"),
    Entry("bert_pytorch_tpu_torch/parallel/overlap.py", "_seen",
          cls="GradReducer", kind="lock", locks=("_lock",),
          why="per-bucket arrival counts, reset by arm() and bumped by "
              "the gradient hooks on autograd's thread"),
    Entry("bert_pytorch_tpu_torch/parallel/overlap.py", "_pending",
          cls="GradReducer", kind="lock", locks=("_lock",),
          allow=("_launch_locked",),
          why="launched buckets' work handles, written by the hooks on "
              "autograd's thread and by finish() on the loop thread, "
              "which waits on them; _launch_locked runs with _lock held"),
    Entry("bert_pytorch_tpu_torch/parallel/overlap.py", "launches",
          cls="GradReducer", kind="lock", locks=("_lock",),
          allow=("_launch_locked",),
          why="launch order, appended by the hooks on autograd's thread "
              "and by finish() on the loop thread"),
    Entry("bert_pytorch_tpu_torch/parallel/overlap.py", "_buckets",
          cls="GradReducer", kind="frozen",
          why="bucket membership read by the hooks on autograd's thread; "
              "the binding must not move"),

    # -- utils/logging.py: the JSONL sink background emitters write --------
    Entry("bert_pytorch_tpu_torch/utils/logging.py", "_f",
          cls="JSONLHandler", kind="lock", locks=("_lock",),
          allow=("__init__",),
          why="watchdog/shard-retry/async-writer threads emit records "
              "concurrently with the train loop"),
)

