#!/usr/bin/env python3
"""Drive the PyTorch / CUDA port on one NVIDIA card and check it.

    python3 chip_smoke.py        # from the repository root, on a CUDA machine

Phases (any failure exits non-zero and prints no result line):

1. the card: name and power limit (``nvidia-smi``); no CUDA device = fail;
2. build every CUDA kernel from the sources in the checkout (one ``nvcc``
   per source, all started together): the two serving kernels (fp and
   int8 scores), the three training kernels (forward, dq, dkv) and the
   LayerNorm forward kernel;
3. hold each kernel against its plain PyTorch version on the card at the
   shapes the main paths give it (B=8, H=16, D=64, S in {128, 512}, bf16
   and fp32, padded rows and packed rows; the int8 kernel and its plain
   version fed the same int8 q/k and scales; the training kernels also at
   dropout 0 and 0.1 with a fixed seed, comparing out, lse, dq, delta,
   dk, dv and dbias, each within the tolerance stated below). The two
   serving kernels also run the edges of their tensor-core route (bf16:
   ragged S=200 at D=64 and 128, D=128 at S=512; fp32 S=200 on the
   CUDA-core route), padded with row 0's every key masked and packed with
   row 0 all pad, and each launch must take the route ``infer_route``
   names (bf16 -> tensor cores, fp32 -> CUDA cores). The training
   forward, dq and dkv run in bf16 on both routes (the one ``train_route``
   picks, through the wrapper, and the CUDA-core one), and on the edges of
   the tensor-core route (ragged S=200 at D=32, 64 and 128, the fully
   masked and all-pad rows, rates 0 and 0.1); the keep mask each route of
   each drew, read from its outputs, must equal ``philox_keep_mask`` bit
   for bit (B=8, H=16, S=512 and a ragged S=200, rates 0 and 0.1);
4. time each kernel, its plain version and the one PyTorch call that
   computes the same function (``scaled_dot_product_attention``: forward
   for the forward kernels, forward + backward for dq and dkv; for the
   int8 kernel, which no single PyTorch call computes, bf16 SDPA on the
   dequantized q and k), beside the least time the card could take for
   the same work. The serving kernels and SDPA are timed by device time
   per call (``torch.profiler``: at S=128 a kernel takes less card time
   than the host needs to issue it), with CUDA-event times of 100 calls
   back to back beside them, and in bf16 also by the device time of the
   same kernel on its CUDA-core route; the training kernels the same way
   (device time per call, CUDA events beside), each on both routes and,
   at S=512 bf16, at rate 0 as well as 0.1 (the keep mask's cost),
   SDPA's backward alone as its forward + backward less its forward;
5. the serving main path, from checkpoints: the four heads' seeded
   weights at full BERT-large width (configs/bert_large_uncased_config.json,
   a demo vocab), as an in-memory server holds them, are written with the
   port's ``save_checkpoint`` (about 1.3 GB of fp32 a head, after a check
   of the free disk; the write and load seconds of each head are logged),
   then ``run_server.build_service`` with ``--tasks
   fill_mask,classify,squad,ner`` and the four ``--<task>_checkpoint``
   directories serves fill_mask, classify, squad and ner over HTTP, packed
   and unpacked, over both buckets; the serving kernel must launch once
   per encoder layer per forward, every launch on its tensor-core route.
   Every head's loaded weights must equal the in-memory ones bit for bit,
   and every request's ``run_direct`` answer the in-memory server's.
   Then the hot-swap: a classify + squad server from the checkpoints
   keeps eight clients sending requests while ``POST /swapz`` swaps
   classify to a checkpoint of other seeded weights as v2; every request
   answers 200, /healthz and /statsz report v2, one swap and no torn
   serve, the answers after it equal a fresh engine's from that
   checkpoint, and the swap's ``load_s`` is logged.
   Then one staged fp32 fill_mask batch
   through a ``flash_infer`` engine and a ``dense`` engine with the same
   seeded weights must agree;
5c. the int8 serving main path: ``build_service`` from the same
   checkpoints with ``--quantize int8 --attention_backend
   flash_infer_int8 --fuse_epilogues --pack_requests``, the same waves
   plus one fill_mask request with 9 [MASK]s (past the 8 gather slots, so
   one batch takes the unfused forward; squad takes the stacked-span
   forward, classify and ner none); the int8 weights quantized as they
   stream in must equal ``quantize_state_dict`` of the in-memory weights
   bit for bit; the int8 kernel must launch once per encoder layer per
   forward, every launch on its tensor-core route, and the fp kernel
   never; the int8 engine's weight bytes are
   logged beside the fp32 engine's. The checkpoints are deleted. Then one
   staged fp32-compute
   fill_mask batch from the same seeded weights: int8 scores on fp32
   weights must agree with the fp32 engine to the JAX package's int8
   attention bound, the fused gather must equal the unfused batch's
   [MASK] rows, and with int8 weights the int8-score engine must agree
   with a dense-attention one to the JAX package's 1e-1 at 2 layers of
   BERT-large width, and at full depth by no more than int8 weights
   alone move the logits (check_int8_engines);
6. the training main path: the pretraining runner's own setup functions
   and train step (configs/bert_pretraining_phase2_config.json at
   BERT-large width: S=512, max_pred 80, remat dots, LAMB with poly
   warmup, bf16, the flash kernels), four optimizer steps of local batch
   8 x accumulation 2 on seeded synthetic batches masked by the port's
   dataset code. Every loss finite, the first within 1 of ln(30528) +
   ln(2), and the launch counts exact: per step 2 x 24 x 2 forward
   launches (remat recomputes the forward) and 24 x 2 each of dq and dkv,
   every forward, dq and dkv launch on its tensor-core route.
   Then an fp32 training step with the flash kernels and with dense
   attention (2 layers at BERT-large width, dropout 0, the same weights
   and batch) must agree in loss, gradients and updated parameters;
7. the LayerNorm forward kernel against its plain version at the rows the
   paths give it ([32*384, 1024], [8*512, 1024], [7, 768]; bf16 and fp32;
   one all-zero and one constant row, whose variance is 0): out, mean and
   rstd within the tolerances stated below; the autograd Function's
   gradients against autograd through the plain LayerNorm; its device time
   per call (``torch.profiler``: the kernel alone takes less than the
   host's time to issue it) beside its plain version's,
   ``torch.nn.functional.layer_norm``'s and its bound, and CUDA-event
   times of 100 calls back to back. Then each kernel's cost note (a
   ``ctypes`` launch is invisible to the cost counter's dispatch mode, so
   every wrapper notes its flops and its bound's bytes to the counter of
   the instrumented call running) against the counter's count of its
   plain version on the same inputs, each an instrumented call (S=128
   bf16, #6 at [4096, 1024]): the same flops, noted once (``cost_note`` in the
   kernels line);
8. the SQuAD main path: ``run_squad.main`` at BERT-large width on seeded
   synthetic SQuAD files (max_seq_length 384, doc_stride 128, batch 32,
   bf16, AdamW, ``--layer_norm_backend kernel``): three optimizer steps,
   prediction and the official eval script. Every loss finite, the first
   within 1 of ln(384), one prediction per question, EM and F1 reported,
   and the LayerNorm kernel launched exactly 1 + 2 x 24 times per forward
   (steps + prediction batches) and no other kernel. The serving and
   pretraining paths keep the plain LayerNorm: the kernel launches never
   there. Its final checkpoint (no ``--skip_checkpoint``) verifies and
   reads back equal to the trained params. Its telemetry holds the
   ``compile`` and ``compile_cost`` records of ``train_step`` and
   ``predict_step`` (the cost counter's first call of each), each count
   holding #6's cost notes, 1 + 2 x 24;
9. the two-phase pretraining hand-off on the runner's own functions
   (``drive_handoff``, BERT-large's width at 6 layers since PR 17,
   after a check of 6 GiB of free disk):
   phase 1 at S=128 (local batch 32 x 2, 2 steps, a synchronous save),
   then phase 2 at S=512 in the same directory with
   ``--previous_phase_end_step 2`` and the flash kernels (the resumed
   params and moments bit-equal to phase 1's final state, the optimizer
   count 0; 4 steps with phase 6's launch counts on the tensor cores;
   async saves at steps 4 and 6 keeping 2, so ckpt_2 is pruned; the
   saving step's stall, the steps overlapping the background write and
   its seconds logged); a fresh runner resumes it bit for bit and one
   more step from each agrees (bit for bit where the kernels are
   deterministic); a truncated newest file is walked back past, with the
   skip logged. The phase-2 run has the runner's telemetry armed
   (``--telemetry_window 2 --telemetry_sync_every 1 --profile_steps 2:3
   --heartbeat_file --grad_stats_every 1``): its JSONL passes the port's
   schema, every window is synced on every step with 0 < device_p50 <=
   step_p50 and a device-basis mfu in (0, 1] that its record recomputes
   to 1e-4, each memory record's peak equals
   ``torch.cuda.max_memory_allocated()`` at its window's last step, the
   trace of step 2 holds as many #1-#3 launches as the counters count
   over that step, grad health covers every layer on every step, the
   heartbeat reads the last step, and the last window's device span sits
   between the traced step's kernel time and the step's wall time;
10. ``run_glue``, ``run_ner`` and ``run_swag`` at BERT-large width and
   phase 9's depth from phase 9's checkpoint on seeded synthetic files (S=128; batch 32, 32,
   16; 3 steps, ``--save_steps 1`` and the final save; metrics printed;
   each final checkpoint reads back equal; GLUE with ``--telemetry_window
   3``, its JSONL schema-clean with a nonzero mfu), then ``run_server`` serves
   the GLUE checkpoint (``--tasks classify --classify_checkpoint``): one
   dev example answered over HTTP with #4 once per layer per forward on
   the tensor cores, its logits within 5e-2 of the GLUE model's; then each
   runner again for 9 steps without checkpoints, for its seq/s;
11. K-FAC pretraining on the runner's own functions (``drive_kfac``,
   BERT-large phase 2 at 6 layers since PR 17: S=512, flash, remat dots, LAMB, bf16, local batch
   8 x 2, after a check of 6 GiB of free disk): 4 steps with ``--kfac
   --kfac_factor_interval 1 --kfac_inv_interval 2`` (fused capture,
   cholesky) and a sync final save keeping 1 (every loss finite, count 4,
   symmetric factors, phase 6's launches per step on the tensor cores);
   a fresh runner resumes it (params, moments, factors and count
   bit-equal, inverses recomputed) and one more step from each agrees;
   2 steps with ``--kfac_capture stats --kfac_stats_batch 4`` (one more
   forward, dq and dkv per layer per factor-due step); the K-FAC step
   against the plain one in turns with its capture, inverse and
   precondition device times and one 4097² ``eigh``
   (``tools/profile_train.kfac_turns``); then at 2 layers of BERT-large
   width, fp32, dropout 0, the fused capture against the stats pass and
   remat none against dots, and eigen and cholesky preconditioning
   against float64 and against each other (``check_kfac_parity``);
12. fp16 mixed precision: 12a (run with phases 3, 4 and 7, so fp16 and
   bf16 are timed at the same point of the process) the training
   forward, dq and dkv in fp16
   against their plain versions (S in SEQS, padded and packed, rates 0
   and 0.1, both routes, the tensor-core route's edges; within the fp16
   row of TRAIN_TOL), their keep masks bit for bit, their times beside
   fp16 SDPA, and the LayerNorm kernel in fp16 at [32*384, 1024] and
   [8*512, 1024] (one fp16 ulp + LN_OUT_ATOL) beside fp16
   ``F.layer_norm``; 12b phase 6 in fp16 (every step at the default loss
   scale 65536, the first loss within 5% of phase 6's bf16 one, the same
   launches, all on the tensor cores, peak memory); 12c the runner's own
   loop, at 6 layers since PR 17, from ``--init_loss_scale 2**40``
   (``drive_fp16_overflow``): the
   first step skipped with params and moments unchanged and the scale
   halved, a sentinel record for every overflowing step, the scale
   following the wrapper's rule until the steps train; 12d its final
   save resumed in a fresh runner bit for bit, scale and growth count
   included, and the next trained step bit-equal; 12e ``run_squad``
   in fp16 as phase 8 (49 LayerNorm launches per forward, EM and F1);
13. the debug planes: 13a ``run_server.build_service`` with
   ``--output_dir`` (the JSONL sink teed into the flight recorder, the
   heartbeat, the ``/profilez`` capture controller, the compile monitor)
   serving fill_mask and classify at BERT-large width (``--buckets
   128,512 --max_batch_size 8 --pack_requests``, flash_infer), and a
   service without any of them on the same engine: phase 5a's waves for
   those heads through each in 8 balanced turns of 3 rounds (the
   telemetry's cost on p50 and max latency), then ``POST /profilez``
   (``duration_s`` 2) over the short wave. The warmup's compile records must show no
   cold build and one hit for the one library the engine runs; #4 once
   per layer per forward on the tensor cores; the capture's trace must
   hold as many #4 kernel events as launches in its window (24 per
   forward), its ``profile_window`` record the trace's path and bytes;
   the heartbeat must advance to the requests served, and the clean
   close must remove the postmortem. 13b a ``run_server`` subprocess
   with ``--output_dir`` sent SIGTERM as the first of phase 5a's waves'
   answers arrives: exit 75, every accepted request answered 200, the
   preemption ``fault`` record in its JSONL and in the postmortem it
   keeps, its warmup line naming no cold build. Phase 9b runs with
   ``--debug_port``: /healthz and /statsz read mid-run, and a capture
   armed at step 2's boundary covers steps 3 and 4, its trace holding the
   #1-#3 launches the counters count there (4/2/2 per layer per step). Phase 6
   ends with four more steps in turns, plain and under an active capture
   (its cost on a phase-2 step), and phase 2's build logs its compile
   records (the cold ``nvcc`` seconds per library);
14. the serving fleet (``drive_fleet``): the port's chaos harness
   (``bert_pytorch_tpu_torch/tools/chaos_serve.py``, a torch-free
   parent) as a subprocess, its ``run_server`` replicas on the card at
   BERT-large width and ``FLEET_LAYERS`` (6) layers since PR 20 (bf16,
   ``--attention_backend flash_infer``, classify,
   ``--buckets 128 --max_batch_size 8``), each mode with a fresh
   ``--compile_cache_dir``: 14a ``--smoke`` (two replicas; SIGKILL in
   the admission window, a wedge caught by the heartbeat watchdog, a
   kill mid-drain, a kill mid-swap, the fleet swapped to a published
   version, then a ``POST /profilez`` capture on replica 0 under a
   steady burst), 14b ``--canary`` (publish, canary, promote, a breach
   rolled back), 14c ``--surge`` (scale-up under a shedding burst, a
   SIGKILL mid-surge, a drained scale-down). Each verdict must be ok:
   zero client-visible failures, zero torn serves, ``compiles_cold`` 0
   on the restarts, swaps and the scale-up, one cold build of
   ``flash_attention_infer`` across 14a's first replicas (the build
   lock; since PR 20 14b and 14c start from a compile dir seeded with
   that build, and build nothing), the report gates exiting 1 on their breach copies and 0 on
   the clean ones; 14a's capture must hold one #4 kernel event per layer
   per ``serve_forward`` range in its trace and no more than the launches
   the replica counted around it, and the replica's compile records
   must name the library. The replicas' card memory: each one's
   allocator peak from its ``/statsz``, and the card's least free memory
   while each mode ran (``torch.cuda.mem_get_info`` once a second); the
   card's free memory must come back to within 1 GiB once the fleets
   stop. #4's ``launches_fleet`` sums the launches
   the final replicas of the three modes report on ``/statsz``;
15. the feed of a long pretraining run (``drive_feed``), phase 6's shape
   through ``run_pretraining.main`` over ``SyntheticPretrainingDataset``
   rows, 6 steps a run: 15a ``--device_prefetch`` 0 then 2 (traced; 6
   layers since PR 17), then an untraced run of each (2, then 0; 24
   layers) and 0 again without the cost counter, per-step losses
   bit-equal within each pair, the step p50 of each depth, #1-#3 4/2/2
   per layer per step, the traced steps 2-3 holding the staged batch's
   copies as pinned-to-device memcpys on a stream other than the compute
   kernels', data_wait and h2d_wait p50 of schema-clean
   windows; 15c ``--num_workers 2 --num_steps_per_eval 2 --eval_batches
   4``, the losses 15a's (so its two workers' batches are the in-process
   loader's) and each worker's start to its first batch, ``val`` records
   at steps 2, 4 and 6 each equal to ``pretrain.make_eval_step`` on that
   step's params and batches, the
   eval forward on #1 (24 launches a batch; #4 none); 15d
   ``--fault_spec nonfinite@3`` under ``--sentinel_policy abort`` raising
   with its injected record (6 layers since PR 17), then the kill cycle
   at dropout 0 and 6 layers: a child with ``die@4`` and synchronous saves every 2 steps
   dies by SIGKILL, its newest checkpoint is truncated, and a fresh
   child walks back to step 2 (its ``resume`` record naming the skip)
   and runs to step 6 with the losses of an uninterrupted run bit for
   bit. Every entry of the kernels
   line carries ``launches_feed`` (15a's untraced prefetch-2 run), #1 also
   ``launches_feed_eval`` (15c's held-out forwards, counted around each of
   that run's held-out passes). The compile and cost attribution
   (``--telemetry_cost_analysis``) rides on these runs: 15a's traced
   prefetch-0 run counts under ``full`` (its ``temp_bytes``, the allocator
   peak before it kept in its memory records, the flops of the auto run
   beside it; the traced prefetch-2 run after it reads peaks no higher
   than the allocator's), the untraced pair under ``auto``, and a third
   untraced run, prefetch 0 again under ``off`` (no ``compile_cost``; its
   losses the counted runs' bit for bit, its first step and steps 2-6
   p50 beside the prefetch-0 ``auto`` run's: the counter's cost); the
   untraced prefetch-2 run's ``train_step`` flops equal the closed form
   from the layer shapes (flash's notes, the remat recompute of #1
   included) and its 192
   kernel notes, 96 of them from the backward, and the ratio to
   utils/flops.py's model flops is logged; 15c's records hold
   ``eval_step``'s too;
16. RoBERTa-large and the text path (``drive_roberta``), the repo's
   ``configs/roberta_large_cased_config.json`` at full width and, since
   PR 20, ``ROBERTA_LAYERS`` (6) layers (no NSP, byte-level BPE), bf16,
   seeded random weights: 16a a cold
   build of the C++ tokenizer core into a fresh build directory (its
   ``compile`` record), then ``make_synthetic_text`` -> ``shard`` ->
   ``build_vocab --tokenizer bpe``, its ``[MASK]`` moved to the last id
   as the published vocab's mask token is; 16b ``run_pretraining.main``
   in phase 6's shape on that vocab (4 steps, the mask id the run logs
   the tokenizer's ``[MASK]`` and not 4, no NSP loss, 4/2/2 launches of
   #1/#2/#3 per layer per step, a final sync save); 16c ``run_glue`` MRPC ``--tokenizer
   bpe`` from it (3 steps of 32 at S=128, final save); 16d ``run_server
   --tasks classify,fill_mask`` from both checkpoints over HTTP (one
   launch of #4 per layer per forward, the classify logits the GLUE model's
   within ``GLUE_SERVE_ATOL``, the fill_mask top-k held against the same
   model with dense attention on the same features, the handler's
   decode of known in-vocab top-k ids); 16e ``tools/batch_infer`` on a
   file of the same 32 requests in runs of one task, packed up to 8 a
   batch, each result 16d's answer within the tolerances, one launch of
   #4 per layer per forward; then the same file with ``--quantize int8
   --attention_backend flash_infer_int8 --fuse_epilogues``, each result
   16d's answer within the int8 bound (log-probabilities within
   ``INT8_LOGIT_ATOL``, 1e-1), one launch of #5 per layer per forward and
   none of #4; then ``tools/bench_loader`` over synthetic rows and
   ``tools/bench_tokenizer`` on 16a's BPE vocabulary, their JSON lines
   logged. #1-#4 carry ``launches_roberta`` (16b's and 16d's), #4 also
   ``launches_roberta_batch_infer`` (16e's), #5
   ``launches_roberta_batch_infer_int8``;
17. pretraining across ranks (``drive_mesh``), each part a
   ``python -m torch.distributed.run`` of the runner: 17a at world size 1
   on nccl (``--mesh dp=1``) through ``run_pretraining.main`` in phase
   6's shape on phase 6's rows, 4 steps: #1-#3 96/48/48 per step on the
   tensor cores and the losses phase 6's bit for bit; 17b two ranks
   sharing the card (so gloo: NCCL refuses two ranks on one device),
   ``--mesh dp=2`` at full width and 6 layers, 3 steps at dropout 0 and
   0.1 and with ``--overlap_grad_reduce``: the ranks' parameters
   bit-equal after every step, the first loss at dropout 0 within
   ``P17_LOSS_RTOL`` of one process's step on the same 16 rows, the
   overlap's buckets heads, encoder, embeddings and its fp32 weights
   within 1e-6 of the plain reduction's; 17c ``--mesh fsdp=2`` on the
   same ranks (FSDP2 over gloo), 2 steps, then a sharded save (a shard
   file a rank) and a gathered one of the same state, each resumed by
   the runner at world size 1: the restored states and the next step
   from each bit-equal. Each rank counts its own launches (phase 6's per
   step); the training kernels carry ``launches_mesh_dp1`` (17a),
   ``launches_mesh_dp2`` (17b's three runs, rank 0) and
   ``launches_mesh_fsdp2`` (17c, rank 0);
18. model-parallel pretraining (``drive_model_parallel``), one
   ``torch.distributed.run`` of 4 ranks sharing the card over gloo at
   BERT-large width and 6 layers, 16 rows a step, the runner's own
   functions: 18a ``--mesh pipe=2,model=2`` (GPipe over 2 stages of 3
   layers, each layer split over 2 model ranks), 2 steps at dropout 0,
   the first loss within ``P17_LOSS_RTOL`` of one process's step on the
   same rows, a sharded save resumed at world size 1 with the same state
   digest; 18b ``--mesh pipe=2,seq=2`` at S=512 (ring attention inside
   each stage), one step at dropout 0 (the same bar) and one at 0.1,
   and one ring layer's output and q/k/v gradients against the plain
   dense attention with the ring's dropout masks at TRAIN_TOL's bf16
   bars; 18c ``--mesh dp=4 --kfac`` (factors and inverses every step), 2
   steps, the K-FAC state digests equal on the 4 ranks and the first
   update (the preconditioned gradients) within ``P18_KFAC_UPDATE_RTOL``
   of one process's, a planted fault (the factors without the replica
   count) beyond it. Each rank counts its
   launches: #1-#3 2/1/1 a layer a microbatch for its layers in 18a and
   18c, none in 18b; the training kernels carry rank 0's as
   ``launches_mp_pp_tp``, ``launches_mp_pp_sp`` and
   ``launches_mp_kfac_dp4``;
19. measured attention geometry for serving (``drive_autotune``): 19a
   every candidate geometry of #4 and #5 (ops/kernels/autotune.py
   ``candidates``: block_q 64/128, block_k 64/128, bh_block 1-8 at B=8,
   H=16, D=64) at S in SEQS, padded and packed, against its plain version
   at ATOL, each candidate's time by ``autotune.measure`` (CUDA events
   over 100 back-to-back launches behind a sleep), its winner, and the
   winner, the default (64, 64, 1) and SDPA by device time beside the
   bound; 19b ``run_server`` subprocesses at BERT-large width (fill_mask
   and classify, buckets 128 and 512, batch 8) sharing one fresh
   ``--compile_cache_dir`` (seeded with the libraries built at the
   start): A ``--autotune measure`` (``measured`` records, a winners file
   stamped with the card), B
   ``--autotune load`` (``cached`` records, the same winners, every
   compile record a hit, answers bit-equal to A's), C with autotune off
   (answers within P19_SCORE_ATOL of A's), D the int8 path with
   ``--autotune measure``; 24 launches of the path's kernel per forward
   in each (``/statsz``, the measurement's launches left out). #4 and
   #5 carry ``geometries`` (each candidate's time and error), ``winner``
   (per S) and ``launches_autotune`` (A's, D's);
20. the last pretraining layouts (``drive_layouts``), 4 ranks sharing
   the card over gloo at BERT-large width and 6 layers, 16 rows a step,
   the runner's own functions, in phase 18's ``torch.distributed.run``
   (each rank runs 18's parts, then 20's: ``drive_phases_18_and_20``;
   the ranks start once): 20a ``--mesh fsdp=2,pipe=2`` (GPipe over 2 stages of 3
   layers, each stage's layers FSDP2 units on its fsdp group), 2 steps
   at dropout 0, the first loss within ``P17_LOSS_RTOL`` of one
   process's step on the same rows, the ranks' losses and state digests
   equal, a sharded save resumed at world size 1 with the same digest;
   20b ``--mesh fsdp=2,seq=2`` at S=512 (the ring inside FSDP2 units),
   one step at dropout 0 (the same bar) and one at 0.1 (finite); 20c
   ``--mesh fsdp=2,model=2 --kfac`` and 20d ``--mesh dp=2,seq=2
   --kfac`` (the fused capture, factors and inverses every step), 2 steps
   each, the K-FAC digests equal on the 4 ranks, the first whole update
   within ``P18_KFAC_UPDATE_RTOL`` of one process's and phase 18's
   planted fault beyond it. Each rank counts its launches: #1-#3 2/1/1 a
   layer a microbatch for its layers in 20a (3, all heads) and 20c (6,
   H/2 heads), none in 20b and 20d; the training kernels carry rank 0's
   as ``launches_mesh_fsdp_pp``, ``launches_mesh_fsdp_sp``,
   ``launches_mesh_fsdp_kfac_tp`` and ``launches_mesh_kfac_sp``;
21. the static analysis on the port (``drive_lint``): the port's lint
   gate, ``python -m bert_pytorch_tpu_torch.tools.check_all``, in a
   subprocess of the card machine's Python — torchlint over the port's
   package and this script against the committed baseline, the telemetry
   schema over every JSONL file the earlier phases wrote (copies of the
   serving phases' taken before their directory goes), the winners format
   over 19b's two winners files; one line with the files linted, the
   findings and the seconds, and any finding, stale baseline entry or
   failing artifact fails the run. No kernel runs.

``python3 chip_smoke.py --only 18`` runs phase 18 alone, ``--only 19``
phase 19, ``--only 20`` phase 20 and ``--only 21`` phase 19 then 21 (the
kernels built, the phase, its result line; none of the contract's
lines); ``--only 14 [--fleet_layers
N]`` runs phase 14 (its replicas build #4 themselves) at FLEET_LAYERS
layers or at N.

Every launch counter is set to 0 just before each main path and read just
after it (phase 14's and 19b's counters live in their replicas, fresh
processes whose counters start at 0, and are read from their
``/statsz``). The last three lines of standard output are the kernels JSON,
the card's name and power limit (``nvidia-smi``), and the JSON result.
"""

from __future__ import annotations

import http.client
import json
import math
import os
import re
import shutil
import signal
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import traceback
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from typing import Sequence

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

# H100 SXM data-sheet peaks (dense): bf16 tensor cores, fp32 CUDA cores,
# HBM3 bandwidth.
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float16: 989e12,
              torch.float32: 67e12}
PEAK_BYTES_PER_S = 3.35e12
# Kernel-vs-plain tolerances: fp32 differs only in summation order; bf16
# rounds P to bf16 before PV at tile-local maxima (the plain version rounds
# at the row maximum) and rounds the output to bf16.
ATOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
# fp32 logits of the flash and dense engines over 24 layers: the same
# math, summed in another order.
ENGINE_ATOL = 1e-3
B, H, D = 8, 16, 64
SEQS = (128, 512)
CONFIG = os.path.join(REPO, "configs", "bert_large_uncased_config.json")
REPLACES = "bert_pytorch_tpu/ops/pallas/attention.py:512"
# The int8-score kernel: QK^T at the H100's dense int8 tensor-core rate.
PEAK_INT8_OPS = 1979e12
INT8_REPLACES = "bert_pytorch_tpu/ops/pallas/attention.py:624"
INT8_SOURCE = "bert_pytorch_tpu_torch/csrc/flash_attention_infer_int8.cu"
# fp32 weights and compute, int8 attention scores against fp scores: the
# JAX package's bound for int8 attention on served logits
# (INT8_ATTN_MODEL_ATOL). The fused gather against the unfused batch's
# [MASK] rows: the same rows through the same head, fp32. int8-weight
# engines with int8 and with fp32 scores: the JAX package's bound
# (INT8_LOGIT_ATOL), set on a 2-layer config, at 2 layers of BERT-large
# width; at full depth, the distance int8 weights alone put between the
# dense int8 and fp32 engines in the same run (check_int8_engines).
INT8_ATTN_ATOL = 2e-2
FUSED_ATOL = 1e-5
INT8_LOGIT_ATOL = 1e-1
INT8_CHECK_LAYERS = 2
# A fill_mask request with more [MASK]s than the 8 gather slots: its batch
# runs the unfused forward.
OVERFLOW_MASKS = 9
# The four serving heads, served from checkpoints the smoke writes; the
# NER tags are run_server's default set; the classify weights the hot-swap
# loads (version v2) are drawn from SWAP_SEED.
HEADS = ("fill_mask", "classify", "squad", "ner")
NER_TAGS = ("O", "B-PER", "I-PER", "B-LOC", "I-LOC", "B-ORG", "I-ORG",
            "B-MISC", "I-MISC")
SWAP_SEED = 1234
# The LayerNorm forward kernel (TPU kernel #6): the SQuAD path's rows
# (batch 32 x 384), the pretraining path's (8 x 512) and a ragged BERT-base
# shape. Against its plain version on the same inputs: fp32 out within
# LN_OUT_ATOL (statistics summed in another order); bf16 out within one
# bf16 ulp of the plain value plus LN_OUT_ATOL (the same fp32 math, so one
# rounding step apart at most, from fp32 values up to LN_OUT_ATOL apart:
# an output near 0, where normed * scale cancels against bias, keeps that
# absolute fp32 difference while its ulp shrinks); mean within LN_STAT_RTOL relative (+ LN_STAT_ATOL for
# means near 0) and rstd within LN_STAT_RTOL relative; the Function's fp32
# gradients within LN_GRAD_RTOL of each gradient's largest magnitude
# (dscale and dbias sum 12288 rows in another order).
LN_SHAPES = ((32 * 384, 1024), (8 * 512, 1024), (7, 768))
LN_EPS = 1e-12
LN_OUT_ATOL, LN_STAT_RTOL, LN_STAT_ATOL, LN_GRAD_RTOL = 1e-5, 1e-5, 1e-7, 1e-5
LN_REPLACES = "bert_pytorch_tpu/ops/pallas/layernorm.py:25"
LN_SOURCE = "bert_pytorch_tpu_torch/csrc/layer_norm_fwd.cu"
# fp32 operations per element of the kernel (sum, center, square and sum,
# scale by rstd, scale, shift), on the CUDA cores whatever x's dtype.
LN_OPS_PER_ELEMENT = 7


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_time_ms(fn, iters: int = 100, warmup: int = 10) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# Traces read again when one lost kernel events (device_time_ms).
DEVICE_TIME_TRIES = 3


def device_time_ms(fn, iters: int = 100, warmup: int = 10) -> float:
    """Device time per call of ``fn``: the time of every CUDA kernel in a
    ``torch.profiler`` trace of ``iters`` calls after ``warmup``, summed
    and divided by ``iters``. Unlike :func:`cuda_time_ms` it leaves out
    the card's idle time between launches when the host issues them
    slower than the card runs them."""
    from torch.profiler import ProfilerActivity, profile

    from bert_pytorch_tpu_torch.tools.profile_train import device_rows

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    for attempt in range(DEVICE_TIME_TRIES):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        rows = device_rows(prof)
        events = sum(r[2] for r in rows)
        # Every call launches the same kernels, so a count that is not a
        # multiple of the calls means the trace lost events: read again.
        if events % iters == 0:
            break
        log(f"[warn] device_time_ms: {events} kernel events in the trace of "
            f"{iters} calls (try {attempt + 1} of {DEVICE_TIME_TRIES})")
    return sum(r[1] for r in rows) / iters


def attention_inputs(seq: int, dtype, packed: bool, gen: torch.Generator,
                     depth: int = D, empty_row: bool = False):
    """q, k, v [B, S, H, depth] and either the [B, 1, 1, S] key bias of rows
    with random lengths, or [B, S] sequence ids of 1-4 packed segments per
    row followed by id-0 pad. ``empty_row`` makes row 0 a padded row whose
    every key is masked, or a packed row that is all pad."""
    q, k, v = (torch.randn(B, seq, H, depth, device="cuda", generator=gen)
               .to(dtype) for _ in range(3))
    if not packed:
        lens = torch.randint(1, seq + 1, (B,), device="cuda", generator=gen)
        if empty_row:
            lens[0] = 0
        mask = torch.arange(seq, device="cuda")[None, :] < lens[:, None]
        bias = ((1.0 - mask.float()) * -10000.0)[:, None, None, :]
        return q, k, v, {"bias": bias}
    rng = np.random.default_rng(int(torch.randint(
        0, 2**31 - 1, (1,), generator=gen, device="cuda")))
    sids = np.zeros((B, seq), np.int32)
    for row in range(1 if empty_row else 0, B):
        n_seg = int(rng.integers(1, 5))
        room = int(rng.integers(n_seg, seq + 1))  # the rest is pad
        cuts = np.sort(rng.choice(np.arange(1, room), n_seg - 1,
                                  replace=False)) if n_seg > 1 else []
        bounds = [0, *cuts, room]
        for s in range(n_seg):
            sids[row, bounds[s]:bounds[s + 1]] = s + 1
    return q, k, v, {"sequence_ids": torch.from_numpy(sids).cuda()}


def sdpa_mask(q, kwargs):
    """The additive mask of ``kwargs`` in q's dtype, for SDPA."""
    if "bias" in kwargs:
        return kwargs["bias"].to(q.dtype)
    sids = kwargs["sequence_ids"]
    same = (sids[:, :, None] == sids[:, None, :]) & (sids[:, :, None] > 0)
    return torch.where(same, 0.0, -10000.0)[:, None].to(q.dtype)


def library_call(q, k, v, kwargs):
    """The one PyTorch call computing the same function (a yardstick only;
    the port never calls it): scaled_dot_product_attention with the same
    additive mask."""
    mask = sdpa_mask(q, kwargs)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    return lambda: torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask)


def bound_ms(seq: int, dtype, depth: int = D) -> tuple:
    """(least time in ms, what bounds it): q, k, v read once and out written
    once (+ the [B, S] fp32 key bias), against 4*B*H*S^2*D operations: the
    bytes and flops of ``infer_cost``, which the kernel's cost note reads
    too."""
    from bert_pytorch_tpu_torch.ops.kernels.attention import infer_cost

    cost = infer_cost(B, seq, H, depth, dtype)
    t_bytes = cost.bytes_accessed / PEAK_BYTES_PER_S * 1e3
    t_ops = cost.flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# Checked beyond the timed grid, for the tensor-core route's edges: (S,
# head_dim, dtypes). S=200 is ragged (not a multiple of the 64-row tile)
# and D=128 takes two 128-byte boxes per row; each runs padded and packed
# with row 0 fully masked (every key -10000) or all pad.
EDGE_CASES = ((200, 64, (torch.bfloat16, torch.float32)),
              (200, 128, (torch.bfloat16,)), (512, 128, (torch.bfloat16,)))


def attention_cases():
    """(seq, depth, dtype, packed, empty_row, timed) of the phase-3/4
    grid: SEQS x {bf16, fp32} x {padded, packed} at D, timed, then
    EDGE_CASES."""
    for seq in SEQS:
        for dtype in (torch.bfloat16, torch.float32):
            for packed in (False, True):
                yield seq, D, dtype, packed, False, True
    for seq, depth, dtypes in EDGE_CASES:
        for dtype in dtypes:
            for packed in (False, True):
                yield seq, depth, dtype, packed, True, False


def check_case(label: str, name: str, dtype, out, ref) -> float:
    err = (out.float() - ref.float()).abs().max().item()
    finite = bool(torch.isfinite(out).all())
    log(f"[check] {label} {name}: max_abs_err {err:.3e} (atol "
        f"{ATOL[dtype]:g}), finite {finite}")
    if not finite or not err <= ATOL[dtype]:
        raise AssertionError(f"{label} disagrees with its plain version at "
                             f"{name}: {err} > {ATOL[dtype]}")
    return err


def time_case(kernel, plain, library, cuda_cores=None) -> dict:
    """Device time per call (``torch.profiler``) of the kernel, of the
    library call and, for a bf16 case, of the same kernel on its CUDA-core
    route; CUDA-event times per call of 100 back to back (with the host's
    issue time) of the kernel, the plain version and the library call."""
    out = {"ms": device_time_ms(kernel), "event_ms": cuda_time_ms(kernel),
           "plain_ms": cuda_time_ms(plain, iters=20, warmup=2),
           "library_ms": device_time_ms(library),
           "library_event_ms": cuda_time_ms(library)}
    if cuda_cores is not None:
        out["cuda_core_ms"] = device_time_ms(cuda_cores)
    return out


def log_times(label: str, name: str, t: dict, bound: tuple, library: str):
    core = (f", CUDA-core route {t['cuda_core_ms']:.4f} ms"
            if "cuda_core_ms" in t else "")
    log(f"[time] {label} {name}: device time per call kernel "
        f"{t['ms']:.4f} ms, {library} {t['library_ms']:.4f} ms{core}, bound "
        f"{bound[0]:.4f} ms ({bound[1]}); CUDA events kernel "
        f"{t['event_ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, {library} "
        f"{t['library_event_ms']:.4f} ms")


def kernel_entry(name: str, source: str, replaces: str, cases: list,
                 **extra) -> dict:
    """A kernels-line entry: the headline numbers are the serving dtype at
    the larger bucket, padded, at D."""
    head = next(c for c in cases if c["seq"] == max(SEQS) and c["depth"] == D
                and c["dtype"] == "bfloat16" and not c["packed"]
                and "ms" in c)
    return dict({"name": name, "route": "cuda", "source": source,
                 "replaces": replaces, "launches": None,
                 "max_abs_err": max(c["max_abs_err"] for c in cases),
                 "ms": head["ms"], "plain_ms": head["plain_ms"],
                 "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
                 "library_ms": head["library_ms"],
                 "kernel_route": head["kernel_route"],
                 "event_ms": head["event_ms"],
                 "library_event_ms": head["library_event_ms"],
                 "cuda_core_ms": head["cuda_core_ms"], "cases": cases},
                **extra)


def check_and_time_attention() -> dict:
    """Phases 3 and 4 for the fused-attention kernel (#4)."""
    from bert_pytorch_tpu_torch.ops.kernels import attention as ka

    gen = torch.Generator(device="cuda").manual_seed(0)
    cases = []
    for seq, depth, dtype, packed, empty_row, timed in attention_cases():
        q, k, v, kw = attention_inputs(seq, dtype, packed, gen, depth,
                                       empty_row)
        route = ka.infer_route(dtype, depth)
        before = dict(ka.flash_attention_infer.route_launches)
        out = ka.flash_attention_infer(q, k, v, **kw)
        torch.cuda.synchronize()
        if ka.flash_attention_infer.route_launches[route] != before[route] + 1:
            raise AssertionError(f"flash_attention_infer did not launch on "
                                 f"its {route} route")
        name = (f"S={seq} D={depth} {str(dtype)[6:]} "
                f"{'packed' if packed else 'padded'}"
                f"{' (row 0 empty)' if empty_row else ''} [{route}]")
        err = check_case("flash_attention_infer", name, dtype, out,
                         ka.flash_attention_infer_reference(q, k, v, **kw))
        case = {"seq": seq, "depth": depth, "dtype": str(dtype)[6:],
                "packed": packed, "empty_row": empty_row,
                "kernel_route": route, "max_abs_err": err}
        if timed:
            key_bias, seg = ka._infer_bias_seg(
                kw.get("bias"), kw.get("sequence_ids"), B, seq)
            t = time_case(
                lambda: ka.flash_attention_infer(q, k, v, **kw),
                lambda: ka.flash_attention_infer_reference(q, k, v, **kw),
                library_call(q, k, v, kw),
                (lambda: ka._launch_infer(q, k, v, key_bias, seg,
                                          "cuda_cores"))
                if route == "tensor_cores" else None)
            t_bound, by = bound_ms(seq, dtype, depth)
            log_times("flash_attention_infer", name, t, (t_bound, by), "SDPA")
            case.update(t, bound_ms=t_bound, bound_by=by)
        cases.append(case)
    return kernel_entry("flash_attention_infer",
                        "bert_pytorch_tpu_torch/csrc/flash_attention_infer.cu",
                        REPLACES, cases)


def int8_bound_ms(seq: int, dtype, depth: int = D) -> tuple:
    """(least time in ms, what bounds it) for the int8-score kernel: q8 and
    k8 read once at 1 B an element, v read and out written at v's element
    size, the [B, S] fp32 key bias (or ids) and the two [B, H] fp32 scales;
    against QK^T (2*B*H*S^2*D) at the int8 rate plus PV (as many) at the
    rate of v's dtype (``infer_int8_cost``, which the kernel's cost note
    reads too)."""
    from bert_pytorch_tpu_torch.ops.kernels.attention import infer_int8_cost

    cost = infer_int8_cost(B, seq, H, depth, dtype)
    t_bytes = cost.bytes_accessed / PEAK_BYTES_PER_S * 1e3
    t_ops = (cost.int8_ops / PEAK_INT8_OPS
             + (cost.flops - cost.int8_ops) / PEAK_FLOPS[dtype]) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_and_time_int8_attention() -> dict:
    """Phases 3 and 4 for the int8-score kernel (#5). Kernel and plain
    version take the same int8 q/k and scales (quantized once), so the
    int32 scores are exact on both sides and the fp kernel's tolerances
    apply. ``wrapper_ms`` (CUDA events) also times the quantization the
    wrapper runs first; the library call is bf16 SDPA on the dequantized
    q and k."""
    from bert_pytorch_tpu_torch.ops.kernels import attention as ka

    gen = torch.Generator(device="cuda").manual_seed(3)
    cases = []
    for seq, depth, dtype, packed, empty_row, timed in attention_cases():
        q, k, v, kw = attention_inputs(seq, dtype, packed, gen, depth,
                                       empty_row)
        key_bias, seg = ka._infer_bias_seg(
            kw.get("bias"), kw.get("sequence_ids"), B, seq)
        q8, q_scale, k8, k_scale = ka.quantize_qk(q, k)
        args = (q8, k8, q_scale, k_scale, v, key_bias, seg)
        route = ka.infer_route(dtype, depth)
        before = dict(ka.flash_attention_infer_int8.route_launches)
        out = ka.flash_attention_infer_int8_prequantized(*args)
        torch.cuda.synchronize()
        if (ka.flash_attention_infer_int8.route_launches[route]
                != before[route] + 1):
            raise AssertionError(f"flash_attention_infer_int8 did not launch "
                                 f"on its {route} route")
        name = (f"S={seq} D={depth} {str(dtype)[6:]} "
                f"{'packed' if packed else 'padded'}"
                f"{' (row 0 empty)' if empty_row else ''} [{route}]")
        err = check_case("flash_attention_infer_int8", name, dtype, out,
                         ka._int8_forward_math(*args))
        case = {"seq": seq, "depth": depth, "dtype": str(dtype)[6:],
                "packed": packed, "empty_row": empty_row,
                "kernel_route": route, "max_abs_err": err}
        if timed:
            deq = [(t8.float() * s[:, None, :, None]).to(torch.bfloat16)
                   for t8, s in ((q8, q_scale), (k8, k_scale))]
            t = time_case(
                lambda: ka.flash_attention_infer_int8_prequantized(*args),
                lambda: ka._int8_forward_math(*args),
                library_call(deq[0], deq[1], v.to(torch.bfloat16), kw),
                (lambda: ka._launch_int8(*args, "cuda_cores"))
                if route == "tensor_cores" else None)
            t["wrapper_event_ms"] = cuda_time_ms(
                lambda: ka.flash_attention_infer_int8(q, k, v, **kw))
            t_bound, by = int8_bound_ms(seq, dtype, depth)
            log_times("flash_attention_infer_int8", name, t, (t_bound, by),
                      "bf16 SDPA on dequantized q/k")
            log(f"[time] flash_attention_infer_int8 {name}: wrapper "
                f"(quantize + kernel), CUDA events {t['wrapper_event_ms']:.4f}"
                f" ms")
            case.update(t, bound_ms=t_bound, bound_by=by)
        cases.append(case)
    return kernel_entry("flash_attention_infer_int8", INT8_SOURCE,
                        INT8_REPLACES, cases,
                        library="bf16 sdpa on dequantized q/k")


# Training kernels against their plain versions, per output: (atol, rtol)
# on |kernel - plain| <= atol + rtol * |plain|. fp32 differs only in
# summation order; bf16 adds P rounded at each tile's running maximum (the
# plain version rounds at the row maximum), dS and P rounded to bf16 from
# lse values that differ in their last fp32 bits, and the bf16 outputs.
TRAIN_TOL = {
    torch.float32: {"out": (2e-5, 1e-5), "lse": (2e-5, 1e-6),
                    "dq": (1e-4, 1e-4), "delta": (1e-4, 1e-5),
                    "dk": (1e-4, 1e-4), "dv": (1e-4, 1e-4),
                    "dbias": (1e-4, 1e-4)},
    torch.bfloat16: {"out": (2e-2, 2e-2), "lse": (2e-5, 1e-6),
                     "dq": (2e-2, 2e-2), "delta": (2e-3, 1e-3),
                     "dk": (2e-2, 2e-2), "dv": (2e-2, 2e-2),
                     "dbias": (2e-3, 2e-2)},
    # fp16 keeps 3 more significand bits than bf16: the outputs' bounds
    # are bf16's over 5 (about 4 fp16 ulps at 1); delta sums fp16 values
    # in fp32 as fp32 does; lse and dbias are fp32 sums, as in bf16.
    torch.float16: {"out": (4e-3, 4e-3), "lse": (2e-5, 1e-6),
                    "dq": (4e-3, 4e-3), "delta": (1e-4, 1e-5),
                    "dk": (4e-3, 4e-3), "dv": (4e-3, 4e-3),
                    "dbias": (2e-3, 2e-2)},
}
TRAIN_RATES = (0.0, 0.1)
TRAIN_SEED = 0x0123456789ABCDEF
TRAIN_REPLACES = {
    "flash_attention_fwd": "bert_pytorch_tpu/ops/pallas/attention.py:179",
    "flash_attention_dq": "bert_pytorch_tpu/ops/pallas/attention.py:242",
    "flash_attention_dkv": "bert_pytorch_tpu/ops/pallas/attention.py:293",
}
TRAIN_SOURCES = {
    "flash_attention_fwd": "bert_pytorch_tpu_torch/csrc/flash_attention_fwd.cu",
    "flash_attention_dq": "bert_pytorch_tpu_torch/csrc/flash_attention_bwd.cu",
    "flash_attention_dkv": "bert_pytorch_tpu_torch/csrc/flash_attention_bwd.cu",
}


def train_bound_ms(name: str, seq: int, dtype) -> tuple:
    """(least time in ms, what bounds it) for one training kernel at
    B x S x H x D: every operand read once and every result written once
    ([B, S, H, D] tensors in dtype; lse, delta, dbias [B*H, S] and the
    [B, S] key bias in fp32), against 2 * TRAIN_PRODUCTS * B*H*S^2*D
    operations: ``train_cost``, which the kernel's cost note reads too."""
    from bert_pytorch_tpu_torch.ops.kernels.attention import train_cost

    cost = train_cost(name, B, seq, H, D, dtype)
    t_bytes = cost.bytes_accessed / PEAK_BYTES_PER_S * 1e3
    t_ops = cost.flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _compare(name: str, got, ref, tol) -> float:
    """max |got - ref|; raises unless every element is finite and within
    atol + rtol * |ref|."""
    atol, rtol = tol
    got, ref = got.float(), ref.float()
    err = (got - ref).abs()
    finite = bool(torch.isfinite(got).all())
    bad = int((err > atol + rtol * ref.abs()).sum())
    max_err = err.max().item()
    if not finite or bad:
        raise AssertionError(
            f"{name}: {bad} elements outside atol {atol:g} + rtol {rtol:g} "
            f"(max_abs_err {max_err:.3e}), finite {finite}")
    return max_err


def training_inputs(seq: int, dtype, packed: bool, gen: torch.Generator,
                    depth: int = D, empty_row: bool = False):
    """attention_inputs plus the output gradient, and the (key_bias, seg)
    pair the training kernels take."""
    from bert_pytorch_tpu_torch.ops.kernels.attention import _infer_bias_seg

    q, k, v, kw = attention_inputs(seq, dtype, packed, gen, depth, empty_row)
    do = torch.randn(B, seq, H, depth, device="cuda",
                     generator=gen).to(dtype)
    key_bias, seg = _infer_bias_seg(kw.get("bias"), kw.get("sequence_ids"),
                                    B, seq)
    return q, k, v, do, kw, key_bias, seg


def sdpa_calls(q, k, v, do, kw, rate: float):
    """The one-PyTorch-call yardsticks (never on the port's path):
    scaled_dot_product_attention with the same additive mask and
    dropout_p, forward alone and forward + backward."""
    fwd = library_call(q, k, v, kw)
    mask = sdpa_mask(q, kw)
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_()
                  for t in (q, k, v))
    dot = do.transpose(1, 2)

    def fwd_drop():
        return torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, dropout_p=rate)

    def fwd_bwd():
        out = fwd_drop()
        torch.autograd.grad(out, (qt, kt, vt), dot)

    return (fwd if rate == 0.0 else lambda: fwd_drop().detach()), fwd_bwd


def _routes_of(name: str, dtype, depth: int = D) -> list:
    """The routes a check runs ``name`` on: the one ``train_route`` picks
    (first: the wrapper's), and in bf16 the CUDA-core route too, reached
    directly."""
    from bert_pytorch_tpu_torch.ops.kernels.attention import train_route

    route = train_route(dtype, depth, name)
    return [route] + (["cuda_cores"] if route == "tensor_cores" else [])


def _run_fwd(route, first, q, k, v, args):
    """The forward on ``route``: through the wrapper for its first route
    (the one it picks), else that route's launch."""
    from bert_pytorch_tpu_torch.ops.kernels import attention as ka

    if first:
        return ka.flash_attention_fwd(q, k, v, *args)
    return ka._launch_fwd(q, k, v, *args, route)


def _run_dq(route, first, q, k, v, out, do, lse, args):
    from bert_pytorch_tpu_torch.ops.kernels import attention as ka

    if first:
        return ka.flash_attention_dq(q, k, v, out, do, lse, *args)
    return ka._launch_dq(q, k, v, out, do, lse, *args, route)


def _run_dkv(route, first, q, k, v, do, lse, delta, args):
    from bert_pytorch_tpu_torch.ops.kernels import attention as ka

    if first:
        return ka.flash_attention_dkv(q, k, v, do, lse, delta, *args)
    return ka._launch_dkv(q, k, v, do, lse, delta, *args, route)


def check_training_case(label: str, q, k, v, do, key_bias, seg, rate: float,
                        tol: dict, worst: dict) -> None:
    """Forward, dq and dkv against their plain versions on one input, each
    on each of its routes (_routes_of); each launch must land on the route
    it was meant for. Raises on any element outside ``tol``; keeps the
    largest error per kernel in ``worst``."""
    from bert_pytorch_tpu_torch.ops.kernels import attention as ka

    args = (key_bias, seg, TRAIN_SEED, rate)
    depth = q.shape[3]
    ref_out, ref_lse = ka._forward_math(q, k, v, *args)
    ref_dq, ref_delta = ka._dq_math(q, k, v, ref_out, do, ref_lse, *args)
    ref_dk, ref_dv, ref_db = ka._dkv_math(q, k, v, do, ref_lse, ref_delta,
                                          *args)
    errs = {}
    for name, wrapper, run, refs in (
            ("flash_attention_fwd", ka.flash_attention_fwd,
             lambda route, first: _run_fwd(route, first, q, k, v, args),
             (("out", ref_out), ("lse", ref_lse))),
            ("flash_attention_dq", ka.flash_attention_dq,
             lambda route, first: _run_dq(route, first, q, k, v, ref_out, do,
                                          ref_lse, args),
             (("dq", ref_dq), ("delta", ref_delta))),
            ("flash_attention_dkv", ka.flash_attention_dkv,
             lambda route, first: _run_dkv(route, first, q, k, v, do,
                                           ref_lse, ref_delta, args),
             (("dk", ref_dk), ("dv", ref_dv), ("dbias", ref_db)))):
        for i, route in enumerate(_routes_of(name, q.dtype, depth)):
            before = wrapper.route_launches[route]
            got = run(route, i == 0)
            torch.cuda.synchronize()
            if wrapper.route_launches[route] != before + 1:
                raise AssertionError(f"{name} did not launch on its {route} "
                                     f"route ({label})")
            for (out_name, ref), value in zip(refs, got):
                err = _compare(f"{name} [{route}] {out_name} {label}", value,
                               ref, tol[out_name])
                errs[f"{out_name} [{route}]"] = err
                worst[name] = max(worst[name], err)
    log(f"[check] training kernels {label}: " + ", ".join(
        f"{key} {val:.2e}" for key, val in errs.items()))


def check_training_kernels(dtypes=(torch.bfloat16, torch.float32)) -> dict:
    """Hold the forward, dq and dkv kernels against their plain versions on
    the same inputs: S in SEQS, ``dtypes``, padded and packed, dropout 0
    and 0.1 with a fixed seed; in bf16 and fp16 each on both routes.
    Returns the max error per kernel."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    worst = {name: 0.0 for name in TRAIN_REPLACES}
    for seq in SEQS:
        for dtype in dtypes:
            for packed in (False, True):
                q, k, v, do, _, kb, seg = training_inputs(seq, dtype, packed,
                                                          gen)
                for rate in TRAIN_RATES:
                    check_training_case(
                        f"S={seq} {str(dtype)[6:]} "
                        f"{'packed' if packed else 'padded'} rate {rate}",
                        q, k, v, do, kb, seg, rate, TRAIN_TOL[dtype], worst)
    return worst


# The tensor-core route's edges for the training kernels, bf16: S=200 is
# ragged (three full tiles and 8 rows), each head dim the route takes for
# any of them (dkv keeps head_dim 128 on the CUDA cores), padded with row
# 0's every key masked and packed with row 0 all pad, at each rate.
TRAIN_EDGE_SEQ, TRAIN_EDGE_DEPTHS = 200, (32, 64, 128)


def check_training_edges(worst: dict, dtype=torch.bfloat16) -> None:
    gen = torch.Generator(device="cuda").manual_seed(5)
    for depth in TRAIN_EDGE_DEPTHS:
        for packed in (False, True):
            q, k, v, do, _, kb, seg = training_inputs(
                TRAIN_EDGE_SEQ, dtype, packed, gen, depth, empty_row=True)
            for rate in TRAIN_RATES:
                rows = ("packed (row 0 all pad)" if packed
                        else "padded (row 0 every key masked)")
                check_training_case(
                    f"S={TRAIN_EDGE_SEQ} D={depth} {str(dtype)[6:]} {rows} "
                    f"rate {rate}", q, k, v, do, kb, seg, rate,
                    TRAIN_TOL[dtype], worst)


def check_keep_masks(dtype=torch.bfloat16) -> dict:
    """The keep mask each route of the forward, dq and dkv drew on
    ``dtype`` tensors, read from their outputs
    (bert_pytorch_tpu_torch/testing/dropout_masks.py), held bit for bit
    against the plain Philox twin: at the main path's shape (B=8, H=16,
    S=512) and at a ragged S=200, rates 0 and 0.1. Returns the kept share
    per (S, rate)."""
    from bert_pytorch_tpu_torch.testing import dropout_masks as dm

    shares = {}
    for batch, seq, heads in ((B, TRAIN_SEQ, H), (2, TRAIN_EDGE_SEQ, 3)):
        for rate in TRAIN_RATES:
            want = dm.philox_mask(batch, seq, heads, TRAIN_SEED, rate, "cuda")
            for route in ("tensor_cores", "cuda_cores"):
                for read in (dm.forward_keep_mask, dm.dq_keep_mask,
                             dm.dkv_keep_mask):
                    got = read(batch, seq, heads, TRAIN_SEED, rate, dtype,
                               device="cuda", route=route)
                    torch.cuda.synchronize()
                    if not torch.equal(got, want):
                        raise AssertionError(
                            f"{read.__name__} [{route}] S={seq} rate {rate}:"
                            f" {int((got != want).sum())} of {got.numel()} "
                            "mask bits differ from philox_keep_mask")
            shares[f"S={seq} rate {rate}"] = want.float().mean().item()
            log(f"[check] keep mask {str(dtype)[6:]} S={seq} rate {rate}: "
                f"forward, dq and dkv, both routes, equal philox_keep_mask "
                f"bit for bit (kept "
                f"share {shares[f'S={seq} rate {rate}']:.5f})")
    return shares


def time_training_kernels(rate: float = 0.1,
                          dtypes=(torch.bfloat16, torch.float32)) -> dict:
    """Times of each training kernel at the main path's shapes (padded
    rows, dropout ``rate``): device time per call (``torch.profiler``) of
    the kernel on each of its routes (_routes_of) and of SDPA forward and
    forward + backward (the backward alone is their difference), with
    CUDA-event times of 100 calls back to back beside them (the host's
    issue time included); the plain version by CUDA events. At S=512 bf16
    each is also read at rate 0 on its first route: the keep mask's cost
    is the difference."""
    from bert_pytorch_tpu_torch.ops.kernels import attention as ka

    gen = torch.Generator(device="cuda").manual_seed(2)
    cases = {name: [] for name in TRAIN_REPLACES}
    for seq in SEQS:
        for dtype in dtypes:
            q, k, v, do, kw, kb, seg = training_inputs(seq, dtype, False, gen)
            args = (kb, seg, TRAIN_SEED, rate)
            out, lse = ka._forward_math(q, k, v, *args)
            _, delta = ka._dq_math(q, k, v, out, do, lse, *args)
            runs = {
                "flash_attention_fwd": (
                    lambda route, first, a=args: _run_fwd(route, first, q, k,
                                                          v, a),
                    lambda: ka._forward_math(q, k, v, *args)),
                "flash_attention_dq": (
                    lambda route, first, a=args: _run_dq(
                        route, first, q, k, v, out, do, lse, a),
                    lambda: ka._dq_math(q, k, v, out, do, lse, *args)),
                "flash_attention_dkv": (
                    lambda route, first, a=args: _run_dkv(
                        route, first, q, k, v, do, lse, delta, a),
                    lambda: ka._dkv_math(q, k, v, do, lse, delta, *args)),
            }
            sdpa_fwd, sdpa_fwd_bwd = sdpa_calls(q, k, v, do, kw, rate)
            sdpa = {"fwd": device_time_ms(sdpa_fwd),
                    "fwd_bwd": device_time_ms(sdpa_fwd_bwd),
                    "fwd_event": cuda_time_ms(sdpa_fwd),
                    "fwd_bwd_event": cuda_time_ms(sdpa_fwd_bwd)}
            sdpa["bwd"] = sdpa["fwd_bwd"] - sdpa["fwd"]
            label = f"S={seq} {str(dtype)[6:]} rate {rate}"
            for name, (run, plain) in runs.items():
                routes = _routes_of(name, dtype)
                head = routes[0]
                times = {route: device_time_ms(
                    lambda r=route, first=(i == 0): run(r, first))
                    for i, route in enumerate(routes)}
                t_bound, by = train_bound_ms(name, seq, dtype)
                fwd = name == "flash_attention_fwd"
                case = {"seq": seq, "dtype": str(dtype)[6:], "rate": rate,
                        "kernel_route": head, "ms": times[head],
                        "event_ms": cuda_time_ms(lambda: run(head, True)),
                        "plain_ms": cuda_time_ms(plain, iters=20, warmup=2),
                        "sdpa_fwd_ms": sdpa["fwd"],
                        "sdpa_fwd_bwd_ms": sdpa["fwd_bwd"],
                        "sdpa_bwd_ms": sdpa["bwd"],
                        "library_ms": sdpa["fwd" if fwd else "fwd_bwd"],
                        "library_event_ms": sdpa[
                            "fwd_event" if fwd else "fwd_bwd_event"],
                        "bound_ms": t_bound, "bound_by": by}
                extra = ""
                if head != "cuda_cores" and "cuda_cores" in times:
                    case["cuda_core_ms"] = times["cuda_cores"]
                    extra += f", CUDA-core route {times['cuda_cores']:.4f} ms"
                if seq == TRAIN_SEQ and dtype == torch.bfloat16:
                    case["rate0_ms"] = device_time_ms(
                        lambda: run(head, True, (kb, seg, TRAIN_SEED, 0.0)))
                    extra += f", at rate 0 {case['rate0_ms']:.4f} ms"
                log(f"[time] {name} {label} [{head}]: device time per call "
                    f"kernel {case['ms']:.4f} ms{extra}, SDPA fwd "
                    f"{sdpa['fwd']:.4f} ms, SDPA fwd+bwd "
                    f"{sdpa['fwd_bwd']:.4f} ms (bwd alone {sdpa['bwd']:.4f}"
                    f" ms), bound {t_bound:.4f} ms ({by}); CUDA events "
                    f"kernel {case['event_ms']:.4f} ms, plain "
                    f"{case['plain_ms']:.4f} ms, SDPA fwd "
                    f"{sdpa['fwd_event']:.4f} ms, fwd+bwd "
                    f"{sdpa['fwd_bwd_event']:.4f} ms")
                cases[name].append(case)
    return cases


# The fast-path flags of the int8 serving main path.
INT8_FLAGS = ("--quantize", "int8", "--fuse_epilogues")


def zero_counts(kernels: dict) -> None:
    """Every launch count (and per-route count) to 0."""
    from bert_pytorch_tpu_torch.ops.kernels.attention import reset_counts

    for kernel in kernels.values():
        reset_counts(kernel)


def serve_args(vocab: str, dtype: str, backend: str, tasks: str,
               extra=(), config: str = CONFIG):
    from bert_pytorch_tpu_torch import run_server

    return run_server.parse_arguments([
        "--model_config_file", config, "--vocab_file", vocab,
        "--device", "cuda", "--dtype", dtype,
        "--attention_backend", backend, "--tasks", tasks,
        "--buckets", "128,512", "--max_batch_size", "8",
        "--pack_requests", "--max_wait_ms", "20", "--port", "0",
        "--trace_sample_rate", "0", *extra])


def request_waves() -> list:
    """Two waves of concurrent requests for the four heads: short ones
    (packed several to a row in the 128 bucket), then long ones (the 512
    bucket; squad's context truncated to it)."""
    from bert_pytorch_tpu_torch.tools.make_synthetic_data import TRACE_WORDS

    rng = np.random.default_rng(7)

    def wave(lo, hi, n):
        out = []
        for _ in range(n):
            words = [str(w) for w in rng.choice(TRACE_WORDS, int(
                rng.integers(lo, hi)))]
            cut = len(words) // 2
            out.append(("fill_mask", {"text": " ".join(
                words[:cut] + ["[MASK]"] + words[cut:]), "top_k": 5}))
            out.append(("classify", {"text": " ".join(words)}))
            out.append(("squad", {"question": " ".join(words[:4]),
                                  "context": " ".join(words)}))
            out.append(("ner", {"text": " ".join(words)}))
        return out

    return [wave(4, 24, 8), wave(200, 420, 4)]


def post(port: int, task: str, payload: dict, path: str = "") -> tuple:
    """POST ``payload`` to /v1/<task> (or to ``path``): (status, body,
    seconds)."""
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path or '/v1/' + task}",
        data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(req, timeout=180) as resp:
            body = json.loads(resp.read())
            return resp.status, body, time.perf_counter() - t0
    except urllib.error.HTTPError as exc:
        return exc.code, exc.read().decode(), time.perf_counter() - t0


def get(port: int, path: str) -> dict:
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=60) as resp:
        return json.loads(resp.read())


def check_body(task: str, payload: dict, body, labels) -> None:
    if task == "fill_mask":
        masks = body["masks"]
        if (len(masks) != payload["text"].count("[MASK]")
                or any(len(m) != 5 for m in masks)):
            raise AssertionError(f"fill_mask body malformed: {body}")
        for slot in (slot for m in masks for slot in m):
            if not (isinstance(slot["token"], str)
                    and 0.0 <= slot["score"] <= 1.0
                    and math.isfinite(slot["score"])):
                raise AssertionError(f"fill_mask slot malformed: {slot}")
    elif task == "squad":
        nbest = body["n_best"]
        if not (isinstance(body["answer"], str) and nbest and all(
                math.isfinite(e["start_logit"])
                and math.isfinite(e["end_logit"])
                and 0.0 <= e["probability"] <= 1.0 for e in nbest)):
            raise AssertionError(f"squad body malformed: {body}")
    elif task == "ner":
        ents, words = body["entities"], payload["text"].split()
        if not (ents and [e["word"] for e in ents] == words[:len(ents)]
                and all(e["tag"] in NER_TAGS and 0.0 <= e["score"] <= 1.0
                        for e in ents)):
            raise AssertionError(f"ner body malformed: {body}")
    else:
        if body["label"] not in labels or abs(
                sum(body["scores"].values()) - 1.0) > 1e-4:
            raise AssertionError(f"classify body malformed: {body}")


def serve_waves(args, waves: list, kernels: dict,
                keep_bodies: bool = False) -> tuple:
    """Build the service for ``args``, warm it, then serve ``waves`` over
    HTTP (each wave's requests concurrently) and one request per head
    through ``run_direct`` (one request alone in an unpacked row). Every
    count is set to 0 just before the traffic and read just after. Checks
    that every request answered 200 with a well-formed body. Returns (the
    run's numbers, with the answers in request order under ``bodies``
    when ``keep_bodies``; the engine)."""
    from bert_pytorch_tpu_torch import run_server
    from bert_pytorch_tpu_torch.serve import make_server

    service = run_server.build_service(args)
    engine = service.engine
    t0 = time.perf_counter()
    engine.warmup()
    log(f"[serve] warmup {engine.startup} in "
        f"{time.perf_counter() - t0:.2f}s")
    plans = []
    execute_staged = engine.execute_staged

    def recording(staged):
        plans.append((staged.task, staged.plan.bucket, staged.plan.packed,
                      max(len(row) for row in staged.plan.rows),
                      staged.fused))
        return execute_staged(staged)

    engine.execute_staged = recording
    labels = args.classify_labels.split(",")
    # Counts to zero just before the main path, read just after.
    zero_counts(kernels)
    engine.forwards = 0
    service.start()
    server = make_server(service, port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        port = server.server_address[1]
        payloads, results = [], []
        for wave in waves:
            with ThreadPoolExecutor(max_workers=len(wave)) as pool:
                results += list(pool.map(lambda tp: post(port, *tp), wave))
            payloads += wave
        # The unpacked forward (key-bias path of the kernel): the offline
        # scoring entry point runs one request alone in a row.
        # The first request of each served task in the first wave.
        singles = []
        for tp in waves[0]:
            if tp[0] in engine.tasks and all(t != tp[0] for t, _ in singles):
                singles.append(tp)
        direct = {task: engine.run_direct(task, payload)
                  for task, payload in singles}
    finally:
        server.shutdown()
        server.server_close()
        service.stop()
        thread.join(timeout=30)
    launches = {name: k.launches for name, k in kernels.items()}
    routes = {name: dict(k.route_launches) for name, k in kernels.items()
              if hasattr(k, "route_launches")}
    forwards = engine.forwards
    for (task, payload), (status, body, _) in zip(payloads, results):
        if status != 200:
            raise AssertionError(f"{task} answered {status}: {body}")
        check_body(task, payload, body, labels)
    for task, payload in singles:
        check_body(task, payload, direct[task], labels)
    latencies = sorted(r[2] for r in results)
    log(f"[serve] {len(results)} requests answered 200 over {forwards} "
        f"forwards; plans (task, bucket, packed, max requests/row, fused): "
        f"{plans}")
    del engine.execute_staged
    bodies = {"bodies": [r[1] for r in results]} if keep_bodies else {}
    return {**bodies, "requests": len(results), "forwards": forwards,
            "launches": launches, "routes": routes, "plans": plans,
            "layers": engine.config.num_hidden_layers,
            "p50_ms": statistics.median(latencies) * 1e3,
            "max_ms": latencies[-1] * 1e3,
            "cold_start_s": engine.startup["cold_start_s"],
            "load_s_by_task": engine.startup["load_s_by_task"],
            "weight_bytes": engine.startup["weight_bytes"],
            "weight_bytes_by_task": engine.startup["weight_bytes_by_task"]
            }, engine


def check_coverage(plans: list) -> None:
    """Both buckets, and packed rows beside unpacked ones, were served."""
    buckets = sorted({p[1] for p in plans})
    packed_rows = max(p[3] for p in plans if p[2])
    if buckets != [128, 512] or packed_rows < 2 or all(p[2] for p in plans):
        raise AssertionError(f"traffic did not cover both buckets, packed "
                             f"and unpacked rows: {plans}")


def check_launches(served: dict, kernel: str, idle: Sequence[str]) -> None:
    """``kernel`` launched once per encoder layer per forward of the run,
    every launch on its tensor-core route, and each of ``idle`` never."""
    launches, forwards = served["launches"], served["forwards"]
    if launches[kernel] == 0 or launches[kernel] != served["layers"] * forwards:
        raise AssertionError(
            f"{kernel} launched {launches} times over {forwards} forwards; "
            f"expected {served['layers']} per forward")
    routes = served["routes"][kernel]
    if routes["tensor_cores"] != launches[kernel]:
        raise AssertionError(f"{kernel} launches by route {routes}: every "
                             f"serving launch must take the tensor cores")
    log(f"[serve] {kernel}: {launches[kernel]} launches over {forwards} "
        f"forwards ({served['layers']} per forward), by route {routes}")
    for name in idle:
        if launches[name] != 0:
            raise AssertionError(f"{name} launched {launches[name]} times "
                                 f"on the path of {kernel}")


def write_checkpoints(vocab: str, root: str) -> tuple:
    """Phase 5, first: the four heads' seeded BERT-large weights as an
    in-memory server holds them, each written with the port's
    ``save_checkpoint`` (about 1.3 GB of fp32 a head), and classify's from
    SWAP_SEED for the hot-swap. Checks the free disk first and fails
    loudly when it is short. Returns (the in-memory engine, checkpoint
    paths, seconds per write)."""
    from bert_pytorch_tpu_torch import run_server
    from bert_pytorch_tpu_torch.models import bert
    from bert_pytorch_tpu_torch.models.convert import to_jax_params
    from bert_pytorch_tpu_torch.ops.quant import weight_bytes
    from bert_pytorch_tpu_torch.utils.checkpoint import save_checkpoint

    memory = run_server.build_service(serve_args(
        vocab, "bfloat16", "flash_infer", ",".join(HEADS))).engine
    cfg = memory.config
    swap_model = bert.init_weights(
        bert.BertForSequenceClassification(cfg, num_labels=2,
                                           device=memory.device),
        cfg.initializer_range,
        torch.Generator(device=memory.device).manual_seed(SWAP_SEED))
    models = {task: spec.model for task, spec in memory.tasks.items()}
    models["classify_v2"] = swap_model
    need = sum(weight_bytes(m) for m in models.values())
    free = shutil.disk_usage(root).free
    log(f"[ckpt] writing {need / 2**30:.2f} GiB of checkpoints under {root}: "
        f"{free / 2**30:.2f} GiB free")
    if free < need * 1.05 + 2**30:
        raise AssertionError(f"not enough disk for the checkpoints: "
                             f"{free} bytes free, {need} needed")
    paths, write_s = {}, {}
    for name, model in models.items():
        head = name.split("_v2")[0]
        t0 = time.perf_counter()
        params = to_jax_params(model.state_dict(), cfg, head)
        paths[name] = save_checkpoint(os.path.join(root, name), 0,
                                      {"model": params, "epoch": 0})
        write_s[name] = time.perf_counter() - t0
        del params
        log(f"[ckpt] {name}: {os.path.getsize(paths[name])} bytes written "
            f"in {write_s[name]:.2f} s")
    return memory, paths, write_s


def checkpoint_flags(paths: dict, tasks) -> list:
    """``--<task>_checkpoint <dir>`` for each task (the directory: the
    server takes its newest checkpoint)."""
    return [arg for task in tasks for arg in (
        f"--{task}_checkpoint", os.path.dirname(paths[task]))]


def compare_engines(engine, memory) -> int:
    """The checkpoint-loaded engine against the in-memory one: every
    head's weights bit for bit, and every wave request's answer through
    ``run_direct`` equal (the same fp32 weights reach the same kernels, so
    any difference is a load fault). Returns the answers compared."""
    for task, spec in engine.tasks.items():
        got = spec.model.state_dict()
        want = memory.tasks[task].model.state_dict()
        if set(got) != set(want) or not all(
                torch.equal(got[k], want[k]) for k in want):
            raise AssertionError(f"{task}: the checkpoint-loaded weights "
                                 "differ from the in-memory ones")
    compared = 0
    for wave in request_waves():
        for task, payload in wave:
            ours = engine.run_direct(task, payload)
            if ours != memory.run_direct(task, payload):
                raise AssertionError(f"{task} answer from the checkpoint "
                                     f"differs from memory: {payload}")
            compared += 1
    return compared


def drive_main_path(vocab: str, kernels: dict, memory, paths: dict) -> tuple:
    """Phase 5a: serve the four heads from their checkpoints over HTTP at
    BERT-large width, then hold the loaded engine to the in-memory one."""
    args = serve_args(vocab, "bfloat16", "flash_infer", ",".join(HEADS),
                      checkpoint_flags(paths, HEADS))
    served, engine = serve_waves(args, request_waves(), kernels)
    check_coverage(served["plans"])
    check_launches(served, "flash_attention_infer", ("layer_norm_fwd",))
    t0 = time.perf_counter()
    served["answers_equal_memory"] = compare_engines(engine, memory)
    log(f"[check] checkpoint-loaded heads: weights bit-equal to memory, "
        f"{served['answers_equal_memory']} run_direct answers equal in "
        f"{time.perf_counter() - t0:.2f} s; load s by head "
        f"{served['load_s_by_task']}")
    return served, engine


def check_hot_swap(vocab: str, kernels: dict, paths: dict) -> dict:
    """Hot-swap on the card: a classify + squad server from the
    checkpoints keeps eight clients sending classify and squad requests
    while ``POST /swapz`` swaps classify to the SWAP_SEED checkpoint as
    v2. Every request answers 200 and well formed, /healthz and /statsz
    report v2, one swap and no torn serve, the answers after the swap equal
    a fresh engine's built from that checkpoint, and the kernel launches
    once per layer per forward on the tensor cores."""
    from bert_pytorch_tpu_torch import run_server
    from bert_pytorch_tpu_torch.serve import make_server

    tasks = ("classify", "squad")
    service = run_server.build_service(serve_args(
        vocab, "bfloat16", "flash_infer", ",".join(tasks),
        checkpoint_flags(paths, tasks)))
    engine = service.engine
    engine.warmup()
    payloads = [tp for wave in request_waves() for tp in wave
                if tp[0] in tasks]
    results, stop = [], threading.Event()

    def client(mine):
        while not stop.is_set():
            for task, payload in mine:
                results.append((task, payload, post(port, task, payload)))

    zero_counts(kernels)
    engine.forwards = 0
    service.start()
    server = make_server(service, port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        port = server.server_address[1]
        with ThreadPoolExecutor(max_workers=8) as pool:
            clients = [pool.submit(client, payloads[i::8]) for i in range(8)]
            time.sleep(1.0)
            before = len(results)
            status, info, swap_s = post(port, "", {
                "task": "classify", "checkpoint": paths["classify_v2"],
                "version": "v2"}, path="/swapz")
            during = len(results) - before
            time.sleep(1.0)
            stop.set()
            for future in clients:
                future.result()
        health, stats = get(port, "/healthz"), get(port, "/statsz")
    finally:
        stop.set()
        server.shutdown()
        server.server_close()
        service.stop()
        thread.join(timeout=30)
    check_launches({
        "launches": {name: k.launches for name, k in kernels.items()},
        "routes": {"flash_attention_infer": dict(
            kernels["flash_attention_infer"].route_launches)},
        "forwards": engine.forwards,
        "layers": engine.config.num_hidden_layers},
        "flash_attention_infer", ("layer_norm_fwd",))
    if status != 200 or info.get("version") != "v2" or info.get(
            "compiles") != 0:
        raise AssertionError(f"/swapz answered {status}: {info}")
    for task, payload, (code, body, _) in results:
        if code != 200:
            raise AssertionError(f"{task} answered {code} during the swap: "
                                 f"{body}")
        check_body(task, payload, body, ["0", "1"])
    if (health.get("version") != "v2" or stats.get("version") != "v2"
            or stats.get("swaps") != 1 or stats.get("torn_serves") != 0):
        raise AssertionError(f"after the swap /healthz {health}, /statsz "
                             f"swaps {stats.get('swaps')} torn "
                             f"{stats.get('torn_serves')}")
    fresh = run_server.build_service(serve_args(
        vocab, "bfloat16", "flash_infer", "classify",
        ["--classify_checkpoint", os.path.dirname(paths["classify_v2"])])
    ).engine
    classify = [p for t, p in payloads if t == "classify"]
    for payload in classify:
        if engine.run_direct("classify", payload) != fresh.run_direct(
                "classify", payload):
            raise AssertionError(f"after the swap, classify differs from a "
                                 f"fresh v2 engine: {payload}")
    log(f"[swap] /swapz classify -> v2 answered 200 in {swap_s:.2f} s "
        f"(load_s {info['load_s']}, compiles {info['compiles']}); "
        f"{len(results)} requests answered 200, {during} of them while the "
        f"swap ran; /statsz swaps {stats['swaps']}, torn_serves "
        f"{stats['torn_serves']}; {len(classify)} answers equal a fresh v2 "
        f"engine")
    return {"load_s": info["load_s"], "swap_s": swap_s,
            "requests": len(results), "during_swap": during,
            "fresh_load_s": fresh.load_s["classify"]}


def overflow_request() -> tuple:
    """One fill_mask request with more [MASK]s than the gather slots."""
    words = ("paris", "is", "the", "capital", "of", "france", "and", "a",
             "city", "river")[:OVERFLOW_MASKS]
    return ("fill_mask", {"text": " ".join(f"[MASK] {w}" for w in words),
                          "top_k": 5})


def drive_int8_main_path(vocab: str, kernels: dict, memory,
                         paths: dict) -> dict:
    """Phase 5c: the int8 fast path over HTTP at BERT-large width from the
    same checkpoints (int8 weights quantized as they stream in, int8 GEMMs,
    the int8-score kernel, the fused fill_mask gather and squad's stacked
    span), with one batch past the gather slots. The streamed int8 weights
    must equal bit for bit ``quantize_state_dict`` of the in-memory
    weights."""
    from bert_pytorch_tpu_torch.models.convert import quantize_state_dict

    args = serve_args(vocab, "bfloat16", "flash_infer_int8", ",".join(HEADS),
                      INT8_FLAGS + tuple(checkpoint_flags(paths, HEADS)))
    served, engine = serve_waves(args, request_waves() + [[overflow_request()]],
                                 kernels)
    plans = served["plans"]
    check_coverage(plans)
    fused = {task: {p[4] for p in plans if p[0] == task} for task in HEADS}
    if fused != {"fill_mask": {False, True}, "classify": {False},
                 "squad": {True}, "ner": {False}}:
        raise AssertionError(f"fused epilogues by head {fused}: fill_mask "
                             f"takes both forwards, squad only the stacked "
                             f"span, classify and ner none; plans {plans}")
    check_launches(served, "flash_attention_infer_int8",
                   ("flash_attention_infer", "layer_norm_fwd"))
    for task, spec in engine.tasks.items():
        got = spec.model.state_dict()
        want = quantize_state_dict(memory.tasks[task].model.state_dict(),
                                   "int8")
        if set(got) != set(want) or not all(
                got[k].dtype == want[k].dtype
                and torch.equal(got[k], want[k].to(got[k].device))
                for k in want):
            raise AssertionError(f"{task}: streamed int8 weights differ "
                                 "from quantize_state_dict of memory's")
    log(f"[check] streamed int8 weights of {sorted(engine.tasks)} equal "
        f"quantize_state_dict of the in-memory weights bit for bit; load s "
        f"by head {served['load_s_by_task']}")
    return served


def fill_mask_batch(engine, payloads: list) -> tuple:
    """One staged fill_mask batch of ``payloads``, unpacked then packed:
    (per-request outputs, per-request [MASK] rows, whether each plan took
    the fused gather), in plan order (the same for every engine: planning
    depends only on the request lengths)."""
    from bert_pytorch_tpu_torch.serve.batcher import Request
    from bert_pytorch_tpu_torch.serve.tasks import GatheredTokens

    handler = engine.tasks["fill_mask"].handler
    reqs = [Request("fill_mask", handler.prepare(p, engine.max_len()), p)
            for p in payloads]
    outs, rows, fused = [], [], []
    for packed in (False, True):
        plan = engine.plan_batch(reqs, packed=packed)
        results, info = engine.execute("fill_mask", plan)
        fused.append(info["fused"])
        for req, out in zip(plan.requests, results):
            outs.append(out)
            rows.append(out.logits if isinstance(out, GatheredTokens)
                        else out[req.features["mask_positions"]])
    return outs, rows, fused


def _max_err(a: list, b: list) -> float:
    return max(float(np.abs(x - y).max()) for x, y in zip(a, b))


def fill_mask_payloads() -> list:
    return [p for wave in request_waves() for t, p in wave
            if t == "fill_mask"][:8]


def check_flash_vs_dense(vocab: str) -> tuple:
    """Phase 5b: the same seeded fp32 weights through a flash_infer engine
    and a dense engine; one staged fill_mask batch, packed and unpacked.
    Returns the error and the flash engine's [MASK] rows."""
    from bert_pytorch_tpu_torch import run_server

    outs, rows = {}, {}
    for backend in ("flash_infer", "dense"):
        engine = run_server.build_service(
            serve_args(vocab, "float32", backend, "fill_mask")).engine
        outs[backend], rows[backend], _ = fill_mask_batch(
            engine, fill_mask_payloads())
        del engine
        torch.cuda.empty_cache()
    err = _max_err(outs["flash_infer"], outs["dense"])
    finite = all(np.isfinite(a).all() for a in outs["flash_infer"])
    log(f"[check] fp32 fill_mask logits, flash_infer vs dense engine: "
        f"max_abs_err {err:.3e} (atol {ENGINE_ATOL:g}), finite {finite}")
    if not finite or not err <= ENGINE_ATOL:
        raise AssertionError(f"flash_infer and dense engines disagree: {err}")
    return err, rows["flash_infer"]


def cut_config(tmp: str, **overrides) -> str:
    """BERT-large's config file with ``overrides`` (a cut depth), written
    under ``tmp``; returns its path."""
    with open(CONFIG, encoding="utf-8") as f:
        cfg = dict(json.load(f), **overrides)
    path = os.path.join(tmp, "bert_large_cut.json")
    with open(path, "w", encoding="utf-8") as f:
        json.dump(cfg, f)
    return path


def _rows_of(vocab: str, backend: str, extra=(), unfused: bool = False,
             config: str = CONFIG):
    """[MASK] rows and fused flags of one fp32-compute fill_mask engine
    from the seeded weights; with ``unfused`` also the same engine's rows
    staged without the gather (outputs, rows, flags)."""
    from bert_pytorch_tpu_torch import run_server

    engine = run_server.build_service(serve_args(
        vocab, "float32", backend, "fill_mask", extra, config)).engine
    runs = [fill_mask_batch(engine, fill_mask_payloads())]
    if unfused:
        engine.fuse_epilogues = False
        runs.append(fill_mask_batch(engine, fill_mask_payloads()))
    del engine
    torch.cuda.empty_cache()
    return runs


def check_int8_engines(vocab: str, fp32_rows: list) -> dict:
    """Phase 5c, second half: one staged fill_mask batch (packed and
    unpacked) through fp32-compute engines from the same seeded weights,
    compared at the [MASK] rows with ``fp32_rows`` (fp32 weights,
    flash_infer):

    * fp32 weights, flash_infer_int8: the score quantization alone,
      within INT8_ATTN_ATOL;
    * int8 weights, flash_infer_int8, fused gather: equal to its own
      unfused batch within FUSED_ATOL;
    * int8 weights, dense attention, at INT8_CHECK_LAYERS layers of
      BERT-large width: the int8-score engine within INT8_LOGIT_ATOL, the
      JAX package's bound, which it set on a 2-layer config;
    * the same pair at full depth: the int8-score engine may differ from
      the dense one by no more than the dense one differs from the fp32
      engine (the int8 weights' own distance). Over 24 layers the
      per-token activation quantization turns the score rounding into
      whole-step flips of downstream activations, so the 2-layer bound is
      not held there; every distance is logged."""
    (_, attn_rows, _), = _rows_of(vocab, "flash_infer_int8")
    (_, int8_rows, fused), (unfused_outs, unfused_rows, unfused) = _rows_of(
        vocab, "flash_infer_int8", INT8_FLAGS, unfused=True)
    (_, dense_rows, _), = _rows_of(vocab, "dense", ("--quantize", "int8"))
    with tempfile.TemporaryDirectory() as tmp:
        cut = cut_config(tmp, num_hidden_layers=INT8_CHECK_LAYERS)
        (_, cut_int8_rows, _), = _rows_of(vocab, "flash_infer_int8",
                                          INT8_FLAGS, config=cut)
        (_, cut_dense_rows, _), = _rows_of(vocab, "dense",
                                           ("--quantize", "int8"), config=cut)
    errs = {"int8_scores_vs_fp32": _max_err(attn_rows, fp32_rows),
            "fused_vs_unfused": _max_err(int8_rows, unfused_rows),
            "int8_vs_dense_int8_cut": _max_err(cut_int8_rows, cut_dense_rows),
            "int8_vs_dense_int8": _max_err(int8_rows, dense_rows),
            "dense_int8_vs_fp32": _max_err(dense_rows, fp32_rows),
            "int8_vs_fp32": _max_err(int8_rows, fp32_rows)}
    finite = all(np.isfinite(a).all() for a in
                 attn_rows + int8_rows + unfused_outs + cut_int8_rows)
    log(f"[check] fp32-compute fill_mask [MASK] logits: int8 scores on fp32 "
        f"weights vs fp32 {errs['int8_scores_vs_fp32']:.3e} (atol "
        f"{INT8_ATTN_ATOL:g}); int8 weights: fused vs unfused "
        f"{errs['fused_vs_unfused']:.3e} (atol {FUSED_ATOL:g}), "
        f"flash_infer_int8 vs dense at {INT8_CHECK_LAYERS} layers "
        f"{errs['int8_vs_dense_int8_cut']:.3e} (atol {INT8_LOGIT_ATOL:g}), "
        f"at 24 layers {errs['int8_vs_dense_int8']:.3e} (bound: dense int8 "
        f"vs fp32 {errs['dense_int8_vs_fp32']:.3e}), flash_infer_int8 vs "
        f"fp32 {errs['int8_vs_fp32']:.3e}; fused plans {fused}, unfused "
        f"plans {unfused}; finite {finite}")
    if not (finite and all(fused) and not any(unfused)
            and errs["int8_scores_vs_fp32"] <= INT8_ATTN_ATOL
            and errs["fused_vs_unfused"] <= FUSED_ATOL
            and errs["int8_vs_dense_int8_cut"] <= INT8_LOGIT_ATOL
            and errs["int8_vs_dense_int8"] <= errs["dense_int8_vs_fp32"]):
        raise AssertionError(f"int8 engine checks failed: {errs}")
    return errs


PHASE2 = os.path.join(REPO, "configs", "bert_pretraining_phase2_config.json")
TRAIN_LOCAL_BATCH, TRAIN_ACCUM, TRAIN_STEPS = 8, 2, 4
TRAIN_SEQ = 512
# The first loss of a seeded random init: ln(vocab) MLM + ln(2) NSP.
INIT_LOSS = math.log(30528) + math.log(2)
# fp32 flash vs dense training step at BERT-large width, 2 layers, dropout
# 0: the loss within 1e-4; each gradient within 1e-3 of that tensor's
# largest gradient, floored at 1e-4 of the model's largest (attention
# summed in another order, q scaled before the product on the dense path;
# the floor covers tensors whose true gradient is 0, such as the key
# projection's bias, to which the softmax is invariant); each parameter after one LAMB step
# within 2e-4, twice the largest single-element LAMB update at the step's
# lr (4e-3 x a trust ratio near 0.02), since m_hat / sqrt(v_hat) is
# sign(g) on the first step and flips where a gradient is near 0.
TRAIN_LOSS_ATOL, TRAIN_GRAD_RTOL, TRAIN_PARAM_ATOL = 1e-4, 1e-3, 2e-4


def training_args(extra=()):
    """The runner's arguments for the phase-2 recipe at BERT-large width:
    the recipe's config file (seq 512 rows, max_pred 80, remat dots, LAMB
    with poly warmup), a local batch of 8 accumulated twice, bf16, the
    flash kernels, a few steps and no checkpoint."""
    import atexit

    from bert_pytorch_tpu_torch import run_pretraining

    out = tempfile.mkdtemp(prefix="chip_smoke_train_")  # nothing is saved
    atexit.register(shutil.rmtree, out, True)
    return run_pretraining.parse_arguments([
        "--output_dir", out,
        "--config_file", PHASE2, "--model_config_file", CONFIG,
        "--local_batch_size", str(TRAIN_LOCAL_BATCH),
        "--global_batch_size", str(TRAIN_LOCAL_BATCH * TRAIN_ACCUM),
        "--steps", str(TRAIN_STEPS), "--skip_final_checkpoint",
        "--attention_backend", "flash", "--dtype", "bfloat16",
        "--device", "cuda", "--seed", "0", *extra])


def training_batches(args, config, count: int, seed0: int = 0) -> list:
    """Seeded synthetic global batches of S=512 rows masked by the port's
    dataset code, stacked into [A, B, S] on the card."""
    from bert_pytorch_tpu_torch import pretrain
    from bert_pytorch_tpu_torch.tools.make_synthetic_data import (
        synthetic_pretraining_batch)

    return [pretrain.to_device(pretrain.stack_microbatches(
        synthetic_pretraining_batch(
            seed0 + i, args.global_batch_size, TRAIN_SEQ, config.vocab_size,
            args.max_predictions_per_seq, args.masked_token_fraction),
        args.accumulation_steps), args.device) for i in range(count)]


# fp16 against bf16 on the same seed: the first loss within 5% (the same
# random init; only the activations' rounding differs).
FP16_LOSS_RTOL = 0.05
# The fp16 runner's default initial loss scale (the JAX runner's, 2**16).
FP16_INIT_SCALE = 2.0 ** 16


def drive_training(kernels: dict, dtype: str = "bfloat16",
                   ref_first_loss=None, capture_turns: bool = False) -> dict:
    """The training main path: the port runner's setup functions and train
    step, TRAIN_STEPS optimizer steps of BERT-large phase 2 in ``dtype``.
    In float16 (phase 12b) every step record must carry the default loss
    scale (no step overflowed) and the first loss lie within
    FP16_LOSS_RTOL of ``ref_first_loss`` (phase 6's bf16 first loss on the
    same seed). With ``capture_turns`` (phase 13's cost of a capture on a
    phase-2 step), four more steps after the counts are read, in turns:
    plain, under an active /profilez capture, under one, plain."""
    from bert_pytorch_tpu_torch import run_pretraining

    args = run_pretraining.setup_training(training_args(["--dtype", dtype]))
    if (args.remat, args.max_predictions_per_seq, args.lr_decay,
            args.optimizer) != ("dots", 80, "poly", "lamb"):
        raise AssertionError(f"not the phase-2 recipe: {vars(args)}")
    model, config = run_pretraining.prepare_model(args)
    optimizer, schedule = run_pretraining.prepare_optimizer(args, model)
    step = run_pretraining.make_step(args, model, optimizer, schedule,
                                     config)
    batches = training_batches(args, config, TRAIN_STEPS)
    layers = config.num_hidden_layers
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    # Counts to zero just before the main path, read just after.
    zero_counts(kernels)
    records = []
    for batch in batches:
        t0 = time.perf_counter()
        metrics = step(batch)
        # The runner's default grad-health block (every 4th step) is a
        # dict of telemetry, not a metric.
        values = {k: float(v) for k, v in metrics.items()
                  if k != "grad_health"}  # synchronises
        values["step_ms"] = (time.perf_counter() - t0) * 1e3
        records.append(values)
        log(f"[train {dtype}] step {len(records)}: " + ", ".join(
            f"{k} {v:.6g}" for k, v in values.items()))
    launches = {name: k.launches for name, k in kernels.items()}
    routes = {name: dict(k.route_launches) for name, k in kernels.items()
              if hasattr(k, "route_launches")}
    losses = [r["loss"] for r in records]
    if not all(math.isfinite(x) and r["finite"] == 1.0
               for x, r in zip(losses, records)):
        raise AssertionError(f"non-finite training step: {records}")
    if abs(losses[0] - INIT_LOSS) > 1.0:
        raise AssertionError(f"first loss {losses[0]} is not within 1 of "
                             f"ln(30528) + ln(2) = {INIT_LOSS:.4f}")
    if dtype == "float16":
        scales = [r["loss_scale"] for r in records]
        if scales != [FP16_INIT_SCALE] * TRAIN_STEPS:
            raise AssertionError(f"fp16 loss scales {scales}: expected "
                                 f"{FP16_INIT_SCALE} on every step")
        if abs(losses[0] / ref_first_loss - 1.0) > FP16_LOSS_RTOL:
            raise AssertionError(
                f"fp16 first loss {losses[0]} is not within "
                f"{FP16_LOSS_RTOL:.0%} of bf16's {ref_first_loss}")
    per_step = layers * args.accumulation_steps
    expected = {"flash_attention_fwd": 2 * per_step * TRAIN_STEPS,
                "flash_attention_dq": per_step * TRAIN_STEPS,
                "flash_attention_dkv": per_step * TRAIN_STEPS,
                "layer_norm_fwd": 0}
    for name, want in expected.items():
        if launches[name] != want:
            raise AssertionError(
                f"{name} launched {launches[name]} times over {TRAIN_STEPS} "
                f"steps; expected {want} (remat dots recomputes the forward; "
                "the pretraining path keeps the plain LayerNorm)")
    for name in TRAIN_REPLACES:
        if routes[name]["tensor_cores"] != launches[name]:
            raise AssertionError(f"{name} launches by route {routes[name]}: "
                                 f"every {dtype} launch must take the "
                                 "tensor cores")
    log(f"[train {dtype}] launches {launches}; by route {routes}")
    steady = [r["step_ms"] for r in records[1:]]
    step_ms = statistics.median(steady)
    turns = capture_step_turns(step, batches) if capture_turns else None
    del model, optimizer, step, batches
    torch.cuda.empty_cache()
    return {"steps": TRAIN_STEPS, "dtype": dtype, "losses": losses,
            "loss_scales": [r.get("loss_scale") for r in records],
            "launches": launches, "routes": routes,
            "step_ms": step_ms, "first_step_ms": records[0]["step_ms"],
            "seq_per_s": args.global_batch_size / step_ms * 1e3,
            "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
            "capture_turns": turns}


def capture_step_turns(step, batches: list) -> list:
    """Phase-2 steps in turns (plain, captured, captured, plain): a
    captured step runs under an active trainer capture (a
    ``CaptureController`` over a ``torch.profiler`` window on the card,
    ticked at the step's boundaries as TrainTelemetry ticks it). A step's
    time is the host clock from its dispatch to its loss on the host;
    the capture's collection (synchronize, trace export) is timed apart.
    Outside every main path's count window."""
    from bert_pytorch_tpu_torch.telemetry.profiler import ProfilerWindow
    from bert_pytorch_tpu_torch.telemetry.sampler import CaptureController

    trace_dir = tempfile.mkdtemp(prefix="chip_smoke_capture_")
    controller = CaptureController(
        "trainer", window=ProfilerWindow(None, trace_dir, device="cuda"),
        trace_dir=trace_dir)
    turns = []
    try:
        for i, captured in enumerate((False, True, True, False)):
            if captured:
                controller.arm(duration_s=60)
                controller.tick(i)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            float(step(batches[i % len(batches)])["loss"])
            turn = {"captured": captured,
                    "step_ms": (time.perf_counter() - t0) * 1e3}
            if captured:
                t0 = time.perf_counter()
                record = controller.tick(i + 1, force=True)
                turn.update(collect_s=time.perf_counter() - t0,
                            trace_bytes=record["trace_bytes"],
                            samples=record["samples"])
                if not record["trace_path"]:
                    raise AssertionError(f"capture without a trace: {record}")
            turns.append(turn)
    finally:
        shutil.rmtree(trace_dir, ignore_errors=True)
    log("[debug] capture cost on a phase-2 step (plain, captured, captured, "
        "plain): " + "; ".join(
            f"{'captured' if t['captured'] else 'plain'} "
            f"{t['step_ms']:.1f} ms"
            + (f" (collect {t['collect_s']:.2f} s, trace "
               f"{t['trace_bytes']} bytes)" if t["captured"] else "")
            for t in turns))
    return turns


def check_training_flash_vs_dense() -> dict:
    """fp32, 2 layers at BERT-large width, dropout 0: the same seeded
    weights and batch through a flash model and a dense model; one LAMB
    step each (at the recipe's peak lr: no warmup) must give the same loss,
    gradients and updated parameters."""
    from bert_pytorch_tpu_torch import run_pretraining

    with tempfile.TemporaryDirectory() as tmp:
        path = cut_config(tmp, num_hidden_layers=2, hidden_dropout_prob=0.0,
                          attention_probs_dropout_prob=0.0)
        results = {}
        for backend in ("flash", "dense"):
            args = run_pretraining.setup_training(training_args([
                "--model_config_file", path, "--dtype", "float32",
                "--attention_backend", backend, "--warmup_proportion", "0",
                "--steps", "1", "--global_batch_size",
                str(TRAIN_LOCAL_BATCH)]))
            model, config = run_pretraining.prepare_model(args)
            optimizer, schedule = run_pretraining.prepare_optimizer(args,
                                                                    model)
            step = run_pretraining.make_step(args, model, optimizer,
                                             schedule, config)
            metrics = step(training_batches(args, config, 1, seed0=100)[0])
            results[backend] = (
                float(metrics["loss"]),
                {n: p.grad.clone() for n, p in model.named_parameters()},
                {n: p.detach().clone() for n, p in model.named_parameters()})
            del model, optimizer, step
    (loss_f, grads_f, params_f), (loss_d, grads_d, params_d) = (
        results["flash"], results["dense"])
    loss_err = abs(loss_f - loss_d)
    floor = 1e-4 * max(g.abs().max().item() for g in grads_d.values())
    grad_err = max(((grads_f[n] - grads_d[n]).abs().max()
                    / (grads_d[n].abs().max() + floor)).item()
                   for n in grads_d)
    param_err = max((params_f[n] - params_d[n]).abs().max().item()
                    for n in params_d)
    log(f"[check] fp32 training step, flash vs dense (2 layers, BERT-large "
        f"width): loss {loss_f:.6f} vs {loss_d:.6f} (|d| {loss_err:.2e}, "
        f"atol {TRAIN_LOSS_ATOL:g}), grads max relative {grad_err:.2e} "
        f"(rtol {TRAIN_GRAD_RTOL:g}), params after LAMB {param_err:.2e} "
        f"(atol {TRAIN_PARAM_ATOL:g})")
    if not (loss_err <= TRAIN_LOSS_ATOL and grad_err <= TRAIN_GRAD_RTOL
            and param_err <= TRAIN_PARAM_ATOL):
        raise AssertionError("flash and dense training steps disagree")
    torch.cuda.empty_cache()
    return {"loss_abs_err": loss_err, "grad_rel_err": grad_err,
            "param_abs_err": param_err}


def training_entries(worst: dict, cases: dict, trained: dict,
                     dtype: str = "bfloat16", suffix: str = "") -> list:
    """The kernels-line entries of the training kernels: the headline
    numbers at the main path's shape (S=512, ``dtype``, dropout 0.1),
    device time per call; launches and launches by route from the
    phase-2 drive in that dtype. ``suffix`` marks the names of the fp16
    entries."""
    out = []
    keys = ("kernel_route", "event_ms", "library_event_ms", "cuda_core_ms",
            "rate0_ms", "sdpa_fwd_ms", "sdpa_fwd_bwd_ms", "sdpa_bwd_ms")
    for name in TRAIN_REPLACES:
        head = next(c for c in cases[name] if c["seq"] == TRAIN_SEQ
                    and c["dtype"] == dtype)
        entry = {"name": name + suffix, "route": "cuda", "dtype": dtype,
                 "source": TRAIN_SOURCES[name],
                 "replaces": TRAIN_REPLACES[name],
                 "launches": trained["launches"][name],
                 "max_abs_err": worst[name],
                 "ms": head["ms"], "plain_ms": head["plain_ms"],
                 "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
                 "library_ms": head["library_ms"],
                 "library": ("sdpa forward" if name == "flash_attention_fwd"
                             else "sdpa forward+backward")}
        entry.update({key: head[key] for key in keys if key in head})
        entry["route_launches"] = trained["routes"][name]
        entry["cases"] = cases[name]
        out.append(entry)
    return out


def half_ulp(t: torch.Tensor, dtype=torch.bfloat16) -> torch.Tensor:
    """One ulp of the 16-bit ``dtype`` at each value of ``t`` (fp32
    holding such values; bf16 keeps 8 significant bits, fp16 11), the
    smallest normal's ulp below it."""
    info = torch.finfo(dtype)
    mag = t.abs().clamp(min=info.tiny)
    return torch.exp2(torch.floor(torch.log2(mag))
                      - (7 if dtype == torch.bfloat16 else 10))


def ln_inputs(rows: int, hidden: int, dtype, gen: torch.Generator):
    """x [rows, H] (normal, sd 2, mean 0.5; row 0 all zero and row 1
    constant 0.5, both with variance 0) in ``dtype``; fp32 scale ~ 1 and
    bias ~ 0 [H]."""
    x = torch.randn(rows, hidden, device="cuda", generator=gen) * 2.0 + 0.5
    x[0] = 0.0
    if rows > 1:
        x[1] = 0.5
    scale = 1.0 + 0.1 * torch.randn(hidden, device="cuda", generator=gen)
    bias = 0.1 * torch.randn(hidden, device="cuda", generator=gen)
    return x.to(dtype), scale, bias


def ln_bound_ms(rows: int, hidden: int, dtype) -> tuple:
    """(least time in ms, what bounds it): x read and out written once at
    x's element size plus the fp32 mean and rstd of each row, against
    LN_OPS_PER_ELEMENT fp32 operations per element (the bytes of
    ``layer_norm_cost``, which the kernel's cost note reads too)."""
    from bert_pytorch_tpu_torch.ops.kernels.layernorm import layer_norm_cost

    nbytes = layer_norm_cost(rows, hidden, dtype).bytes_accessed
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = (LN_OPS_PER_ELEMENT * rows * hidden
             / PEAK_FLOPS[torch.float32] * 1e3)
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_ln_gradients(rows: int, hidden: int, gen) -> float:
    """The Function's fp32 dx, dscale and dbias against autograd through
    the plain LayerNorm on the same inputs and output gradient; returns
    the worst error relative to each gradient's largest magnitude."""
    from bert_pytorch_tpu_torch.ops.kernels.layernorm import layer_norm_kernel
    from bert_pytorch_tpu_torch.ops.layernorm import layer_norm

    x, scale, bias = ln_inputs(rows, hidden, torch.float32, gen)
    g = torch.randn(rows, hidden, device="cuda", generator=gen)
    leaves = [t.requires_grad_() for t in (x, scale, bias)]
    grads = [torch.autograd.grad(fn(x, scale, bias, LN_EPS), leaves, g)
             for fn in (layer_norm_kernel, layer_norm)]
    torch.cuda.synchronize()
    worst = 0.0
    for label, got, want in zip(("dx", "dscale", "dbias"), *grads):
        rel = ((got - want).abs().max() / want.abs().max()).item()
        finite = bool(torch.isfinite(got).all())
        if not finite or not rel <= LN_GRAD_RTOL:
            raise AssertionError(
                f"layer_norm Function {label} at [{rows}, {hidden}]: "
                f"relative error {rel:.3e} > {LN_GRAD_RTOL:g} or not "
                f"finite ({finite})")
        worst = max(worst, rel)
    return worst


def check_and_time_layer_norm(shapes=LN_SHAPES,
                              dtypes=(torch.bfloat16, torch.float32),
                              suffix: str = "") -> dict:
    """Phase 7: the LayerNorm forward kernel against its plain version at
    ``shapes`` in ``dtypes`` (out, mean, rstd), its fp32 gradients through
    the autograd Function (when fp32 is among ``dtypes``), and its time
    beside the plain version's, ``torch.nn.functional.layer_norm``'s
    (weight and bias in x's dtype: one PyTorch call for the same function,
    a yardstick only) and its bound. The entry's headline is the first
    shape in the first dtype; ``suffix`` marks its name."""
    from bert_pytorch_tpu_torch.ops.kernels import layernorm as kln

    gen = torch.Generator(device="cuda").manual_seed(4)
    cases, max_err, grad_err = [], 0.0, 0.0
    for rows, hidden in shapes:
        for dtype in dtypes:
            x, scale, bias = ln_inputs(rows, hidden, dtype, gen)
            out, mean, rstd = kln.layer_norm_fwd(x, scale, bias, LN_EPS)
            torch.cuda.synchronize()
            ref, ref_mean, ref_rstd = kln.layer_norm_fwd_reference(
                x, scale, bias, LN_EPS)
            err = (out.float() - ref.float()).abs()
            tol = LN_OUT_ATOL + (half_ulp(ref.float(), dtype)
                                 if dtype != torch.float32 else 0.0)
            mean_ok = ((mean - ref_mean).abs()
                       <= LN_STAT_ATOL + LN_STAT_RTOL * ref_mean.abs()).all()
            rstd_rel = ((rstd - ref_rstd).abs() / ref_rstd).max().item()
            finite = all(bool(torch.isfinite(t).all())
                         for t in (out, mean, rstd))
            name = f"[{rows}, {hidden}] {str(dtype)[6:]}"
            log(f"[check] layer_norm_fwd {name}: out max_abs_err "
                f"{err.max().item():.3e} (atol {LN_OUT_ATOL:g}"
                f"{'' if dtype == torch.float32 else ' + 1 ulp'}), "
                f"mean max_abs_err {(mean - ref_mean).abs().max().item():.3e}, "
                f"rstd max rel err {rstd_rel:.3e} (rtol {LN_STAT_RTOL:g}; "
                f"zero-variance rows: rstd {rstd[0].item():.6g}), "
                f"finite {finite}")
            if not (finite and bool((err <= tol).all()) and bool(mean_ok)
                    and rstd_rel <= LN_STAT_RTOL):
                worst = int(torch.argmax(err - tol))
                raise AssertionError(
                    f"layer_norm_fwd disagrees with its plain version at "
                    f"{name}: element {divmod(worst, hidden)} kernel "
                    f"{out.flatten()[worst].item()!r} plain "
                    f"{ref.flatten()[worst].item()!r} (tolerance "
                    f"{tol.flatten()[worst].item():.3e}); mean ok "
                    f"{bool(mean_ok)}, finite {finite}")
            max_err = max(max_err, err.max().item())
            weight, shift = scale.to(dtype), bias.to(dtype)
            calls = {
                "kernel": lambda: kln.layer_norm_fwd(x, scale, bias, LN_EPS),
                "plain": lambda: kln.layer_norm_fwd_reference(
                    x, scale, bias, LN_EPS),
                "library": lambda: torch.nn.functional.layer_norm(
                    x, (hidden,), weight, shift, LN_EPS)}
            device = {k: device_time_ms(fn) for k, fn in calls.items()}
            events = {k: cuda_time_ms(fn) for k, fn in calls.items()}
            t_bound, by = ln_bound_ms(rows, hidden, dtype)
            log(f"[time] layer_norm_fwd {name}: device time per call "
                f"kernel {device['kernel']:.4f} ms, plain "
                f"{device['plain']:.4f} ms, F.layer_norm "
                f"{device['library']:.4f} ms, bound {t_bound:.4f} ms ({by}); "
                f"CUDA events per call of 100 back to back (with the host's "
                f"issue time) kernel {events['kernel']:.4f}, plain "
                f"{events['plain']:.4f}, F.layer_norm "
                f"{events['library']:.4f} ms")
            cases.append({"rows": rows, "hidden": hidden,
                          "dtype": str(dtype)[6:],
                          "max_abs_err": err.max().item(),
                          "ms": device["kernel"], "plain_ms": device["plain"],
                          "library_ms": device["library"],
                          "event_ms": events["kernel"],
                          "plain_event_ms": events["plain"],
                          "library_event_ms": events["library"],
                          "bound_ms": t_bound, "bound_by": by})
        if torch.float32 in dtypes:
            grad_err = max(grad_err, check_ln_gradients(rows, hidden, gen))
    if torch.float32 in dtypes:
        log(f"[check] layer_norm Function fp32 gradients vs autograd through "
            f"the plain LayerNorm: worst relative error {grad_err:.3e} (rtol "
            f"{LN_GRAD_RTOL:g})")
    head = next(c for c in cases if (c["rows"], c["hidden"]) == shapes[0]
                and c["dtype"] == str(dtypes[0])[6:])
    return {"name": "layer_norm_fwd" + suffix, "route": "cuda",
            "dtype": head["dtype"], "source": LN_SOURCE,
            "replaces": LN_REPLACES, "launches": None, "max_abs_err": max_err,
            "ms": head["ms"], "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
            "library_ms": head["library_ms"],
            "library": "F.layer_norm, weight and bias in x's dtype",
            "grad_rel_err": grad_err, "cases": cases}


SQUAD_STEPS, SQUAD_BATCH, SQUAD_SEQ = 3, 32, 384
# The first loss of a seeded random init: start and end CE over S classes.
SQUAD_INIT_LOSS = math.log(SQUAD_SEQ)
EVAL_SCRIPT = os.path.join(REPO, "scripts", "squad_evaluate_v11.py")


def check_cost_notes(seq: int = 128, dtype=torch.bfloat16) -> dict:
    """Each kernel's cost note against the cost counter's count of its
    plain version on the same CUDA inputs, each counted as an instrumented
    call's first call (telemetry/compile_events.py
    ``CompileMonitor.instrument``; a ``ctypes`` launch is invisible to the
    counter, so each wrapper notes its own flops and bytes to the call's
    counter): at B x S x H x D = 8 x ``seq``
    x 16 x 64 in ``dtype``, dropout 0.1 for #1-#3, and #6 at
    [8*512, 1024]. The wrapper's counted flops must equal the plain
    version's and the wrapper must note exactly once; its bytes are the
    bound's (``*_cost``). These launches are not a main path's: every
    main path zeroes the counts first."""
    from bert_pytorch_tpu_torch.ops.kernels import attention as ka
    from bert_pytorch_tpu_torch.ops.kernels import layernorm as kl
    from bert_pytorch_tpu_torch.telemetry.compile_events import \
        CompileMonitor

    def count(fn) -> dict:
        monitor = CompileMonitor(cost_analysis="auto", device="cuda")
        monitor.instrument(fn, "cost_note")()
        cost, = [r for r in monitor.events if r["kind"] == "compile_cost"]
        return cost

    gen = torch.Generator(device="cuda").manual_seed(21)
    q, k, v, do, kw, key_bias, seg = training_inputs(seq, dtype, False, gen)
    out, lse = ka.flash_attention_fwd(q, k, v, key_bias, seg, 5, 0.1)
    _, delta = ka.flash_attention_dq(q, k, v, out, do, lse, key_bias, seg, 5,
                                     0.1)
    q8, q_scale, k8, k_scale = ka.quantize_qk(q, k)
    x, ln_scale, ln_bias = ln_inputs(8 * 512, 1024, dtype, gen)
    pairs = {
        "flash_attention_infer": (
            lambda: ka.flash_attention_infer(q, k, v, **kw),
            lambda: ka.flash_attention_infer_reference(q, k, v, **kw),
            ka.infer_cost(B, seq, H, D, dtype)),
        "flash_attention_infer_int8": (
            lambda: ka.flash_attention_infer_int8_prequantized(
                q8, k8, q_scale, k_scale, v, key_bias, seg),
            lambda: ka._int8_forward_math(q8, k8, q_scale, k_scale, v,
                                          key_bias, seg),
            ka.infer_int8_cost(B, seq, H, D, dtype)),
        "flash_attention_fwd": (
            lambda: ka.flash_attention_fwd(q, k, v, key_bias, seg, 5, 0.1),
            lambda: ka._forward_math(q, k, v, key_bias, seg, 5, 0.1),
            ka.train_cost("flash_attention_fwd", B, seq, H, D, dtype)),
        "flash_attention_dq": (
            lambda: ka.flash_attention_dq(q, k, v, out, do, lse, key_bias,
                                          seg, 5, 0.1),
            lambda: ka._dq_math(q, k, v, out, do, lse, key_bias, seg, 5, 0.1),
            ka.train_cost("flash_attention_dq", B, seq, H, D, dtype)),
        "flash_attention_dkv": (
            lambda: ka.flash_attention_dkv(q, k, v, do, lse, delta, key_bias,
                                           seg, 5, 0.1),
            lambda: ka._dkv_math(q, k, v, do, lse, delta, key_bias, seg, 5,
                                 0.1),
            ka.train_cost("flash_attention_dkv", B, seq, H, D, dtype)),
        "layer_norm_fwd": (
            lambda: kl.layer_norm_fwd(x, ln_scale, ln_bias, LN_EPS),
            lambda: kl.layer_norm_fwd_reference(x, ln_scale, ln_bias,
                                                LN_EPS),
            kl.layer_norm_cost(8 * 512, 1024, dtype)),
    }
    notes = {}
    for name, (kernel, plain, cost) in pairs.items():
        mine, ref = count(kernel), count(plain)
        if (mine["flops"] != ref["flops"] or mine["flops"] != cost.flops
                or mine["kernel_notes"] != 1 or ref["kernel_notes"] != 0
                or mine["bytes_accessed"] < cost.bytes_accessed):
            raise AssertionError(
                f"{name} cost note: counted {mine} vs the plain version's "
                f"{ref}; cost {cost}")
        notes[name] = {"flops": int(mine["flops"]),
                       "bytes": cost.bytes_accessed,
                       "plain_bytes": int(ref["bytes_accessed"])}
    log(f"[cost] each kernel's note equals its plain version's counted "
        f"flops at S={seq} {str(dtype)[6:]} (#6 at [4096, 1024]), noted "
        f"once: {notes}")
    return notes


def drive_squad(vocab: str, tmp: str, kernels: dict,
                dtype: str = "bfloat16") -> dict:
    """Phase 8 (and 12e in float16, with the dynamic loss scale): SQuAD
    finetuning and prediction at BERT-large width through
    ``run_squad.main`` in ``dtype``, every LayerNorm through the
    kernel."""
    from bert_pytorch_tpu_torch import run_squad
    from bert_pytorch_tpu_torch.tools.make_synthetic_data import (
        write_squad_json)

    train = write_squad_json(os.path.join(tmp, "squad_train.json"), 11, 8)
    dev = write_squad_json(os.path.join(tmp, "squad_dev.json"), 12, 6)
    with open(dev, encoding="utf-8") as f:
        questions = {qa["id"] for article in json.load(f)["data"]
                     for p in article["paragraphs"] for qa in p["qas"]}
    out = os.path.join(tmp, "squad_out")
    args = run_squad.parse_args([
        "--config_file", CONFIG, "--vocab_file", vocab, "--do_lower_case",
        "--train_file", train, "--predict_file", dev, "--do_train",
        "--do_predict", "--do_eval", "--eval_script", EVAL_SCRIPT,
        "--output_dir", out,
        "--max_seq_length", str(SQUAD_SEQ), "--doc_stride", "128",
        "--train_batch_size", str(SQUAD_BATCH), "--max_steps",
        str(SQUAD_STEPS), "--dtype", dtype, "--layer_norm_backend",
        "kernel", "--device", "cuda", "--seed", "0", "--log_freq", "1"])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    # Counts to zero just before the main path, read just after.
    zero_counts(kernels)
    summary, model, _ = run_squad.run(args)
    launches = {name: k.launches for name, k in kernels.items()}
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    write = check_saved_model(out, summary["global_step"], model, "SQuAD")
    losses = summary["step_losses"]
    if len(losses) != SQUAD_STEPS or not all(map(math.isfinite, losses)):
        raise AssertionError(f"SQuAD steps not all finite: {losses}")
    if abs(losses[0] - SQUAD_INIT_LOSS) > 1.0:
        raise AssertionError(f"first SQuAD loss {losses[0]} is not within 1 "
                             f"of ln({SQUAD_SEQ}) = {SQUAD_INIT_LOSS:.4f}")
    with open(os.path.join(out, "predictions.json"), encoding="utf-8") as f:
        answered = set(json.load(f))
    if answered != questions:
        raise AssertionError(f"{len(answered)} predictions for "
                             f"{len(questions)} questions")
    if summary.get("exact_match") is None or summary.get("F1") is None:
        raise AssertionError(f"no EM/F1 from the eval script: {summary}")
    if dtype == "float16" and not summary.get("loss_scale"):
        raise AssertionError(f"fp16 SQuAD ran without its loss scale: "
                             f"{summary}")
    with open(CONFIG, encoding="utf-8") as f:
        per_forward = 1 + 2 * json.load(f)["num_hidden_layers"]
    forwards = summary["global_step"] + summary["predict_batches"]
    expected = {name: 0 for name in kernels}
    expected["layer_norm_fwd"] = per_forward * forwards
    if launches != expected:
        raise AssertionError(f"SQuAD launches {launches}; expected "
                             f"{expected} ({per_forward} LayerNorms per "
                             f"forward over {forwards} forwards)")
    # The counted first call of each step function holds #6's notes: one
    # a LayerNorm of its one forward.
    with open(os.path.join(out, "squad_telemetry.jsonl"),
              encoding="utf-8") as f:
        records = [json.loads(line) for line in f]
    costs = cost_records("SQuAD", records, ["train_step", "predict_step"])
    notes = {fn: cost["kernel_notes"] for fn, (_, cost) in costs.items()}
    if notes != {"train_step": per_forward, "predict_step": per_forward}:
        raise AssertionError(f"SQuAD #6 notes in the counts {notes}; "
                             f"expected {per_forward} a forward")
    del model
    torch.cuda.empty_cache()
    return dict(summary, launches=launches, forwards=forwards,
                questions=len(questions), peak_gib=peak_gib,
                checkpoint_write=write, cost={
                    fn: {k: cost[k] for k in ("flops", "bytes_accessed",
                                              "argument_bytes",
                                              "kernel_notes")}
                    for fn, (_, cost) in costs.items()})


# -- phase 9: the two-phase hand-off, resume and walk-back --------------------

PHASE1 = os.path.join(REPO, "configs", "bert_pretraining_phase1_config.json")
# 9a, the phase-1 recipe at S=128: local batch 32 x accumulation 2, 2
# steps, a synchronous save at step 2. 9b, the phase-2 recipe at S=512:
# phase 6's local batch 8 x 2, 4 steps, async saves every 2 keeping 2.
P1_LOCAL, P1_ACCUM, P1_STEPS, P1_SEQ = 32, 2, 2, 128
# Phases 9 and 10 run BERT-large's full width at HANDOFF_LAYERS layers
# (cut from 24 in PR 17 to make room for phase 17 in the smoke's time:
# the saves, resumes, walk-back, telemetry and finetuning are the same
# code at any depth; a LAMB checkpoint is 1.31 GB instead of 4.03).
HANDOFF_LAYERS = 6
P2_STEPS, P2_EVERY, P2_KEEP = 4, 2, 2
# Three 6-layer LAMB states of 1.31 GB at the peak of a save (two
# retained, one being written), plus headroom.
HANDOFF_DISK_BYTES = 6 * 2 ** 30
# One step from the resumed state against one from the in-memory state:
# bit for bit when every kernel on the step is deterministic; where one is
# not, the loss and every parameter and moment within 1e-5 (the step's lr
# is about 1e-4 at count 4 of the recipe's warmup: a LAMB step moves no
# element by more than lr x its trust ratio, and two runs of a
# nondeterministic reduction differ in the last bits of a gradient).
RESUME_STEP_ATOL = 1e-5
# 9b's run with the runner's telemetry armed (telemetry/): windows of 2
# steps with every step synced, a torch.profiler trace of step 2 (in
# step-in-run terms), the heartbeat and grad health on every step.
TELEMETRY_WINDOW, PROFILE_STEPS, TRACED_STEP = 2, "2:3", 2
# Each training kernel's launches in the trace, by the symbol of either of
# its routes (the tensor-core one carries "_wgmma").
TRACE_KERNELS = {
    "flash_attention_fwd": re.compile(r"flash_fwd_(wgmma_)?kernel"),
    "flash_attention_dq": re.compile(r"flash_dq_(wgmma_)?kernel"),
    "flash_attention_dkv": re.compile(r"flash_dkv_(wgmma_)?kernel"),
}
# A window's mfu is rounded to 4 decimals in its record.
MFU_ATOL = 1e-4
# 9b's /profilez capture, armed at step 2's boundary (the startup trace
# ends there) and collected when the run ends: it covers steps 3 and 4.
CAPTURE_FROM_STEP = 2


def read_records(path: str) -> dict:
    """kind (a train record: its tag) -> the JSONL's records of it."""
    kinds: dict = {}
    with open(path, encoding="utf-8") as f:
        for line in f:
            rec = json.loads(line)
            kinds.setdefault(rec.get("kind", rec.get("tag")), []).append(rec)
    return kinds


def trace_kernels(path: str) -> tuple:
    """(each training kernel's launches, the ms of every kernel) in a
    Chrome trace of ``torch.profiler``, by ``tools/profile_train.py``'s
    reading."""
    from bert_pytorch_tpu_torch.tools.profile_train import (kernel_rows,
                                                            load_trace)

    rows = kernel_rows(load_trace(path))
    counts = {name: sum(n for kernel, _, n in rows if pattern.search(kernel))
              for name, pattern in TRACE_KERNELS.items()}
    return counts, sum(ms for _, ms, _ in rows)


def window_line(w: dict) -> str:
    loader = w.get("loader", {}).get("wait_s_total", "n/a")
    return (f"data_wait_p50 {w['data_wait_p50_s']} s, host_p50 "
            f"{w['host_p50_s']} s, device_p50 {w['device_p50_s']} s, step_p50 "
            f"{w['step_p50_s']} s, mfu {w['mfu']} ({w['mfu_basis']}), "
            f"seq/s {w.get('seq_per_sec')}, loader wait_s_total {loader}")


def check_runner_telemetry(tele_dir: str, r: dict, per_step: list,
                           card: str) -> dict:
    """9b's telemetry, read back: the JSONL passes the port's schema;
    every window synced every step, 0 < device_p50 <= step_p50, mfu on
    the device basis in (0, 1] and equal to the window's sequences x
    FLOPs / its summed device seconds / the card's peak; each memory
    record's peak equal to ``torch.cuda.max_memory_allocated()`` at its
    window's last step (``per_step``: (peak, launch counts) after each
    step); the trace's #1-#3 launches equal the counters over the traced
    step; grad health of every layer on every step; the heartbeat at the
    last step. The span of the last window must sit between the traced
    step's kernel time and its wall time."""
    from bert_pytorch_tpu_torch.telemetry import Heartbeat, schema
    from bert_pytorch_tpu_torch.utils import flops

    jsonl = os.path.join(tele_dir, "pretraining_telemetry.jsonl")
    errors = schema.validate_file(jsonl)
    if errors:
        raise AssertionError(f"9b telemetry JSONL: {errors[:5]}")
    kinds = read_records(jsonl)
    args, config, steps = r["args"], r["config"], len(per_step)
    per_seq = flops.bert_train_flops_per_seq(
        config, TRAIN_SEQ, args.max_predictions_per_seq,
        next_sentence=bool(config.next_sentence))
    peak = flops.peak_tflops(torch.cuda.get_device_name()) * 1e12
    # A save noted after the last full window rolled lands in a record of
    # its own, with no step (the JAX timer's flush rule).
    windows = [w for w in kinds["step_window"] if w["window_steps"]]
    if sum(w["window_steps"] for w in windows) != steps or not all(
            w.get("ckpt_steps") for w in kinds["step_window"]
            if not w["window_steps"]):
        raise AssertionError(f"9b windows {kinds['step_window']} for "
                             f"{steps} steps")
    for w in windows:
        want = (w["window_steps"] * args.global_batch_size * per_seq
                / w["device_sum_s"] / peak)
        if (w["synced_steps"] != w["window_steps"]
                or not 0 < w["device_p50_s"] <= w["step_p50_s"]
                or w["mfu_basis"] != "device" or not 0 < w["mfu"] <= 1
                or abs(w["mfu"] - want) > MFU_ATOL):
            raise AssertionError(f"9b window {w}: mfu recomputed {want}")
    memory = kinds["memory"]
    peaks = [(m["step"], m["peak_bytes_in_use"], per_step[m["step"] - 1][0])
             for m in memory]
    if len(memory) != len(windows) or not all(
            m["memory_supported"] for m in memory) or any(
            a != b for _, a, b in peaks):
        raise AssertionError(f"9b memory {memory}; allocator peaks {peaks}")
    traces = [f for f in os.listdir(os.path.join(tele_dir, "profile"))
              if f.startswith("trace_")]
    if len(traces) != 1:
        raise AssertionError(f"9b profile traces {traces}")
    traced, kernel_ms = trace_kernels(
        os.path.join(tele_dir, "profile", traces[0]))
    counted = {name: per_step[TRACED_STEP - 1][1][name]
               - per_step[TRACED_STEP - 2][1][name] for name in traced}
    if traced != counted:
        raise AssertionError(f"9b trace launches {traced}, counters over the "
                             f"traced step {counted}")
    health = kinds["grad_health"]
    if [h["step"] for h in health] != list(range(1, steps + 1)) or any(
            len(h["per_layer_grad_norm"]) != config.num_hidden_layers
            or "bert/encoder" not in h["groups"] for h in health):
        raise AssertionError(f"9b grad health: {health[:1]}")
    beat = Heartbeat.read(os.path.join(tele_dir, "heartbeat.json"))
    if beat is None or beat["step"] != steps:
        raise AssertionError(f"9b heartbeat {beat}")
    last = windows[-1]
    log(f"[telemetry] 9b last window (steps {last['step'] - 1}-"
        f"{last['step']}): {window_line(last)}; the traced step "
        f"{TRACED_STEP}'s kernels take {kernel_ms:.2f} ms (torch.profiler), "
        f"launches {traced}; memory peaks {peaks}; on {card}")
    if not kernel_ms <= last["device_p50_s"] * 1e3 <= last["step_p50_s"] * 1e3:
        raise AssertionError("the device span is not between the kernels' "
                             f"{kernel_ms:.2f} ms and the step's wall time")
    shutil.rmtree(os.path.join(tele_dir, "profile"))
    return {"windows": windows, "traced_kernel_ms": kernel_ms,
            "trace_launches": traced, "memory_peaks": peaks,
            "grad_health_steps": len(health), "heartbeat": beat}


def check_trainer_capture(tele_dir: str, out: str, per_step: list,
                          probes: dict, port: int, step_ms: list,
                          card: str, layers: int) -> dict:
    """9b's debug plane: /healthz and /statsz answered mid-run, the
    capture armed there covered the steps after it (its profile_window in
    the JSONL, its trace holding exactly the #1-#3 launches the counters
    count over those steps: 4/2/2 per layer per optimizer step, remat
    dots over 2 microbatches), the server closed with the run and the
    clean run left no postmortem."""
    health, stats, arm = probes["healthz"], probes["statsz"], probes["arm"]
    if (health["status"], health["process"], health["step"]) != (
            "ok", "pretrain", CAPTURE_FROM_STEP - 1) or \
            stats["steps"] != CAPTURE_FROM_STEP - 1 or \
            stats["profile"]["phase"] != "idle" or arm[0] != 200:
        raise AssertionError(f"9b debug plane: {probes}")
    try:
        get(port, "/healthz")
    except OSError:
        pass
    else:
        raise AssertionError("9b: the debug server outlived the run")
    if os.path.exists(os.path.join(out, "postmortem.json")):
        raise AssertionError("9b: a clean run left postmortem.json")
    (window,) = read_records(os.path.join(
        tele_dir, "pretraining_telemetry.jsonl"))["profile_window"]
    steps = len(per_step) - CAPTURE_FROM_STEP
    if (window["source"], window["covered"], window["trace_path"]) != (
            "trainer", steps, os.path.join(tele_dir, "profile",
                                           "ondemand_1")):
        raise AssertionError(f"9b profile_window {window}")
    traced, kernel_ms = trace_kernels(os.path.join(
        window["trace_path"], f"trace_{os.getpid()}.json"))
    counted = {name: per_step[-1][1][name]
               - per_step[CAPTURE_FROM_STEP - 1][1][name] for name in traced}
    per = {"flash_attention_fwd": 4 * layers,
           "flash_attention_dq": 2 * layers,
           "flash_attention_dkv": 2 * layers}
    if traced != counted or traced != {n: v * steps for n, v in per.items()}:
        raise AssertionError(f"9b capture trace launches {traced}, counters "
                             f"{counted} over {steps} steps")
    log(f"[debug 9b] /healthz {health['status']} at step {health['step']}, "
        f"/statsz steps {stats['steps']}; /profilez capture over steps "
        f"{CAPTURE_FROM_STEP + 1}-{len(per_step)}: trace "
        f"{window['trace_bytes']} bytes, #1-#3 events {traced} "
        f"({kernel_ms:.2f} ms of kernels), {window['samples']} host samples, "
        f"{window['duration_s']} s; step ms {[round(x, 1) for x in step_ms]}"
        f" (step {TRACED_STEP} under the startup trace, "
        f"{CAPTURE_FROM_STEP + 1}-{len(per_step)} under the capture) on "
        f"{card}")
    return {"trace_bytes": window["trace_bytes"], "covered": steps,
            "trace_launches": traced, "samples": window["samples"],
            "duration_s": window["duration_s"], "step_ms": step_ms}


def check_finetune_telemetry(jsonl: str, name: str, card: str) -> list:
    """A finetune run's JSONL passes the port's schema and its windows of
    steps read a nonzero mfu."""
    from bert_pytorch_tpu_torch.telemetry import schema

    errors = schema.validate_file(jsonl)
    windows = [w for w in read_records(jsonl).get("step_window", [])
               if w["window_steps"]]
    if errors or not windows or not all(w["mfu"] > 0 for w in windows):
        raise AssertionError(f"{name} telemetry: {errors[:5]}, {windows}")
    log(f"[telemetry] {name} window (steps 1-{windows[0]['step']}): "
        f"{window_line(windows[0])} on {card}")
    return windows


def runner(out: str, config_file: str, extra, config: str = CONFIG) -> dict:
    """The pretraining runner's own set-up at BERT-large width (the model
    config ``config``), as its ``main`` runs it up to the loop:
    arguments, model, optimizer and the resume from ``out`` (timed)."""
    from bert_pytorch_tpu_torch import run_pretraining

    args = run_pretraining.setup_training(run_pretraining.parse_arguments([
        "--config_file", config_file, "--model_config_file", config,
        "--output_dir", out, "--dtype", "bfloat16", "--device", "cuda",
        "--seed", "0", "--log_steps", "1", *extra]))
    model, config = run_pretraining.prepare_model(args)
    optimizer, schedule = run_pretraining.prepare_optimizer(args, model)
    kfac, kfac_state = run_pretraining.prepare_kfac(args, model, config)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    checkpoint, global_step = run_pretraining.restore_checkpoint(
        args, model, optimizer, kfac, kfac_state)
    torch.cuda.synchronize()
    return {"args": args, "model": model, "config": config,
            "optimizer": optimizer, "schedule": schedule, "kfac": kfac,
            "kfac_state": kfac_state, "checkpoint": checkpoint,
            "global_step": global_step,
            "resume_s": time.perf_counter() - t0}


def runner_step(r: dict):
    """The runner's train step (make_step) for ``r``'s arguments."""
    from bert_pytorch_tpu_torch import run_pretraining

    return run_pretraining.make_step(r["args"], r["model"], r["optimizer"],
                                     r["schedule"], r["config"], r["kfac"],
                                     r["kfac_state"])


def train_runner(r: dict, dataset, on_step=None, val_dataset=None) -> dict:
    """The runner's loop (prepare_dataset, prepare_val_loader, make_step,
    train) on ``dataset`` (and ``val_dataset``, held out) from where ``r``
    resumed; ``on_step(metrics)`` sees every step's metrics."""
    from bert_pytorch_tpu_torch import run_pretraining

    args = r["args"]
    loader, sampler = run_pretraining.prepare_dataset(
        args, r["config"], r["checkpoint"], dataset)
    r["loader"] = loader
    step = runner_step(r)
    if on_step is not None:
        inner = step

        def step(batch):
            metrics = inner(batch)
            on_step(metrics)
            return metrics

    return run_pretraining.train(args, r["model"], r["optimizer"],
                                 r["config"], step, loader, sampler,
                                 r["checkpoint"], r["global_step"],
                                 r["kfac_state"],
                                 run_pretraining.prepare_val_loader(
                                     args, r["config"], val_dataset))


def training_state(r: dict) -> dict:
    """name -> (param, exp_avg, exp_avg_sq) of ``r``'s model, and the
    count under None."""
    state = {n: (p, r["optimizer"].state[p]["exp_avg"],
                 r["optimizer"].state[p]["exp_avg_sq"])
             for n, p in r["model"].named_parameters()}
    state[None] = r["optimizer"].param_groups[0]["count"]
    return state


def host_copy(state: dict) -> dict:
    return {n: v if n is None else tuple(t.detach().cpu().clone() for t in v)
            for n, v in state.items()}


def check_same_state(label: str, got: dict, want: dict,
                     count=None) -> None:
    """Every parameter and both moments bit for bit (``want`` may be a host
    copy); the count ``count`` when given, else ``want``'s."""
    bad = [n for n in want if n is not None and not all(
        torch.equal(a.cpu() if b.device.type == "cpu" else a, b)
        for a, b in zip(got[n], want[n]))]
    expected = want[None] if count is None else count
    if bad or got[None] != expected:
        raise AssertionError(f"{label}: {len(bad)} tensors differ (e.g. "
                             f"{bad[:3]}); count {got[None]} vs {expected}")


def overlap(step_times: list, write: dict) -> tuple:
    """(indices of the steps whose wall time overlaps the write, of those
    that do not)."""
    over = [i for i, (a, b) in enumerate(step_times)
            if a < write["end"] and b > write["start"]]
    return over, [i for i in range(len(step_times)) if i not in over]


def check_launches_per_step(launches: dict, routes: dict, layers: int,
                            accumulation: int, steps: int) -> None:
    """Phase 6's exact counts (remat dots recomputes the forward), every
    launch on the tensor cores, the LayerNorm kernel never."""
    per_step = layers * accumulation
    expected = {"flash_attention_fwd": 2 * per_step * steps,
                "flash_attention_dq": per_step * steps,
                "flash_attention_dkv": per_step * steps,
                "layer_norm_fwd": 0}
    for name, want in expected.items():
        if launches[name] != want:
            raise AssertionError(f"{name} launched {launches[name]} times "
                                 f"over {steps} steps; expected {want}")
    for name in TRAIN_REPLACES:
        if routes[name]["tensor_cores"] != launches[name]:
            raise AssertionError(f"{name} launches by route {routes[name]}: "
                                 "every bf16 launch must take the tensor "
                                 "cores")


def kernels_deterministic(dtype=torch.bfloat16) -> dict:
    """Whether the training forward, dq and dkv each give the same bits
    twice on the same inputs (S=512, ``dtype``, padded, dropout 0.1).
    Launches outside any main path's count window."""
    from bert_pytorch_tpu_torch.ops.kernels import attention as ka

    gen = torch.Generator(device="cuda").manual_seed(9)
    q, k, v, do, _, key_bias, seg = training_inputs(TRAIN_SEQ, dtype, False,
                                                    gen)
    args = (key_bias, seg, TRAIN_SEED, 0.1)

    def once():
        out, lse = ka.flash_attention_fwd(q, k, v, *args)
        dq, delta = ka.flash_attention_dq(q, k, v, out, do, lse, *args)
        return {"flash_attention_fwd": (out, lse),
                "flash_attention_dq": (dq, delta),
                "flash_attention_dkv": ka.flash_attention_dkv(
                    q, k, v, do, lse, delta, *args)}

    first, second = once(), once()
    return {name: all((x is None and y is None) or torch.equal(x, y)
                      for x, y in zip(first[name], second[name]))
            for name in first}


def drive_handoff(kernels: dict, root: str, card: str) -> dict:
    """Phase 9 at BERT-large width (full width, HANDOFF_LAYERS layers; cut:
    2 + 4 + 1 steps of seeded synthetic rows for the recipes' 7038 + 1563, local
    batches 32 and 8 for the recipes' 64 and 32 with 1024 accumulation
    steps): the runner's set-up, loop, saves and resume, all its own
    functions (no shards and no h5py on the card machine: the rows come
    from SyntheticPretrainingDataset, masked by the port's dataset code).

    9a: phase 1 at S=128 from scratch, a synchronous save at step 2.
    9b: phase 2 at S=512 in the same directory with
    --previous_phase_end_step 2 and the flash kernels: the resumed params
    and moments equal 9a's final state bit for bit with the optimizer
    count 0; 4 steps with phase 6's launch counts on the tensor cores;
    async saves at steps 4 and 6, ckpt_2 pruned.
    9c: a fresh runner resumes 9b's directory: its state equals 9b's final
    state bit for bit; one more step from each on the same batch and
    dropout seeds gives the same loss and params (bit for bit where the
    kernels are deterministic). Then the newest file is truncated and a
    fresh runner walks back to step 4, logging the skip. 9b runs with the
    runner's telemetry armed, read back by check_runner_telemetry."""
    from bert_pytorch_tpu_torch.optim.transforms import opt_step_count
    from bert_pytorch_tpu_torch.testing import faults
    from bert_pytorch_tpu_torch.tools.make_synthetic_data import (
        SyntheticPretrainingDataset)
    from bert_pytorch_tpu_torch.utils import checkpoint as ckpt

    free = shutil.disk_usage(root).free
    log(f"[handoff] {free / 2**30:.1f} GiB free under {root}")
    if free < HANDOFF_DISK_BYTES:
        raise AssertionError(f"phase 9 needs {HANDOFF_DISK_BYTES} bytes of "
                             f"free disk, {free} are free")
    out = os.path.join(root, "pretrain")
    ckpt_dir = os.path.join(out, "pretrain_ckpts")
    cut = os.path.join(root, "handoff_config")
    os.makedirs(cut)
    config = cut_config(cut, num_hidden_layers=HANDOFF_LAYERS)
    # 9a
    r1 = runner(out, PHASE1, [
        "--local_batch_size", str(P1_LOCAL),
        "--global_batch_size", str(P1_LOCAL * P1_ACCUM),
        "--steps", str(P1_STEPS), "--num_steps_per_checkpoint",
        str(P1_STEPS), "--checkpoint_write", "sync",
        "--skip_final_checkpoint"], config)
    if r1["checkpoint"] is not None:
        raise AssertionError(f"phase 1 found a checkpoint in {out}")
    a1 = r1["args"]
    summary1 = train_runner(r1, SyntheticPretrainingDataset(
        1, P1_LOCAL * P1_ACCUM * P1_STEPS, P1_SEQ, r1["config"].vocab_size,
        a1.max_predictions_per_seq))
    write1 = ckpt.write_records[-1]
    if (write1["step"], write1["async"]) != (P1_STEPS, False):
        raise AssertionError(f"phase 1's save: {write1}")
    host1 = host_copy(training_state(r1))
    p1_ms = [(b - a) * 1e3 for a, b in summary1["step_times"]]
    log(f"[handoff] 9a phase 1 (S={P1_SEQ}, {P1_LOCAL} x {P1_ACCUM}): steps "
        f"{[round(x, 1) for x in p1_ms]} ms, loss {summary1['loss']:.4f}; "
        f"sync save of ckpt_{P1_STEPS}: {write1['bytes']} bytes in "
        f"{write1['seconds']:.2f} s (stall {summary1['saves'][0]['stall_s']:.2f}"
        f" s) on {card}")
    del r1
    torch.cuda.empty_cache()
    # 9b
    p2_flags = ["--local_batch_size", str(TRAIN_LOCAL_BATCH),
                "--global_batch_size", str(TRAIN_LOCAL_BATCH * TRAIN_ACCUM),
                "--steps", str(P2_STEPS), "--previous_phase_end_step",
                str(P1_STEPS), "--attention_backend", "flash",
                "--num_steps_per_checkpoint", str(P2_EVERY),
                "--keep_checkpoints", str(P2_KEEP), "--checkpoint_write",
                "async", "--skip_final_checkpoint"]
    tele_dir = os.path.join(root, "telemetry_9b")
    debug_port = free_port()
    r2 = runner(out, PHASE2, p2_flags + [
        "--telemetry_window", str(TELEMETRY_WINDOW),
        "--telemetry_sync_every", "1", "--profile_steps", PROFILE_STEPS,
        "--profile_dir", os.path.join(tele_dir, "profile"),
        "--heartbeat_file", os.path.join(tele_dir, "heartbeat.json"),
        "--telemetry_jsonl", os.path.join(tele_dir,
                                          "pretraining_telemetry.jsonl"),
        "--grad_stats_every", "1", "--debug_port", str(debug_port)], config)
    a2 = r2["args"]
    if (a2.resume_step, r2["global_step"], a2.remat,
            a2.max_predictions_per_seq) != (P1_STEPS, 0, "dots", 80):
        raise AssertionError(f"phase 2 resumed at {a2.resume_step}, step "
                             f"{r2['global_step']}: {vars(a2)}")
    check_same_state("9b resume vs phase 1's final state",
                     training_state(r2), host1, count=0)
    if opt_step_count(r2["optimizer"]) != 0:
        raise AssertionError("the phase surgery left the count at "
                             f"{opt_step_count(r2['optimizer'])}")
    resume_s = {"9b": r2["resume_s"]}
    log(f"[handoff] 9b resumed ckpt_{P1_STEPS} in {r2['resume_s']:.2f} s: "
        "params, mu and nu bit-equal to phase 1's final state, optimizer "
        "count 0")
    del host1
    dataset2 = SyntheticPretrainingDataset(
        2, TRAIN_LOCAL_BATCH * TRAIN_ACCUM * (P2_STEPS + 1), TRAIN_SEQ,
        r2["config"].vocab_size, a2.max_predictions_per_seq)
    n_writes = len(ckpt.write_records)
    per_step = []

    probes = {}

    def on_step(metrics):
        per_step.append((torch.cuda.max_memory_allocated(),
                         {name: k.launches for name, k in kernels.items()}))
        if len(per_step) == CAPTURE_FROM_STEP:
            # The debug plane mid-run, and a capture armed to start at
            # this step's boundary (collected when the run ends).
            probes["healthz"] = get(debug_port, "/healthz")
            probes["statsz"] = get(debug_port, "/statsz")
            probes["arm"] = post(debug_port, "", {"duration_s": 60},
                                 path="/profilez")[:2]

    torch.cuda.synchronize()
    # Counts to zero just before the main path, read just after.
    zero_counts(kernels)
    summary2 = train_runner(r2, dataset2, on_step=on_step)
    launches = {name: k.launches for name, k in kernels.items()}
    routes = {name: dict(k.route_launches) for name, k in kernels.items()
              if hasattr(k, "route_launches")}
    layers = r2["config"].num_hidden_layers
    check_launches_per_step(launches, routes, layers, TRAIN_ACCUM, P2_STEPS)
    if not (math.isfinite(summary2["loss"]) and summary2["finite"] == 1.0):
        raise AssertionError(f"phase 2 step not finite: {summary2}")
    writes2 = list(ckpt.write_records)[n_writes:]
    steps_on_disk = ckpt._ckpt_steps(ckpt_dir)
    want = [P1_STEPS + P2_EVERY, P1_STEPS + P2_STEPS]
    if ([w["step"] for w in writes2] != want or steps_on_disk != want
            or not all(w["async"] for w in writes2)):
        raise AssertionError(f"phase 2 writes {writes2}, on disk "
                             f"{steps_on_disk}; expected async {want}, "
                             f"ckpt_{P1_STEPS} pruned")
    p2_ms = [(b - a) * 1e3 for a, b in summary2["step_times"]]
    capture_9b = check_trainer_capture(tele_dir, out, per_step, probes,
                                       debug_port, p2_ms, card, layers)
    telemetry_9b = check_runner_telemetry(tele_dir, r2, per_step, card)
    over, clear = overlap(summary2["step_times"], writes2[0])
    stalls = [s["stall_s"] for s in summary2["saves"]]
    log(f"[handoff] 9b phase 2 (S={TRAIN_SEQ}, flash, {TRAIN_LOCAL_BATCH} x "
        f"{TRAIN_ACCUM}): steps {[round(x, 1) for x in p2_ms]} ms; async "
        f"save stalls {[round(x * 1e3, 1) for x in stalls]} ms; background "
        f"writes {[(w['step'], w['bytes'], round(w['seconds'], 2)) for w in writes2]}"
        f" (step, bytes, s); steps overlapping the first write {over}, "
        f"clear of it {clear}; launches {launches}; on {card}")
    # 9c
    r3 = runner(out, PHASE2, p2_flags, config)
    if (r3["args"].resume_step, r3["global_step"]) != (
            P1_STEPS + P2_STEPS, P2_STEPS):
        raise AssertionError(f"9c resumed at {r3['args'].resume_step}")
    resume_s["9c"] = r3["resume_s"]
    state2 = training_state(r2)
    check_same_state("9c resume vs 9b's final state", training_state(r3),
                     state2)
    from bert_pytorch_tpu_torch import pretrain
    from bert_pytorch_tpu_torch.tools.make_synthetic_data import (
        synthetic_pretraining_batch)

    batch = pretrain.to_device(pretrain.stack_microbatches(
        synthetic_pretraining_batch(77, a2.global_batch_size, TRAIN_SEQ,
                                    r2["config"].vocab_size,
                                    a2.max_predictions_per_seq),
        a2.accumulation_steps), a2.device)
    metrics = {}
    for label, r in (("memory", r2), ("resumed", r3)):
        metrics[label] = float(runner_step(r)(batch)["loss"])
    after2, after3 = training_state(r2), training_state(r3)
    diff = max((a - b).abs().max().item()
               for n in after2 if n is not None
               for a, b in zip(after2[n], after3[n]))
    exact = diff == 0.0 and metrics["memory"] == metrics["resumed"]
    determinism = kernels_deterministic()
    log(f"[handoff] 9c resumed ckpt_{P1_STEPS + P2_STEPS} in "
        f"{r3['resume_s']:.2f} s, bit-equal to 9b's final state; one more "
        f"step: loss {metrics} max |param/moment diff| {diff:.3e} "
        f"(bit-equal {exact}); kernels bit-deterministic {determinism}")
    if not exact and all(determinism.values()):
        raise AssertionError("the resumed step differs from the in-memory "
                             "one although every kernel is deterministic")
    if not exact and (diff > RESUME_STEP_ATOL or abs(
            metrics["memory"] - metrics["resumed"]) > RESUME_STEP_ATOL):
        raise AssertionError(f"resumed step off by {diff} (tolerance "
                             f"{RESUME_STEP_ATOL:g} where a kernel is not "
                             f"deterministic: {determinism})")
    del r3, state2, after2, after3
    torch.cuda.empty_cache()
    newest = ckpt.checkpoint_path(ckpt_dir, P1_STEPS + P2_STEPS)
    faults.corrupt_checkpoint(newest, "truncate")
    import warnings

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        r4 = runner(out, PHASE2, p2_flags, config)
    skips = [str(w.message) for w in caught
             if "Skipping unreadable checkpoint" in str(w.message)]
    resume_s["walk_back"] = r4["resume_s"]
    if r4["args"].resume_step != P1_STEPS + P2_EVERY or len(skips) != 1:
        raise AssertionError(f"walk-back resumed at "
                             f"{r4['args'].resume_step}, skips {skips}")
    log(f"[handoff] walk-back: truncated ckpt_{P1_STEPS + P2_STEPS}, resumed "
        f"ckpt_{P1_STEPS + P2_EVERY} in {r4['resume_s']:.2f} s; skip logged: "
        f"{skips[0][:160]}")
    del r4, r2
    torch.cuda.empty_cache()
    init = ckpt.checkpoint_path(ckpt_dir, ckpt.find_resume_step(ckpt_dir,
                                                                verify=True))
    return {"config": config, "phase1_step_ms": p1_ms, "sync_write": write1,
            "sync_stall_s": summary1["saves"][0]["stall_s"],
            "phase2_step_ms": p2_ms, "async_stalls_s": stalls,
            "async_writes": writes2, "steps_overlapping_write": over,
            "steps_clear_of_write": clear, "launches": launches,
            "routes": routes, "resume_s": resume_s,
            "determinism": determinism, "resumed_step_bit_equal": exact,
            "resumed_step_max_diff": diff, "resumed_step_loss": metrics,
            "telemetry": telemetry_9b, "capture": capture_9b,
            "init_checkpoint": init}


# -- phase 10: finetune from the pretraining checkpoint, save, serve ---------

# The scripts' recipes at S=128 (scripts/run_glue.sh, run_ner.sh,
# run_swag.sh: batch 32, 32 and 16), one epoch of seeded synthetic files
# sized to 3 steps each (cut from the datasets' sizes).
FT_SEQ = 128
FT_RUNS = {"glue": (32, 96), "ner": (32, 96), "swag": (16, 48)}
# Each runner again without checkpoints for its seq/s at the recipe: 3
# epochs (9 steps), after the saving run of the same shapes in the same
# process (the saving run's seq/s waits on its per-step writes).
FT_TIMED_EPOCHS = 3
# The served GLUE logits against the runner's model on the same dev row,
# both bf16: the server runs kernel #4 on the 128 bucket, the runner's
# evaluation dense attention, so the two differ by bf16 rounding in its
# layers of attention (24 until PR 17, HANDOFF_LAYERS since), not by more
# than 5e-2 absolute on a logit.
GLUE_SERVE_ATOL = 5e-2
# The GLUE run's telemetry: one window over its 3 steps.
FT_TELEMETRY_WINDOW = 3


def check_saved_model(out: str, step: int, model, label: str) -> dict:
    """The runner's final checkpoint in ``out`` (``ckpt_{step}``) verifies,
    and reads back through ``load_params_only`` equal to ``model``'s
    params bit for bit. Returns its write record."""
    from bert_pytorch_tpu_torch.utils import checkpoint as ckpt
    from bert_pytorch_tpu_torch.utils import integrity

    path = ckpt.checkpoint_path(out, step)
    write = next(w for w in reversed(ckpt.write_records)
                 if w["path"] == path)
    status = integrity.verify_checkpoint(path)[0]
    state = model.state_dict()
    back = ckpt.load_params_only(path, state, device="cuda")
    bad = [k for k in state if not torch.equal(back[k], state[k])]
    if status != integrity.VERIFIED or bad or set(back) != set(state):
        raise AssertionError(f"{label} checkpoint {path}: {status}, "
                             f"{len(bad)} tensors differ (e.g. {bad[:3]})")
    log(f"[ckpt] {label}: final ckpt_{step} {write['bytes']} bytes written "
        f"in {write['seconds']:.2f} s (sync), reads back equal to the "
        f"runner's params")
    return write


def drive_finetune(vocab: str, root: str, init: str, config: str,
                   kernels: dict, card: str) -> dict:
    """Phase 10: ``run_glue``, ``run_ner`` and ``run_swag`` (their own
    ``run``) at BERT-large width and phase 9's depth (the model config
    ``config``) on seeded synthetic files, each from phase 9's checkpoint
    (``--init_checkpoint``, NER's ``--model_checkpoint``), with
    ``--save_steps 1`` and the final save; each prints its metrics and its
    final checkpoint reads back equal. Then ``run_server.build_service
    --tasks classify --classify_checkpoint <glue out>`` answers a dev
    example over HTTP, one launch of #4 per layer per forward on the
    tensor cores, and its logits for the row equal the GLUE model's
    within GLUE_SERVE_ATOL."""
    from bert_pytorch_tpu_torch import run_glue, run_ner, run_swag
    from bert_pytorch_tpu_torch.data import glue
    from bert_pytorch_tpu_torch.data.tokenization import (
        get_wordpiece_tokenizer)
    from bert_pytorch_tpu_torch.serve.batcher import Request
    from bert_pytorch_tpu_torch.tools import make_synthetic_data as synth

    data = os.path.join(root, "finetune_data")
    mrpc = synth.write_mrpc_tsvs(os.path.join(data, "MRPC"), 21,
                                 FT_RUNS["glue"][1], 32)
    conll = synth.write_conll(os.path.join(data, "ner.txt"), 22,
                              FT_RUNS["ner"][1])
    swag_train = synth.write_swag_csv(os.path.join(data, "swag.csv"), 23,
                                      FT_RUNS["swag"][1])
    swag_val = synth.write_swag_csv(os.path.join(data, "swag_val.csv"), 24,
                                    16)
    base = ["--model_config_file", config, "--vocab_file", vocab,
            "--device", "cuda", "--dtype", "bfloat16", "--max_seq_len",
            str(FT_SEQ)]
    common = base + ["--epochs", "1", "--save_steps", "1"]
    argv = {
        "glue": ["--task", "mrpc", "--data_dir", mrpc, "--init_checkpoint",
                 init],
        "ner": ["--train_file", conll, "--val_file", conll, "--test_file",
                conll, "--labels", *synth.NER_LABELS, "--model_checkpoint",
                init],
        "swag": ["--train_file", swag_train, "--val_file", swag_val,
                 "--init_checkpoint", init]}
    modules = {"glue": run_glue, "ner": run_ner, "swag": run_swag}
    metric = {"glue": "accuracy", "ner": "test_f1", "swag": "accuracy"}
    runs, glue_model = {}, None
    for name, module in modules.items():
        out = os.path.join(root, f"{name}_out")
        tele = ["--telemetry_window", str(FT_TELEMETRY_WINDOW)] if (
            name == "glue") else []
        args = module.parse_arguments(argv[name] + common + tele + [
            "--batch_size", str(FT_RUNS[name][0]), "--output_dir", out])
        torch.cuda.synchronize()
        zero_counts(kernels)
        results, model, _ = module.run(args)
        launches = {n: k.launches for n, k in kernels.items()}
        if any(launches.values()):
            raise AssertionError(f"{name}: kernels {launches} launched on a "
                                 "path of dense attention and plain "
                                 "LayerNorm")
        steps = results["global_step"]
        if steps != FT_RUNS[name][1] // FT_RUNS[name][0] or not (
                0.0 <= results.get(metric[name], -1.0) <= 1.0):
            raise AssertionError(f"{name}: {results}")
        write = check_saved_model(out, steps, model, name)
        runs[name] = dict(results, checkpoint_write=write)
        if name == "glue":
            runs[name]["telemetry_windows"] = check_finetune_telemetry(
                os.path.join(out, "glue_telemetry.jsonl"), name, card)
        log(f"[finetune] {name}: {steps} steps at batch {FT_RUNS[name][0]}, "
            f"S={FT_SEQ}, bf16: {results['training_sequences_per_second']:.2f}"
            f" seq/s, {metric[name]} {results[metric[name]]:.4f}; model "
            f"checkpoint {write['bytes']} bytes in {write['seconds']:.2f} s "
            f"on {card}")
        if name == "glue":
            glue_model = model
        else:
            shutil.rmtree(out)
        del model
        torch.cuda.empty_cache()
    # Serve what GLUE finetuned.
    glue_out = os.path.join(root, "glue_out")
    example = glue.PROCESSORS["mrpc"]().get_dev_examples(mrpc)[0]
    payload = {"text": example.text_a, "text_pair": example.text_b}
    served, engine = serve_waves(
        serve_args(vocab, "bfloat16", "flash_infer", "classify",
                   ["--classify_checkpoint", glue_out], config),
        [[("classify", payload)]], kernels)
    check_launches(served, "flash_attention_infer", ("layer_norm_fwd",))
    row = glue.features_to_arrays(glue.convert_examples_to_features(
        [example], get_wordpiece_tokenizer(vocab), FT_SEQ,
        glue.PROCESSORS["mrpc"].labels), False)
    spec = engine.tasks["classify"]
    features = spec.handler.prepare(payload, engine.max_len())
    n = int(row["input_mask"][0].sum())
    if list(features["input_ids"])[:n] != row["input_ids"][0][:n].tolist():
        raise AssertionError("the server tokenizes the dev row differently")
    plan = engine.plan_batch([Request("classify", features, payload)],
                             packed=False)
    served_logits = torch.as_tensor(np.asarray(
        engine.execute("classify", plan)[0][0], np.float32)).reshape(-1)
    with torch.no_grad():
        t = {k: torch.from_numpy(v).long().cuda() for k, v in row.items()}
        runner_logits = glue_model(t["input_ids"], t["segment_ids"],
                                   t["input_mask"]).float().cpu()[0]
    err = (served_logits - runner_logits).abs().max().item()
    log(f"[serve] GLUE model served from {glue_out} (bucket {plan.bucket}): "
        f"logits {served_logits.tolist()} vs the runner's "
        f"{runner_logits.tolist()}, max |d| {err:.3e} (atol "
        f"{GLUE_SERVE_ATOL:g})")
    if not err <= GLUE_SERVE_ATOL:
        raise AssertionError("the served GLUE logits differ from the "
                             "runner's model")
    del engine, glue_model
    shutil.rmtree(glue_out)
    torch.cuda.empty_cache()
    timed = {}
    for name, module in modules.items():
        results, model, _ = module.run(module.parse_arguments(
            argv[name] + base + ["--epochs", str(FT_TIMED_EPOCHS),
                                 "--batch_size", str(FT_RUNS[name][0])]))
        timed[name] = results["training_sequences_per_second"]
        log(f"[finetune] {name} without checkpoints: "
            f"{results['global_step']} steps, {timed[name]:.2f} seq/s "
            f"(batch {FT_RUNS[name][0]}, S={FT_SEQ}, bf16) on {card}")
        del model
        torch.cuda.empty_cache()
    return {"runs": runs, "served": {k: served[k] for k in (
        "requests", "forwards", "launches", "routes")},
        "served_logit_err": err, "seq_per_s_without_checkpoints": timed}


# -- phase 11: K-FAC pretraining ---------------------------------------------

# The runner's K-FAC (fused capture, cholesky) with its intervals cut from
# 10 and 100 so that four steps pass both gates: factors every step,
# inverses at counts 0 and 2.
KFAC_FLAGS = ["--kfac", "--kfac_factor_interval", "1",
              "--kfac_inv_interval", "2"]
KFAC_STEPS, KFAC_STATS_STEPS, KFAC_STATS_BATCH = 4, 2, 4
# Its depth, cut from 24 in PR 17 to make room for phase 17 in the
# smoke's time (full width: the factors are BERT-large's, 1025² to 4097²).
KFAC_LAYERS = 6
# A K-FAC training checkpoint at 6 layers is 2.18 GB (7.5 GB at 24); one
# retained and one being written, plus headroom.
KFAC_DISK_BYTES = 6 * 2 ** 30
# A captured factor is Xᵀ X from cuBLAS, whose (i, j) and (j, i) entries
# may sum in another order: symmetric within 1e-5 of its largest entry.
KFAC_SYMMETRY_RTOL = 1e-5
# One K-FAC step from the resumed state against one from the in-memory
# state: within RESUME_STEP_ATOL, its bit-equality logged beside a probe
# of the kernels and of K-FAC's library calls (cuBLAS, cuSOLVER). Two
# identical states stepped once read 1.1e-11 apart in one of four card
# runs with #1-#3 bit-deterministic (PR 10), so the libraries' bits do
# not repeat every time; the resume itself is held bit for bit (params,
# moments, factors, count, and inverses equal to the restored factors'),
# the next step's factors to the factor bar below.
# Card parity (2 layers of BERT-large width, fp32, dropout 0): factors of
# two capture paths within the JAX package's bar between its own two
# (tests/test_kfac.py:242-247); each inverse method's preconditioned
# gradients (the JAX test's: all-ones gradients, damping 0.003, lr 0.01,
# fp32 inverses) within KFAC_REF_RTOL of the largest entry of the same
# method computed in float64 from the same factors; eigen against
# cholesky in direction: cosine above 0.7 (tests/test_kfac.py:442-447),
# or, for a layer where the float64 methods themselves part further (the
# damping enters each differently), the card's cosine within
# KFAC_COS_ATOL of the float64 one.
KFAC_FACTOR_RTOL, KFAC_FACTOR_ATOL = 2e-4, 1e-5
KFAC_REF_RTOL = 1e-3
KFAC_COS_MIN, KFAC_COS_ATOL = 0.7, 1e-2
KFAC_PARITY_DAMPING, KFAC_PARITY_LR = 0.003, 0.01


def factor_errors(got, want, rtol: float, atol: float) -> tuple:
    """(max |got - want| over every factor, worst excess over atol + rtol
    |want|: <= 0 where all agree)."""
    diff, excess = 0.0, -math.inf
    for field in ("a", "g"):
        for key, ref in getattr(want, field).items():
            d = (getattr(got, field)[key] - ref).abs()
            diff = max(diff, d.max().item())
            excess = max(excess, (d - atol - rtol * ref.abs()).max().item())
    return diff, excess


def check_symmetric(state, label: str) -> float:
    worst = 0.0
    for field in ("a", "g"):
        for key, fac in getattr(state, field).items():
            rel = ((fac - fac.transpose(-1, -2)).abs().max()
                   / fac.abs().max().clamp_min(1e-30)).item()
            worst = max(worst, rel)
            if not rel <= KFAC_SYMMETRY_RTOL:
                raise AssertionError(f"{label}: factor {key} asymmetric by "
                                     f"{rel:.2e} of its largest entry")
    return worst


def precondition_fp64(spec_list, state, grads: dict, method: str,
                      damping: float, kl_clip: float, lr: float) -> dict:
    """The plain float64 version of ``KFAC.precondition`` from ``state``'s
    factors: its own inverses (cholesky: (F + √γ I)⁻¹; eigen: eigh,
    eigenvalues clamped at 0), P per layer, the kl_clip scale over all."""
    def inverse(fac):
        fac = fac.double()
        if method == "eigen":
            w, v = torch.linalg.eigh(fac)
            return v, w.clamp_min(0.0)
        eye = torch.eye(fac.shape[-1], dtype=torch.float64,
                        device=fac.device)
        return torch.linalg.inv(fac + math.sqrt(damping) * eye), None

    pre, vg = {}, 0.0
    for spec in spec_list:
        for i, module in enumerate(spec.modules):
            w = torch.cat([grads[f"{module}.weight"].t(),
                           grads[f"{module}.bias"][None]]).double()
            qa, la = inverse(state.a[spec.a_key][i])
            qg, lg = inverse(state.g[spec.g_key][i])
            if method == "eigen":
                v = qa.t() @ w @ qg / (la[:, None] * lg[None, :] + damping)
                p = qa @ v @ qg.t()
            else:
                p = qa @ w @ qg
            vg += float((p * w).sum()) * lr * lr
            pre[module] = p
    nu = min(1.0, math.sqrt(kl_clip / max(vg, 1e-30)))
    return {module: (p * nu)[:-1].t() for module, p in pre.items()}


def check_kfac_parity(tmp: str) -> dict:
    """11d at 2 layers of BERT-large width, fp32, dropout 0, the same
    seeded weights and batch: the fused capture (remat dots) against the
    stats pass on microbatch 0 and against the fused capture under remat
    none; eigen and cholesky preconditioning on the card against float64
    and against each other."""
    from bert_pytorch_tpu_torch import pretrain, run_pretraining
    from bert_pytorch_tpu_torch.optim import KFAC

    path = cut_config(tmp, num_hidden_layers=2, hidden_dropout_prob=0.0,
                      attention_probs_dropout_prob=0.0)

    def build(remat: str) -> dict:
        args = run_pretraining.setup_training(training_args([
            "--model_config_file", path, "--dtype", "float32", "--remat",
            remat, "--steps", "1", *KFAC_FLAGS]))
        model, config = run_pretraining.prepare_model(args)
        optimizer, schedule = run_pretraining.prepare_optimizer(args, model)
        kfac, kfac_state = run_pretraining.prepare_kfac(args, model, config)
        return {"args": args, "model": model, "config": config,
                "optimizer": optimizer, "schedule": schedule, "kfac": kfac,
                "kfac_state": kfac_state}

    dots = build("dots")
    if dots["args"].remat != "dots":
        raise AssertionError(f"remat {dots['args'].remat}")
    batch = training_batches(dots["args"], dots["config"], 1, seed0=300)[0]
    kfac = dots["kfac"]
    stats = kfac.init()
    kfac.apply_loss = pretrain.make_kfac_loss(
        dots["model"], True, dots["args"].max_predictions_per_seq)
    kfac.update_factors(stats, {k: v[0] for k, v in batch.items()})
    runner_step(dots)(batch)
    stats_diff, stats_excess = factor_errors(
        dots["kfac_state"], stats, KFAC_FACTOR_RTOL, KFAC_FACTOR_ATOL)
    none = build("none")
    runner_step(none)(batch)
    remat_diff, remat_excess = factor_errors(
        dots["kfac_state"], none["kfac_state"], KFAC_FACTOR_RTOL,
        KFAC_FACTOR_ATOL)
    log(f"[kfac] 11d fused capture vs the stats pass on microbatch 0: max "
        f"|diff| {stats_diff:.3e}; remat dots vs none: {remat_diff:.3e} "
        f"(rtol {KFAC_FACTOR_RTOL:g}, atol {KFAC_FACTOR_ATOL:g})")
    if stats_excess > 0 or remat_excess > 0:
        raise AssertionError("K-FAC factors differ between capture paths")
    del none, stats
    model = dots["model"]
    ones = {n: torch.ones_like(p) for n, p in model.named_parameters()}
    results, cosines = {}, {}
    for method in ("cholesky", "eigen"):
        k = KFAC(model, inv_method=method, damping=KFAC_PARITY_DAMPING,
                 inv_dtype=torch.float32)
        st = k.init()
        for field in ("a", "g"):
            for key, value in getattr(dots["kfac_state"], field).items():
                getattr(st, field)[key].copy_(value)
        k.update_inverses(st)
        card = k.precondition(st, ones, KFAC_PARITY_LR)
        ref = precondition_fp64(k.specs, st, ones, method,
                                KFAC_PARITY_DAMPING, k.kl_clip,
                                KFAC_PARITY_LR)
        worst = max(((card[f"{m}.weight"].double() - r).abs().max()
                     / r.abs().max()).item() for m, r in ref.items())
        log(f"[kfac] 11d {method}: card vs float64 {worst:.3e} of the "
            f"largest entry (rtol {KFAC_REF_RTOL:g})")
        if not worst <= KFAC_REF_RTOL:
            raise AssertionError(f"{method} preconditioning off float64 by "
                                 f"{worst}")
        results[method] = (card, ref, worst)
    for module in results["cholesky"][1]:
        pair = [results[m][0][f"{module}.weight"].flatten().double()
                for m in ("cholesky", "eigen")]
        ref = [results[m][1][module].flatten() for m in ("cholesky", "eigen")]
        cos = float(pair[0] @ pair[1] / (pair[0].norm() * pair[1].norm()))
        cos64 = float(ref[0] @ ref[1] / (ref[0].norm() * ref[1].norm()))
        cosines[module] = (cos, cos64)
        if not (cos > KFAC_COS_MIN or (cos64 <= KFAC_COS_MIN and abs(
                cos - cos64) <= KFAC_COS_ATOL)):
            raise AssertionError(f"{module}: eigen vs cholesky cosine {cos} "
                                 f"(float64 {cos64})")
    log(f"[kfac] 11d eigen vs cholesky cosine (card, float64) by layer: "
        + ", ".join(f"{m.replace('bert.encoder.layers.', '')} "
                    f"{c:.4f}/{c64:.4f}" for m, (c, c64) in cosines.items()))
    del dots, results, model, ones
    torch.cuda.empty_cache()
    return {"stats_vs_fused_max_diff": stats_diff,
            "remat_none_vs_dots_max_diff": remat_diff,
            "eigen_cholesky_cosine": cosines}


def kfac_state_equal(got, want) -> list:
    """Keys of the factors and count that differ (bit for bit)."""
    bad = [f"{field}/{key}" for field in ("a", "g")
           for key, value in getattr(want, field).items()
           if not torch.equal(getattr(got, field)[key], value)]
    if int(got.count) != int(want.count):
        bad.append("count")
    return bad


def kfac_deterministic(r: dict, batch: dict) -> dict:
    """Whether K-FAC's library calls give the same bits twice on the same
    inputs: the stats pass's capture (fp32 ``addmm``), the inverse update
    (cuSOLVER) and the precondition (cuBLAS), each run twice from one
    state. Launches outside any main path's count window."""
    from bert_pytorch_tpu_torch import pretrain

    kfac, state = r["kfac"], r["kfac_state"]

    def factors_of():
        fresh = kfac.init()
        kfac.update_factors(fresh, {k: v[0] for k, v in batch.items()})
        return [t.clone() for t in list(fresh.a.values())
                + list(fresh.g.values())]

    def inverses_of():
        copy = kfac.init()
        for field in ("a", "g"):
            for key, value in getattr(state, field).items():
                getattr(copy, field)[key].copy_(value)
        kfac.inverse_factors(copy)
        return list(copy.qa.values()) + list(copy.qg.values())

    grads = {n: p.grad for n, p in r["model"].named_parameters()}

    def preconditioned():
        return list(kfac.precondition(state, grads, 1e-3).values())

    saved = kfac.apply_loss
    kfac.apply_loss = pretrain.make_kfac_loss(
        r["model"], True, r["args"].max_predictions_per_seq)
    try:
        out = {}
        for name, run in (("capture", factors_of),
                          ("inverses", inverses_of),
                          ("precondition", preconditioned)):
            first, second = run(), run()
            out[name] = all(torch.equal(a, b) for a, b in zip(first, second))
            del first, second
    finally:
        kfac.apply_loss = saved
    torch.cuda.empty_cache()
    return out


def drive_kfac(kernels: dict, root: str, card: str) -> dict:
    """Phase 11: K-FAC pretraining of BERT-large's width at KFAC_LAYERS
    layers on the runner's own functions (the phase-2 recipe: S=512,
    flash, remat dots, LAMB, bf16; local batch 8 x 2, seeded synthetic
    rows).

    11a: 4 steps with ``--kfac`` (fused capture, factors every step,
    inverses every 2), a sync final save keeping 1: every loss finite,
    count 4, symmetric factors, phase 6's launches per step on the tensor
    cores (the capture rides the step's own backward).
    11c: a fresh runner resumes the save: params, moments, factors and
    count bit-equal, the inverses recomputed; one more step from each
    agrees within RESUME_STEP_ATOL (its factors within the factor bar).
    11b: 2 steps with ``--kfac_capture stats --kfac_stats_batch 4``: per
    factor-due step one more forward, dq and dkv per layer than a fused
    step.
    11e: the K-FAC step against the plain one in turns
    (``tools/profile_train.kfac_turns``: capture, inverse and precondition
    device times; one 4097² eigh), the state's and checkpoint's bytes."""
    from bert_pytorch_tpu_torch.tools import profile_train
    from bert_pytorch_tpu_torch.tools.make_synthetic_data import (
        SyntheticPretrainingDataset)
    from bert_pytorch_tpu_torch.utils import checkpoint as ckpt

    free = shutil.disk_usage(root).free
    log(f"[kfac] {free / 2**30:.1f} GiB free under {root}")
    if free < KFAC_DISK_BYTES:
        raise AssertionError(f"phase 11 needs {KFAC_DISK_BYTES} bytes of "
                             f"free disk, {free} are free")
    out = os.path.join(root, "kfac")
    flags = ["--local_batch_size", str(TRAIN_LOCAL_BATCH),
             "--global_batch_size", str(TRAIN_LOCAL_BATCH * TRAIN_ACCUM),
             "--steps", str(KFAC_STEPS), "--attention_backend", "flash",
             "--num_steps_per_checkpoint", str(10 ** 6),
             "--keep_checkpoints", "1", "--previous_phase_end_step", "0",
             *KFAC_FLAGS]
    cut = os.path.join(root, "kfac_config")
    os.makedirs(cut)
    config = cut_config(cut, num_hidden_layers=KFAC_LAYERS)
    # 11a
    r = runner(out, PHASE2, flags, config)
    args = r["args"]
    if (args.remat, args.optimizer, r["checkpoint"], args.kfac_capture) != (
            "dots", "lamb", None, "train"):
        raise AssertionError(f"not the K-FAC phase-2 run: {vars(args)}")
    state_bytes = r["kfac_state"].nbytes()
    dataset = SyntheticPretrainingDataset(
        11, TRAIN_LOCAL_BATCH * TRAIN_ACCUM * KFAC_STEPS, TRAIN_SEQ,
        r["config"].vocab_size, args.max_predictions_per_seq)
    records = []
    n_writes = len(ckpt.write_records)
    torch.cuda.synchronize()
    # Counts to zero just before the main path, read just after.
    zero_counts(kernels)
    summary = train_runner(r, dataset, on_step=records.append)
    launches = {name: k.launches for name, k in kernels.items()}
    routes = {name: dict(k.route_launches) for name, k in kernels.items()
              if hasattr(k, "route_launches")}
    layers = r["config"].num_hidden_layers
    check_launches_per_step(launches, routes, layers, TRAIN_ACCUM,
                            KFAC_STEPS)
    losses = [float(m["loss"]) for m in records]
    if len(losses) != KFAC_STEPS or not all(
            math.isfinite(x) and float(m["finite"]) == 1.0
            for x, m in zip(losses, records)):
        raise AssertionError(f"K-FAC steps not finite: {losses}")
    kstate = r["kfac_state"]
    if int(kstate.count) != KFAC_STEPS:
        raise AssertionError(f"K-FAC count {int(kstate.count)}, expected "
                             f"{KFAC_STEPS}")
    asym = check_symmetric(kstate, "11a")
    write = list(ckpt.write_records)[n_writes:]
    if [(w["step"], w["async"]) for w in write] != [(KFAC_STEPS, False)]:
        raise AssertionError(f"11a's saves: {write}")
    write = write[0]
    step_ms = [(b - a) * 1e3 for a, b in summary["step_times"]]
    log(f"[kfac] 11a BERT-large K-FAC (fused, cholesky, factors every step, "
        f"inverses every 2), {TRAIN_LOCAL_BATCH} x {TRAIN_ACCUM}: losses "
        f"{[round(x, 4) for x in losses]}, grad_norm "
        f"{[round(float(m['grad_norm']), 4) for m in records]}, steps "
        f"{[round(x, 1) for x in step_ms]} ms, count {int(kstate.count)}, "
        f"factor asymmetry {asym:.2e}; state {state_bytes} bytes; sync save "
        f"{write['bytes']} bytes in {write['seconds']:.2f} s; launches "
        f"{launches} on {card}")
    # 11c
    r3 = runner(out, PHASE2, flags, config)
    if (r3["args"].resume_step, r3["global_step"]) != (KFAC_STEPS,
                                                       KFAC_STEPS):
        raise AssertionError(f"11c resumed at {r3['args'].resume_step}")
    check_same_state("11c resume vs 11a's final state", training_state(r3),
                     training_state(r))
    bad = kfac_state_equal(r3["kfac_state"], kstate)
    recomputed = r3["kfac"].init()
    for field in ("a", "g"):
        for key, value in getattr(r3["kfac_state"], field).items():
            getattr(recomputed, field)[key].copy_(value)
    r3["kfac"].update_inverses(recomputed)
    bad += [f"qa/{key}" for key, value in recomputed.qa.items()
            if not torch.equal(r3["kfac_state"].qa[key], value)]
    if bad:
        raise AssertionError(f"11c: the resumed K-FAC state differs: {bad}")
    log(f"[kfac] 11c resumed ckpt_{KFAC_STEPS} in {r3['resume_s']:.2f} s: "
        "params, mu, nu, factors and count bit-equal, inverses recomputed "
        "from the restored factors")
    batch = training_batches(args, r["config"], 1, seed0=400)[0]
    loss = {label: float(runner_step(x)(batch)["loss"])
            for label, x in (("memory", r), ("resumed", r3))}
    after, after3 = training_state(r), training_state(r3)
    diff = max((a - b).abs().max().item() for n in after if n is not None
               for a, b in zip(after[n], after3[n]))
    bad = kfac_state_equal(r3["kfac_state"], kstate)
    exact = diff == 0.0 and loss["memory"] == loss["resumed"] and not bad
    determinism = dict(kernels_deterministic(), **{
        f"kfac_{name}": same
        for name, same in kfac_deterministic(r, batch).items()})
    log(f"[kfac] 11c one more step: loss {loss}, max |param/moment diff| "
        f"{diff:.3e}, factors differ {bad} (bit-equal {exact}); kernels "
        f"and K-FAC's library calls bit-deterministic {determinism}")
    factor_diff, factor_excess = factor_errors(
        r3["kfac_state"], kstate, KFAC_FACTOR_RTOL, KFAC_FACTOR_ATOL)
    if factor_excess > 0 or diff > RESUME_STEP_ATOL or abs(
            loss["memory"] - loss["resumed"]) > RESUME_STEP_ATOL:
        raise AssertionError(f"resumed K-FAC step off by {diff}, its "
                             f"factors by {factor_diff}")
    resume_s = r3["resume_s"]
    del r3, after, after3, recomputed
    shutil.rmtree(out)
    torch.cuda.empty_cache()
    # 11b
    args.kfac_capture, args.kfac_stats_batch = "stats", KFAC_STATS_BATCH
    stats_step = runner_step(r)
    args.kfac_capture = "train"
    batches = training_batches(args, r["config"], KFAC_STATS_STEPS,
                               seed0=500)
    count0 = int(kstate.count)
    torch.cuda.synchronize()
    zero_counts(kernels)
    stats_losses = [float(stats_step(b)["loss"]) for b in batches]
    stats_launches = {name: k.launches for name, k in kernels.items()}
    per_step = layers * TRAIN_ACCUM
    want = {"flash_attention_fwd": (2 * per_step + layers) * KFAC_STATS_STEPS,
            "flash_attention_dq": (per_step + layers) * KFAC_STATS_STEPS,
            "flash_attention_dkv": (per_step + layers) * KFAC_STATS_STEPS}
    if any(stats_launches[n] != w for n, w in want.items()) or (
            int(kstate.count) != count0 + KFAC_STATS_STEPS) or not all(
            math.isfinite(x) for x in stats_losses):
        raise AssertionError(f"11b stats capture: launches "
                             f"{stats_launches}, expected {want}; count "
                             f"{int(kstate.count)}; losses {stats_losses}")
    log(f"[kfac] 11b stats capture (--kfac_stats_batch {KFAC_STATS_BATCH}): "
        f"losses {stats_losses}, launches {stats_launches} (a fused step's "
        f"+ {layers} forward, dq and dkv per factor-due step)")
    # 11e
    turns = profile_train.kfac_turns(
        args, r["model"], r["optimizer"], r["schedule"], r["config"],
        r["kfac"], kstate, training_batches(args, r["config"], 2,
                                            seed0=600))
    log(f"[kfac] 11e turns (K-FAC, plain, plain, K-FAC; K-FAC = fused "
        f"capture + {layers}-layer Cholesky inverses + precondition every "
        f"step): "
        f"wall {turns['wall_ms']} ms, device {turns['device_ms']} ms; "
        f"capture {turns['capture_ms']:.2f}, inverses "
        f"{turns['inverses_ms']:.2f}, precondition "
        f"{turns['precondition_ms']:.2f} ms device; amortised at the "
        f"default intervals {turns['amortised_default_device_ms']:.2f} ms; "
        f"one factor's Cholesky, cholesky_inverse and eigh by size (ms): "
        f"{turns['linalg_ms']} on {card}")
    del r, kstate
    shutil.rmtree(cut)
    torch.cuda.empty_cache()
    return {"losses": losses, "step_ms": step_ms, "launches": launches,
            "routes": routes, "count": KFAC_STEPS,
            "factor_asymmetry": asym, "state_bytes": state_bytes,
            "checkpoint_write": write, "resume_s": resume_s,
            "resumed_step_bit_equal": exact, "resumed_step_max_diff": diff,
            "determinism": determinism, "stats_launches": stats_launches,
            "stats_losses": stats_losses, "turns": turns,
            "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}


# -- phase 12: fp16 mixed precision ------------------------------------------

# 12a: #6 in fp16 at the SQuAD path's rows (32 x 384) and the pretraining
# path's (8 x 512).
LN_FP16_SHAPES = ((32 * 384, 1024), (8 * 512, 1024))
# 12c: a loss scale far past fp16's range, so the first steps overflow;
# enough steps that the scale backs off to a finite step and trains.
OVERFLOW_SCALE = 2.0 ** 40
OVERFLOW_STEPS = 32
# Its depth, cut from 24 to make room for phase 17 in the smoke's time:
# the scaler, the skips and the save and resume are the same code at any
# depth (the steps are not cut).
OVERFLOW_LAYERS = 6
# 12d: batches tried after the resume until a step trains.
RESUME_TRIES = 4


def check_fp16_kernels() -> tuple:
    """12a: #1-#3 in fp16 against their plain versions (S in SEQS, padded
    and packed, rates 0 and 0.1, both routes; the tensor-core route's
    edges), their keep masks bit for bit, their times beside fp16 SDPA;
    #6 in fp16 against its plain version (one fp16 ulp + LN_OUT_ATOL) and
    its time beside fp16 F.layer_norm. Returns (worst errors, keep-mask
    shares, timed cases, #6's entry)."""
    worst = check_training_kernels(dtypes=(torch.float16,))
    check_training_edges(worst, torch.float16)
    shares = check_keep_masks(torch.float16)
    cases = time_training_kernels(dtypes=(torch.float16,))
    ln = check_and_time_layer_norm(LN_FP16_SHAPES, (torch.float16,), "_fp16")
    return worst, shares, cases, ln


def drive_fp16_overflow(kernels: dict, root: str, card: str) -> dict:
    """12c and 12d at BERT-large phase 2 (S=512, flash, remat dots, LAMB,
    local batch 8 x 2; full width, OVERFLOW_LAYERS layers) in fp16, on the
    runner's own functions and loop
    (telemetry on, every step logged) over SyntheticPretrainingDataset
    rows.

    12c: from --init_loss_scale 2**40, OVERFLOW_STEPS steps. The first
    step overflows: it is skipped (params bit-equal to before it, the
    moments still zero, the inner count 0), the scale halves and a
    sentinel record is written; each overflowing step halves the scale,
    each finite one keeps it and trains (the inner count is the number
    of finite steps, and every non-finite step has its sentinel record),
    until at least 4 steps trained and the last one did. Every step
    launches #1-#3 as phase 6's on the tensor cores.
    12d: the run's final synchronous save (scale and growth count in its
    ``optimizer`` tree) resumes in a fresh runner: params, moments, count,
    scale and growth count bit-equal; one more step from each on the same
    batch agrees bit for bit (phase 9's rule where a kernel is not
    deterministic: RESUME_STEP_ATOL); a step that overflows on both is
    skipped on both, so they go on to the next batch until one trains
    (RESUME_TRIES)."""
    from bert_pytorch_tpu_torch import pretrain
    from bert_pytorch_tpu_torch.optim import transforms
    from bert_pytorch_tpu_torch.tools.make_synthetic_data import (
        SyntheticPretrainingDataset, synthetic_pretraining_batch)
    from bert_pytorch_tpu_torch.utils import checkpoint as ckpt

    free = shutil.disk_usage(root).free
    if free < HANDOFF_DISK_BYTES:
        raise AssertionError(f"phase 12d needs {HANDOFF_DISK_BYTES} bytes of "
                             f"free disk, {free} are free")
    out = os.path.join(root, "fp16")
    jsonl = os.path.join(out, "telemetry.jsonl")
    flags = ["--local_batch_size", str(TRAIN_LOCAL_BATCH),
             "--global_batch_size", str(TRAIN_LOCAL_BATCH * TRAIN_ACCUM),
             "--steps", str(OVERFLOW_STEPS), "--attention_backend", "flash",
             "--dtype", "float16", "--init_loss_scale", str(OVERFLOW_SCALE),
             "--previous_phase_end_step", "0", "--checkpoint_write", "sync",
             "--num_steps_per_checkpoint", str(10 ** 6),
             "--telemetry_jsonl", jsonl]
    cut = os.path.join(root, "fp16_config")
    os.makedirs(cut)
    config = cut_config(cut, num_hidden_layers=OVERFLOW_LAYERS)
    r = runner(out, PHASE2, flags, config)
    model, opt = r["model"], r["optimizer"]
    if not isinstance(opt, transforms.DynamicLossScale) or (
            opt.scale != OVERFLOW_SCALE):
        raise AssertionError(f"fp16 runner optimizer {opt!r}")
    transforms.init_state(opt)  # zero moments, as the JAX init has them
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    first = {}

    def on_step(metrics):
        if first:
            return
        moments = [t for state in opt.state.values() for t in state.values()]
        first.update(
            finite=float(metrics["finite"]),
            loss_scale=float(metrics["loss_scale"]),
            params_equal=all(torch.equal(p, before[n])
                             for n, p in model.named_parameters()),
            moments_zero=not any(bool(t.any()) for t in moments),
            count=transforms.opt_step_count(opt), scale=opt.scale,
            growth_count=opt.growth_count)
        before.clear()

    dataset = SyntheticPretrainingDataset(
        3, TRAIN_LOCAL_BATCH * TRAIN_ACCUM * OVERFLOW_STEPS, TRAIN_SEQ,
        r["config"].vocab_size, r["args"].max_predictions_per_seq)
    torch.cuda.synchronize()
    # Counts to zero just before the main path, read just after.
    zero_counts(kernels)
    summary = train_runner(r, dataset, on_step=on_step)
    launches = {name: k.launches for name, k in kernels.items()}
    routes = {name: dict(k.route_launches) for name, k in kernels.items()
              if hasattr(k, "route_launches")}
    check_launches_per_step(launches, routes, r["config"].num_hidden_layers,
                            TRAIN_ACCUM, OVERFLOW_STEPS)
    want_first = {"finite": 0.0, "loss_scale": OVERFLOW_SCALE,
                  "params_equal": True, "moments_zero": True, "count": 0,
                  "scale": OVERFLOW_SCALE / 2, "growth_count": 0}
    if first != want_first:
        raise AssertionError(f"12c first step {first}; expected {want_first}")
    records = read_records(jsonl)
    train = records.get("train", [])
    scales = [rec["loss_scale"] for rec in train]
    finite = [rec["finite"] for rec in train]
    skipped = finite.index(1.0) if 1.0 in finite else len(finite)
    sentinels = [rec["step"] for rec in records.get("sentinel", [])]
    # The wrapper's rule, step by step: an overflow halves the scale, a
    # finite step keeps it (the growth interval, 2000, is not reached).
    want_scales = [OVERFLOW_SCALE]
    for ok in finite[:-1]:
        want_scales.append(want_scales[-1] * (1.0 if ok == 1.0 else 0.5))
    trained_steps = int(sum(finite))
    first_ok = scales[skipped] if skipped < len(scales) else None
    log(f"[fp16] 12c from scale 2**40: the first {skipped} steps skipped, "
        f"the first finite step at scale {first_ok}, "
        f"{len(train) - trained_steps} skips in all, final scale "
        f"{opt.scale}; losses "
        f"{[round(rec['loss'], 4) for rec in train]}; sentinel records at "
        f"steps {sentinels}; launches {launches} on {card}")
    if (len(train) != OVERFLOW_STEPS or skipped < 1 or scales != want_scales
            or sentinels != [i + 1 for i, ok in enumerate(finite)
                             if ok != 1.0]
            or transforms.opt_step_count(opt) != trained_steps
            or trained_steps < 4 or finite[-1] != 1.0
            or not all(math.isfinite(rec["loss"]) for rec in train)):
        raise AssertionError(
            f"12c: scales {scales}, finite {finite}, sentinels {sentinels}, "
            f"count {transforms.opt_step_count(opt)}")
    # 12d
    write = ckpt.write_records[-1]
    if (write["step"], write["async"]) != (OVERFLOW_STEPS, False):
        raise AssertionError(f"12d: the final save {write}")
    r2 = runner(out, PHASE2, flags, config)
    if r2["global_step"] != OVERFLOW_STEPS:
        raise AssertionError(f"12d resumed at {r2['global_step']}")
    check_same_state("12d resume vs 12c's final state", training_state(r2),
                     training_state(r))
    opt2 = r2["optimizer"]
    if (opt2.scale, opt2.growth_count) != (opt.scale, opt.growth_count):
        raise AssertionError(f"12d scale {opt2.scale} growth "
                             f"{opt2.growth_count}; saved {opt.scale} "
                             f"{opt.growth_count}")
    # One more step from each on the same batch; at this scale a step may
    # overflow (and skip on both), so up to RESUME_TRIES batches in turn
    # until one trains.
    args = r["args"]
    metrics = {"memory": [], "resumed": []}
    for seed in range(78, 78 + RESUME_TRIES):
        batch = pretrain.to_device(pretrain.stack_microbatches(
            synthetic_pretraining_batch(seed, args.global_batch_size,
                                        TRAIN_SEQ, r["config"].vocab_size,
                                        args.max_predictions_per_seq),
            args.accumulation_steps), args.device)
        for label, x in (("memory", r), ("resumed", r2)):
            m = runner_step(x)(batch)
            metrics[label].append((float(m["loss"]), float(m["loss_scale"]),
                                   float(m["finite"])))
        if metrics["memory"][-1][2] == 1.0:
            break
    if metrics["memory"][-1][2] != 1.0:
        raise AssertionError(f"12d: no finite step after the resume in "
                             f"{RESUME_TRIES} tries: {metrics}")
    after, after2 = training_state(r), training_state(r2)
    diff = max((a - b).abs().max().item()
               for n in after if n is not None
               for a, b in zip(after[n], after2[n]))
    exact = (diff == 0.0 and metrics["memory"] == metrics["resumed"]
             and (opt.scale, opt.growth_count)
             == (opt2.scale, opt2.growth_count))
    determinism = kernels_deterministic(torch.float16)
    log(f"[fp16] 12d resumed ckpt_{OVERFLOW_STEPS} ({write['bytes']} bytes, "
        f"written in {write['seconds']:.2f} s) in {r2['resume_s']:.2f} s: "
        f"state, scale and growth count bit-equal; then each step until one "
        f"trained (loss, scale, finite) {metrics}, max "
        f"|param/moment diff| {diff:.3e} (bit-equal {exact}); fp16 kernels "
        f"bit-deterministic {determinism} on {card}")
    if not exact and all(determinism.values()):
        raise AssertionError("the resumed fp16 step differs from the "
                             "in-memory one although every kernel is "
                             "deterministic")
    if not exact and (diff > RESUME_STEP_ATOL or any(
            abs(a[0] - b[0]) > RESUME_STEP_ATOL or a[1:] != b[1:]
            for a, b in zip(metrics["memory"], metrics["resumed"]))):
        raise AssertionError(f"resumed fp16 step off by {diff}")
    step_ms = [(b - a) * 1e3 for a, b in summary["step_times"]]
    resume_s = r2["resume_s"]
    del r, r2, model, opt, opt2, after, after2
    shutil.rmtree(out)
    shutil.rmtree(cut)
    torch.cuda.empty_cache()
    return {"launches": launches, "routes": routes, "first_step": first,
            "first_skipped": skipped, "trained_steps": trained_steps,
            "loss_scales": scales, "finite": finite,
            "sentinel_steps": sentinels,
            "losses": [rec["loss"] for rec in train], "step_ms": step_ms,
            "save": write, "resume_s": resume_s,
            "resumed_step": metrics, "resumed_step_bit_equal": exact,
            "resumed_step_max_diff": diff, "determinism": determinism}

# -- phase 13: the debug planes ----------------------------------------------

# 13a: a replica with its planes at BERT-large width (fill_mask and
# classify, the same seeded random weights for both services) and the same
# engine behind a service without any, served phase 5a's waves in turns;
# then a POST /profilez capture over one wave. 13b: a run_server
# subprocess drained by SIGTERM mid-wave.
DEBUG_TASKS = ("fill_mask", "classify")
# #4's kernel symbols, on either route.
INFER_TRACE_KERNEL = re.compile(r"flash_infer_(wgmma_)?kernel")
CAPTURE_S = 2.0
# 13a's turns, planes off and on in a balanced order, each serving the
# waves TURN_REPEATS times.
TURNS = ("off", "on", "on", "off", "on", "off", "off", "on")
TURN_REPEATS = 3
# Seconds a BERT-large replica subprocess may take to answer /healthz (an
# interpreter, two heads' random init and the warmup forwards).
REPLICA_START_S = 300


def debug_waves() -> list:
    """Phase 5a's waves, cut to the two heads phase 13 serves."""
    return [[tp for tp in wave if tp[0] in DEBUG_TASKS]
            for wave in request_waves()]


def serve_http(service) -> tuple:
    """Start ``service`` and an HTTP server on it: (server, thread)."""
    from bert_pytorch_tpu_torch.serve import make_server

    service.start()
    server = make_server(service, port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    return server, thread


def stop_http(service, server, thread) -> None:
    server.shutdown()
    server.server_close()
    service.stop()
    thread.join(timeout=30)


def wave_latencies(port: int, waves: list, labels) -> list:
    """Each wave's requests sent concurrently, every answer 200 and well
    formed: the requests' latencies in seconds."""
    out = []
    for wave in waves:
        with ThreadPoolExecutor(max_workers=len(wave)) as pool:
            got = list(pool.map(lambda tp: post(port, *tp), wave))
        for (task, payload), (status, body, _) in zip(wave, got):
            if status != 200:
                raise AssertionError(f"{task} answered {status}: {body}")
            check_body(task, payload, body, labels)
        out += [seconds for _, _, seconds in got]
    return out


def latency_line(seconds: list) -> dict:
    ordered = sorted(seconds)
    return {"p50_ms": statistics.median(ordered) * 1e3,
            "max_ms": ordered[-1] * 1e3, "requests": len(ordered)}


def watch_window(window, engine, kernel) -> dict:
    """Wrap a capture's trace window so each begin and end notes #4's
    launch count and the engine's forwards just before and just after."""
    marks: dict = {}
    begin, end = window.begin, window.end

    def snap(label):
        marks[label] = (kernel.launches, engine.forwards)

    def watched_begin(trace_dir=None):
        snap("begin0")
        ok = begin(trace_dir)
        snap("begin1")
        return ok

    def watched_end(sync_target=None):
        snap("end0")
        ok = end(sync_target)
        snap("end1")
        return ok

    window.begin, window.end = watched_begin, watched_end
    return marks


def wait_for(port: int, pred, what: str, timeout_s: float = 60.0) -> dict:
    """Poll /statsz until ``pred(statsz)``."""
    deadline = time.perf_counter() + timeout_s
    while time.perf_counter() < deadline:
        stats = get(port, "/statsz")
        if pred(stats):
            return stats
        time.sleep(0.02)
    raise AssertionError(f"/statsz never showed {what}")


def capture_wave(service, port: int, wave: list, labels, kernel) -> dict:
    """POST /profilez (CAPTURE_S), wait until the capture is active, serve
    ``wave``, wait until it is collected, and count #4's kernel events in
    its trace: at least the launches made between its begin and end, at
    most those made from just before its begin to just after its end, and
    24 per forward when no forward straddled either. A trace that lost
    events is captured again over the same wave (DEVICE_TIME_TRIES)."""
    from bert_pytorch_tpu_torch.tools.profile_train import (kernel_rows,
                                                            load_trace)

    layers = service.engine.config.num_hidden_layers
    marks = watch_window(service.capture.window, service.engine, kernel)
    for attempt in range(DEVICE_TIME_TRIES):
        done = service.capture.status()["captures"]
        status, armed, _ = post(port, "", {"duration_s": CAPTURE_S},
                                path="/profilez")
        if status != 200:
            raise AssertionError(f"/profilez answered {status}: {armed}")
        again = post(port, "", {}, path="/profilez")[0]
        if again != 409:
            raise AssertionError(f"a second /profilez answered {again}")
        wait_for(port, lambda s: s["profile"]["phase"] == "active",
                 "an active capture")
        latencies = wave_latencies(port, [wave], labels)
        stats = wait_for(port, lambda s: s["profile"]["captures"] > done,
                         "the capture collected")
        last = stats["profile"]["last"]
        rows = kernel_rows(load_trace(os.path.join(
            last["trace_path"], f"trace_{os.getpid()}.json")))
        traced = sum(n for name, _, n in rows
                     if INFER_TRACE_KERNEL.search(name))
        kernel_ms = sum(ms for name, ms, _ in rows
                        if INFER_TRACE_KERNEL.search(name))
        lo = marks["end0"][0] - marks["begin1"][0]
        hi = marks["end1"][0] - marks["begin0"][0]
        if 0 < lo <= traced <= hi:
            break
        log(f"[warn] capture {attempt + 1} of {DEVICE_TIME_TRIES}: {traced} "
            f"#4 kernel events in the trace, {lo}-{hi} launches in its "
            f"window; marks {marks}")
    else:
        raise AssertionError(f"the capture's trace holds {traced} #4 kernel "
                             f"events for {lo}-{hi} launches")
    forwards = marks["end0"][1] - marks["begin1"][1]
    quiet = (marks["begin0"] == marks["begin1"]
             and marks["end0"] == marks["end1"])
    if quiet and traced != layers * forwards:
        raise AssertionError(f"{traced} #4 kernel events for {forwards} "
                             f"forwards of {layers} layers")
    return {"latencies": latencies, "traced_launches": traced,
            "launches_in_window": [lo, hi], "forwards_in_window": forwards,
            "traced_kernel_ms": kernel_ms, "last": last,
            "attempts": attempt + 1}


def drive_debug_planes(vocab: str, root: str, kernels: dict,
                       card: str) -> dict:
    """Phase 13a. ``run_server.build_service`` with ``--output_dir`` (the
    JSONL sink teed into the flight recorder, the heartbeat, the capture
    controller, the compile monitor) at BERT-large width, and a service
    without any of them on the same engine; phase 5a's waves (fill_mask
    and classify) through each in TURNS, then a
    ``POST /profilez`` capture over the short wave on the replica. Checks
    the warmup's compile records (no cold build: one hit for the one
    library the engine runs), #4 once per layer per forward on the tensor
    cores over the phase, the capture's trace against the launches its
    window saw, the heartbeat's progress, the profile_window record and
    the JSONL against the schema."""
    from bert_pytorch_tpu_torch import run_server
    from bert_pytorch_tpu_torch.serve import (Batcher, ServeTelemetry,
                                              ServingService)
    from bert_pytorch_tpu_torch.serve.cli import build_tracer
    from bert_pytorch_tpu_torch.telemetry import Heartbeat, schema

    out = os.path.join(root, "replica_13a")
    args = serve_args(vocab, "bfloat16", "flash_infer", ",".join(DEBUG_TASKS),
                      ["--output_dir", out, "--telemetry_window", "16"])
    on = run_server.build_service(args)
    engine = on.engine
    on.compile_monitor.install()
    try:
        engine.warmup()
    finally:
        on.compile_monitor.uninstall()
    startup = engine.startup
    libraries = engine.kernel_libraries()
    if (startup["compiles_cold"], startup["compiles_warm"],
            libraries) != (0, 1, ("flash_attention_infer",)):
        raise AssertionError(f"13a startup {startup}, libraries {libraries}: "
                             "expected no cold build and one hit")
    off = ServingService(engine, Batcher(
        max_batch_size=args.max_batch_size, max_wait_ms=args.max_wait_ms,
        max_requests_per_pack=engine.max_requests_per_pack),
        ServeTelemetry(), tracer=build_tracer(args))
    labels = args.classify_labels.split(",")
    waves = debug_waves()
    # Counts to zero just before the main path, read just after.
    zero_counts(kernels)
    engine.forwards = 0
    turns = []
    running = {name: (svc,) + serve_http(svc)
               for name, svc in (("off", off), ("on", on))}
    beat0 = Heartbeat.read(os.path.join(out, "heartbeat.json"))
    try:
        for name in ("off", "on"):  # untimed: each server's first waves
            wave_latencies(running[name][1].server_address[1], waves, labels)
        for name in TURNS:
            port = running[name][1].server_address[1]
            t0 = time.perf_counter()
            seconds, short = [], []
            for _ in range(TURN_REPEATS):
                got = wave_latencies(port, waves, labels)
                seconds += got
                short += got[:len(waves[0])]
            turns.append(dict(latency_line(seconds), planes=name,
                              wall_s=time.perf_counter() - t0,
                              short_wave=latency_line(short)))
        captured = capture_wave(on, running["on"][1].server_address[1],
                                waves[0], labels,
                                kernels["flash_attention_infer"])
    finally:
        for svc, server, thread in running.values():
            stop_http(svc, server, thread)
        run_server.close_planes(on)
    launches = {name: k.launches for name, k in kernels.items()}
    routes = {name: dict(k.route_launches) for name, k in kernels.items()
              if hasattr(k, "route_launches")}
    served = {"launches": launches, "routes": routes,
              "forwards": engine.forwards,
              "layers": engine.config.num_hidden_layers}
    check_launches(served, "flash_attention_infer", ("layer_norm_fwd",))
    beat1 = Heartbeat.read(os.path.join(out, "heartbeat.json"))
    requests = on.telemetry.request_count()
    if not (beat0 and beat1 and beat1["counter"] > beat0["counter"]
            and beat1["step"] == requests):
        raise AssertionError(f"13a heartbeat {beat0} -> {beat1} for "
                             f"{requests} requests")
    jsonl = os.path.join(out, "serve_telemetry.jsonl")
    errors = schema.validate_file(jsonl)
    kinds = read_records(jsonl)
    compiles = kinds.get("compile", [])
    windows = kinds.get("profile_window", [])
    if errors or [(c["fn"], c["cache"]) for c in compiles] != [
            ("flash_attention_infer", "hit")] or len(windows) != \
            captured["attempts"]:
        raise AssertionError(f"13a JSONL: {errors[:5]}, compile records "
                             f"{compiles}, profile windows {windows}")
    window = windows[-1]
    if (window["source"], window["covered_unit"], window["trace_path"]) != (
            "replica", "requests", captured["last"]["trace_path"]) or \
            window["covered"] < len(waves[0]) or not window["trace_bytes"]:
        raise AssertionError(f"13a profile_window {window}")
    if os.path.exists(os.path.join(out, "postmortem.json")):
        raise AssertionError("13a: a clean close left postmortem.json")
    on_p50 = [t["p50_ms"] for t in turns if t["planes"] == "on"]
    off_p50 = [t["p50_ms"] for t in turns if t["planes"] == "off"]
    short_on = [t["short_wave"] for t in turns if t["planes"] == "on"]
    log(f"[debug 13a] telemetry cost, phase 5a's waves ({len(waves[0])} + "
        f"{len(waves[1])} requests, {TURN_REPEATS} times a turn; "
        f"{', '.join(TURNS)}): "
        + "; ".join(f"{t['planes']} p50 {t['p50_ms']:.2f} ms max "
                    f"{t['max_ms']:.2f} ms" for t in turns)
        + f"; median p50 on {statistics.median(on_p50):.2f} ms, off "
        f"{statistics.median(off_p50):.2f} ms on {card}")
    cap = latency_line(captured["latencies"])
    log(f"[debug 13a] capture over the short wave: p50 {cap['p50_ms']:.2f} ms "
        f"max {cap['max_ms']:.2f} ms (the same wave in the 'on' turns: p50 "
        f"{[round(t['p50_ms'], 2) for t in short_on]} ms, max "
        f"{[round(t['max_ms'], 2) for t in short_on]} ms); trace "
        f"{window['trace_bytes']} bytes, {captured['traced_launches']} #4 "
        f"kernel events ({captured['traced_kernel_ms']:.3f} ms) for "
        f"{captured['launches_in_window']} launches over "
        f"{captured['forwards_in_window']} forwards in its window, "
        f"{window['samples']} host samples, covered {window['covered']} "
        f"requests in {window['duration_s']} s; heartbeat counter "
        f"{beat0['counter']} -> {beat1['counter']}; startup {startup} on "
        f"{card}")
    return {"turns": turns, "capture": dict(
                cap, trace_bytes=window["trace_bytes"],
                traced_launches=captured["traced_launches"],
                launches_in_window=captured["launches_in_window"],
                forwards_in_window=captured["forwards_in_window"],
                samples=window["samples"], covered=window["covered"],
                attempts=captured["attempts"]),
            "launches": launches, "routes": routes,
            "forwards": engine.forwards, "startup": startup,
            "heartbeat": [beat0, beat1]}


def post_or_error(port: int, task: str, payload: dict) -> tuple:
    """:func:`post`, with a refused or reset connection as (None, error)."""
    try:
        return post(port, task, payload)
    except (OSError, http.client.HTTPException) as exc:
        return None, repr(exc), 0.0


def free_port() -> int:
    import socket

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def drive_replica_drain(vocab: str, root: str, card: str) -> dict:
    """Phase 13b: ``python -m bert_pytorch_tpu_torch.run_server`` at
    BERT-large width with ``--output_dir``, phase 5a's waves sent at once,
    SIGTERM as the first answer arrives. The replica must exit 75; every
    request it accepted answers 200 (the others are refused with 503 or a
    closed connection), the JSONL carries the preemption ``fault`` record
    and a serve_summary counting the answers, and postmortem.json keeps
    the fault record."""
    from concurrent.futures import as_completed

    from bert_pytorch_tpu_torch.telemetry import schema
    from bert_pytorch_tpu_torch.telemetry.flightrec import read_postmortem

    out = os.path.join(root, "replica_13b")
    port = free_port()
    cmd = [sys.executable, "-m", "bert_pytorch_tpu_torch.run_server",
           "--model_config_file", CONFIG, "--vocab_file", vocab,
           "--tasks", ",".join(DEBUG_TASKS), "--buckets", "128,512",
           "--max_batch_size", "8", "--pack_requests", "--port", str(port),
           "--trace_sample_rate", "0", "--output_dir", out]
    log_path = os.path.join(root, "replica_13b.log")
    t0 = time.perf_counter()
    with open(log_path, "w") as log_file:
        proc = subprocess.Popen(cmd, cwd=REPO, stdout=log_file,
                                stderr=subprocess.STDOUT)
    try:
        while True:
            try:
                get(port, "/healthz")
                break
            except OSError:
                if proc.poll() is not None or \
                        time.perf_counter() - t0 > REPLICA_START_S:
                    raise AssertionError(
                        f"13b replica did not start (rc {proc.poll()}): "
                        + open(log_path).read()[-3000:])
                time.sleep(0.5)
        start_s = time.perf_counter() - t0
        requests = [tp for wave in debug_waves() for tp in wave]
        with ThreadPoolExecutor(max_workers=len(requests)) as pool:
            futures = [pool.submit(post_or_error, port, *tp)
                       for tp in requests]
            next(as_completed(futures))
            t_term = time.perf_counter()
            proc.send_signal(signal.SIGTERM)
            results = [f.result() for f in futures]
        rc = proc.wait(timeout=300)
        drain_s = time.perf_counter() - t_term
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    output = open(log_path).read()
    if rc != 75:
        raise AssertionError(f"13b replica exited {rc}, not 75: "
                             + output[-3000:])
    codes = {}
    for (task, payload), (status, body, _) in zip(requests, results):
        codes[status] = codes.get(status, 0) + 1
        if status == 200:
            check_body(task, payload, body, ["0", "1"])
        elif status not in (503, None):
            raise AssertionError(f"13b {task} answered {status}: {body}")
    jsonl = os.path.join(out, "serve_telemetry.jsonl")
    errors = schema.validate_file(jsonl)
    kinds = read_records(jsonl)
    faults = kinds.get("fault", [])
    summary = (kinds.get("serve_summary") or [{}])[-1]
    pm = read_postmortem(os.path.join(out, "postmortem.json"))
    if (errors or [(f["fault"], f["signal"]) for f in faults] != [
            ("preemption", "SIGTERM")] or not codes.get(200)
            or summary.get("requests") != codes[200]
            or summary.get("errors", 0) != 0):
        raise AssertionError(f"13b JSONL: {errors[:5]}, faults {faults}, "
                             f"summary {summary}, answers {codes}")
    if pm is None or pm["reason"] != "fault:preemption" or not any(
            r.get("kind") == "fault" for r in pm["records"]):
        raise AssertionError(f"13b postmortem: {pm and pm['reason']}")
    if "0 cold kernel builds / 1 already built" not in output:
        raise AssertionError("13b: the replica's warmup line names a cold "
                             "build: " + output[-2000:])
    log(f"[debug 13b] run_server subprocess answered /healthz {start_s:.1f} s "
        f"after its start; SIGTERM after the first answer: rc {rc} in "
        f"{drain_s:.2f} s, answers by status {codes}, fault record at "
        f"request {faults[0]['step']}, serve_summary requests "
        f"{summary['requests']}, postmortem {pm['reason']} with "
        f"{len(pm['records'])} records and {len(pm['lines'])} log lines on "
        f"{card}")
    return {"rc": rc, "start_s": start_s, "drain_s": drain_s,
            "answers": {str(k): v for k, v in codes.items()},
            "fault_step": faults[0]["step"],
            "postmortem_records": len(pm["records"])}


# -- phase 14: the serving fleet -----------------------------------------------
# The port's chaos harness (bert_pytorch_tpu_torch/tools/chaos_serve.py, a
# torch-free parent) drives a fleet of run_server replicas on the card at
# BERT-large width: 14a --smoke (SIGKILL in admission, wedge, kill mid-drain,
# kill mid-swap, a /profilez capture under a steady burst), 14b --canary
# (publish, canary, promote, breach -> rollback), 14c --surge (scale-up under
# a burst, SIGKILL mid-surge, scale-down). Each mode has its own
# --compile_cache_dir: 14a's starts empty, and its first replicas build
# flash_attention_infer once between them (the build lock); 14b's and 14c's
# start with a copy of that build (a cold nvcc is ~13-16 s a mode); every
# later start and swap builds nothing.
FLEET_ARGS = ("--device", "cuda", "--dtype", "bfloat16",
              "--attention_backend", "flash_infer", "--buckets", "128",
              "--max_batch_size", "8")
# The replicas' depth, cut from BERT-large's 24 to make room for phase 20
# (width stays BERT-large's): the supervisor, router, autoscaler, swaps,
# kills and the capture are the same code at any depth; a replica's start
# and forward are what shrink.
FLEET_LAYERS = 6
# Burst sizes cut from the JAX harness's defaults to keep phase 14 near
# 240 s (width and depth stay BERT-large's): phase A 50 -> 40 requests,
# phase C 30 -> 24, phase D 24 -> 16, the surge's recovery burst 60 -> 40.
# The surge's down cooldown (counted from the scale-up) is 30 s, not 6: it
# must outlast the elastic replica's start, the seed's SIGKILL and
# respawn and the recovery burst, or green windows read during the
# respawn shrink the fleet before the recovery burst has run.
# 14a's capture is /profilez's default length (telemetry/sampler.py
# DEFAULT_DURATION_S, 2 s).
FLEET_MODES = (
    ("14a", ("--smoke", "--phase_a_requests", "40", "--phase_c_requests",
             "24", "--phase_d_requests", "16", "--profile_s", "2")),
    ("14b", ("--canary",)),
    ("14c", ("--surge", "--surge_recovery_requests", "40",
             "--surge_down_cooldown_s", "30")),
)
FLEET_TIMEOUT_S = 420
CHAOS_SERVE = os.path.join(REPO, "bert_pytorch_tpu_torch", "tools",
                           "chaos_serve.py")
GIB = 1 << 30


def run_chaos(label: str, mode_args, workdir: str, config: str) -> tuple:
    """One chaos_serve mode as a subprocess in its own process group (its
    replicas with it, so a timeout stops them all) serving the model
    config ``config``; returns (verdict, the card's least free memory
    while it ran, read each second, seconds)."""
    cmd = [sys.executable, CHAOS_SERVE, *mode_args, *FLEET_ARGS,
           "--model_config_file", config, "--workdir", workdir]
    t0 = time.perf_counter()
    least_free = torch.cuda.mem_get_info()[0]
    proc = subprocess.Popen(cmd, cwd=REPO, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True,
                            start_new_session=True)
    while True:
        try:
            out, err = proc.communicate(timeout=1.0)
            break
        except subprocess.TimeoutExpired:
            least_free = min(least_free, torch.cuda.mem_get_info()[0])
            if time.perf_counter() - t0 > FLEET_TIMEOUT_S:
                os.killpg(proc.pid, signal.SIGKILL)
                out, err = proc.communicate()
                raise AssertionError(f"{label}: chaos_serve ran past "
                                     f"{FLEET_TIMEOUT_S} s:\n{err[-4000:]}")
    seconds = time.perf_counter() - t0
    lines = out.strip().splitlines()
    verdict = json.loads(lines[-1]) if lines else {}
    if proc.returncode != 0 or not verdict.get("ok"):
        logs = ""
        for name in sorted(os.listdir(workdir)):
            if name.endswith(".log"):
                with open(os.path.join(workdir, name), errors="replace") as f:
                    logs += f"--- {name}\n{f.read()[-3000:]}\n"
        # The verdict and its error come last: a reader of the end of the
        # output sees which check failed, after the logs that explain it.
        raise AssertionError(f"{label}: chaos_serve rc {proc.returncode}\n"
                             f"{err[-4000:]}\n{logs}\n{label}: verdict "
                             f"{verdict}\n{label}: error "
                             f"{verdict.get('error')}")
    return verdict, least_free, seconds


def check_fleet_capture(workdir: str, profile: dict, layers: int) -> dict:
    """14a's ``/profilez`` capture on replica 0: the trace must hold 24 #4
    kernel events per forward of its window (the ``serve_forward`` ranges
    it holds), at least one forward, and no more #4 events than the
    launches the replica counted from just before the POST to just after
    the capture was collected; the replica's compile records must name
    flash_attention_infer."""
    from bert_pytorch_tpu_torch.tools.profile_train import (kernel_rows,
                                                            load_trace)

    path = os.path.join(profile["last"]["trace_path"],
                        f"trace_{profile['pid']}.json")
    events = load_trace(path)
    rows = kernel_rows(events)
    traced = sum(n for name, _, n in rows if INFER_TRACE_KERNEL.search(name))
    forwards = sum(1 for e in events
                   if e.get("name") == "serve_forward"
                   and e.get("cat") == "user_annotation")
    before, after = profile["kernel_launches"]
    launched = (after["flash_attention_infer"]
                - before["flash_attention_infer"])
    if not (forwards > 0 and traced == layers * forwards
            and traced <= launched):
        raise AssertionError(f"14a capture: {traced} #4 kernel events for "
                             f"{forwards} forwards of {layers} layers, "
                             f"{launched} launches around its window")
    builds = [r for r in read_jsonl(os.path.join(
        workdir, "replica_0", "serve_telemetry.jsonl"))
        if r.get("kind") == "compile"]
    if not any(r["fn"] == "flash_attention_infer" for r in builds):
        raise AssertionError(f"14a: replica 0's compile records {builds}")
    return {"traced_launches": traced, "forwards_in_trace": forwards,
            "launches_around_window": launched,
            "trace_bytes": profile["last"]["trace_bytes"],
            "duration_s": profile["last"]["duration_s"],
            "wall_s": profile["wall_s"],
            "polls_timed_out": profile["polls_timed_out"],
            "compile_records": [(r["fn"], r["cache"]) for r in builds]}


def read_jsonl(path: str) -> list:
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def drive_fleet(root: str, card: str, layers: int = FLEET_LAYERS) -> dict:
    """Phase 14: chaos_serve's three modes on the card (FLEET_MODES),
    each held to its own verdict and to the checks below; the card's free
    memory must come back to within 1 GiB of its value before the phase
    once every fleet has stopped. The replicas run BERT-large's width at
    ``layers`` layers."""
    config_dir = os.path.join(root, "fleet_config")
    os.makedirs(config_dir, exist_ok=True)
    config = cut_config(config_dir, num_hidden_layers=layers)
    torch.cuda.empty_cache()
    free0 = torch.cuda.mem_get_info()[0]
    t0 = time.perf_counter()
    out = {}
    # 14a's replicas build #4 cold under the lock; 14b and 14c start from
    # a compile dir seeded with that build, so no later replica runs nvcc.
    seed = os.path.join(root, "fleet_built")
    os.makedirs(seed, exist_ok=True)
    for label, mode_args in FLEET_MODES:
        workdir = os.path.join(root, f"fleet_{label}")
        first = not os.listdir(seed)
        if not first:
            shutil.copytree(seed, os.path.join(workdir, "compile_cache"))
        verdict, least_free, seconds = run_chaos(label, mode_args, workdir,
                                                 config)
        builds = verdict.get("first_builds")
        launches = verdict.get("kernel_launches", {}).get(
            "flash_attention_infer", 0)
        if builds != ({"flash_attention_infer": 1} if first else {}) or (
                launches <= 0):
            raise AssertionError(f"{label}: first builds {builds}, #4 "
                                 f"launches {launches}")
        if first:
            cache = os.path.join(workdir, "compile_cache")
            for name in os.listdir(cache):
                if name.endswith(".so"):
                    shutil.copy(os.path.join(cache, name), seed)
        if label == "14a":
            if not (verdict["phase_a"]["admit_hold_observed"]
                    and verdict["drain"]["rcs"]["0"] == 75
                    and verdict["restart_compiles_cold"] == 0
                    and verdict["phase_d"]["torn_serves"] == 0
                    and verdict["phase_d"]["swap_compiles_cold"] == 0
                    and verdict["trace"]["orphans"] == 0
                    and verdict["trace"]["stitches"]
                    == verdict["trace"]["router_traces"]):
                raise AssertionError(f"14a verdict {verdict}")
            verdict["capture"] = check_fleet_capture(
                workdir, verdict["profile"], layers)
        elif label == "14b":
            if (verdict["torn_serves"] != 0
                    or verdict["report_gate"] != {"breach_rc": 1,
                                                  "clean_rc": 0}):
                raise AssertionError(f"14b verdict {verdict}")
        elif (verdict["elastic_compiles_cold"] != 0
              or verdict["report_gate"] != {"breach_rc": 1, "clean_rc": 0}):
            raise AssertionError(f"14c verdict {verdict}")
        verdict.update(least_free_bytes=least_free, seconds=round(seconds, 1))
        out[label] = verdict
        log(f"[fleet {label}] {' '.join(mode_args)}: ok in {seconds:.1f} s; "
            f"start {verdict.get('startup_s')} s, first builds {builds}, #4 "
            f"launches {launches}, the final replicas' peak reserved bytes "
            f"{verdict['max_reserved_bytes']}, the card's free bytes "
            f"{free0} before phase 14, {least_free} at the least while "
            f"{label} ran, on {card}")
        shutil.rmtree(workdir, ignore_errors=True)
    torch.cuda.empty_cache()
    free1 = torch.cuda.mem_get_info()[0]
    if free1 < free0 - GIB:
        raise AssertionError(f"the card's free memory did not come back: "
                             f"{free0} bytes before phase 14, {free1} after")
    smoke, canary, surge = out["14a"], out["14b"], out["14c"]
    summary = {
        "seconds": round(time.perf_counter() - t0, 1),
        "free_bytes": [free0, free1],
        "launches_fleet": sum(v["kernel_launches"]["flash_attention_infer"]
                              for v in out.values()),
        "modes": out,
    }
    log(f"[fleet] phase 14 in {summary['seconds']} s on {card}: start "
        f"(cold build) {smoke['startup_s']} s, restart after SIGKILL "
        f"{smoke['phase_a']['recovery_s']} s, failover p95 "
        f"{smoke['router']['failover_p95_ms']} ms, router overhead p50 "
        f"{smoke['router_overhead']}, swap_all {smoke['phase_d']['swap_all_s']}"
        f" s (load {smoke['phase_d']['swap_load_s']} s), canary swaps "
        f"{canary['swap_load_s']} s, warm scale-up {surge['scale_up_s']} s, "
        f"14a capture {smoke['capture']}, free memory {free0} -> {free1} "
        f"bytes")
    return summary


# -- phase 15: the feed of a long pretraining run -----------------------------

# Phase 6's shape (S=512, max_pred 80, remat dots, LAMB, flash, bf16, local
# batch 8 x 2) through run_pretraining.main over SyntheticPretrainingDataset
# rows: FEED_STEPS steps a run, a held-out pass every FEED_EVERY steps of
# FEED_EVAL_BATCHES batches, the kill cycle's saves every FEED_EVERY steps.
FEED_STEPS, FEED_EVERY, FEED_EVAL_BATCHES = 6, 2, 4
FEED_DATA_SEED, FEED_VAL_SEED = 15, 16
# BERT-large's vocab padded to a multiple of 8 (the runner's rule) and the
# phase-2 recipe's max_pred.
FEED_VOCAB, FEED_MAX_PRED = 30528, 80
# 15a traces steps 2 and 3 (step-in-run terms). The producer stages a
# batch before it blocks on the full queue, so the copies of batch N + 3
# are issued as step N begins: batch 6's, at step 3, inside the window.
FEED_PROFILE_STEPS = "2:4"
# The untraced runs in order, (depth, --telemetry_cost_analysis): the
# prefetch pair under one mode, then the counter's pair at prefetch 0.
FEED_UNTRACED_RUNS = (("2", "auto"), ("0", "auto"), ("0", "off"))
# The traced pair's depth (PR 17 cut it from 24 to make room for phase
# 17): the prefetcher's copies, its stream and the trace are the same at
# any depth; the untraced pair and 15c keep BERT-large's 24.
FEED_TRACED_LAYERS = 6
FEED_WINDOW = 3
FEED_WORKERS = 2
FEED_NONFINITE_AT, FEED_KILL_AT = 3, 4
# The kill cycle's depth, cut from 24 to make room for phase 16 in the
# smoke's time: its two sync saves, the walk-back and the resume are the
# same code at any depth (1.31 GB a save instead of 4.03).
FEED_KILL_LAYERS = 6
# Two retained 6-layer LAMB states (1.31 GB each) and headroom.
FEED_DISK_BYTES = 6 * 2 ** 30
FEED_CHILD_TIMEOUT_S = 300
# The arrays of an unpacked batch: ids, segments, mask, labels, NSP.
FEED_ARRAYS = 5
# A pinned host buffer copied to the card, by the name kineto gives it.
PINNED_HTOD = re.compile(r"Memcpy HtoD \(Pinned -> Device\)")
FEED_CHILD = ("import sys; sys.path.insert(0, sys.argv[1]); "
              "import chip_smoke; sys.exit(chip_smoke.feed_child("
              "sys.argv[2:]))")


def feed_dataset(seed: int = FEED_DATA_SEED, rows: int = None):
    """The phase's seeded synthetic rows (a 6-step epoch by default)."""
    from bert_pytorch_tpu_torch.tools.make_synthetic_data import (
        SyntheticPretrainingDataset)

    rows = rows or TRAIN_LOCAL_BATCH * TRAIN_ACCUM * FEED_STEPS
    return SyntheticPretrainingDataset(seed, rows, TRAIN_SEQ, FEED_VOCAB,
                                       FEED_MAX_PRED)


def feed_argv(out: str, extra=(), config: str = CONFIG) -> list:
    """The runner's command line for phase 15: the phase-2 recipe at
    BERT-large width (``config``), FEED_STEPS steps, no saves unless
    ``extra`` asks, saves numbered from 0."""
    return ["--output_dir", out, "--config_file", PHASE2,
            "--model_config_file", config,
            "--local_batch_size", str(TRAIN_LOCAL_BATCH),
            "--global_batch_size", str(TRAIN_LOCAL_BATCH * TRAIN_ACCUM),
            "--steps", str(FEED_STEPS), "--attention_backend", "flash",
            "--dtype", "bfloat16", "--device", "cuda", "--seed", "0",
            "--log_steps", "1", "--skip_final_checkpoint",
            "--num_steps_per_checkpoint", "1000",
            "--previous_phase_end_step", "0", *extra]


def feed_child(argv) -> int:
    """A child of 15d's kill cycle: ``run_pretraining.main`` on the
    phase's rows (a process of its own, so ``die@N`` can SIGKILL it)."""
    from bert_pytorch_tpu_torch import run_pretraining

    summary = run_pretraining.main(run_pretraining.parse_arguments(argv),
                                   feed_dataset())
    return 0 if summary.get("finite", 1.0) == 1.0 else 1


def feed_records(out: str) -> list:
    """The run's JSONL, schema-clean, as records."""
    from bert_pytorch_tpu_torch.telemetry import schema

    path = os.path.join(out, "pretraining_telemetry.jsonl")
    errors = schema.validate_file(path)
    if errors:
        raise AssertionError(f"{path}: {errors[:5]}")
    with open(path, encoding="utf-8") as f:
        return [json.loads(line) for line in f]


def train_losses(records: list) -> dict:
    return {r["step"]: r["loss"] for r in records if r.get("tag") == "train"}


def feed_main(kernels: dict, out: str, extra=(), dataset=None,
              val_dataset=None, config: str = CONFIG) -> dict:
    """``run_pretraining.main`` from a fresh directory, the launch counts
    zeroed just before and read just after; its records and losses."""
    import gc

    from bert_pytorch_tpu_torch import run_pretraining

    args = run_pretraining.parse_arguments(feed_argv(out, extra, config))
    torch.cuda.synchronize()
    zero_counts(kernels)
    t0 = time.perf_counter()
    summary = run_pretraining.main(args, dataset or feed_dataset(),
                                   val_dataset)
    wall = time.perf_counter() - t0
    launches = {name: k.launches for name, k in kernels.items()}
    allocator_peak = torch.cuda.max_memory_allocated()
    gc.collect()
    torch.cuda.empty_cache()
    records = feed_records(out)
    return {"summary": summary, "launches": launches, "records": records,
            "losses": train_losses(records), "wall_s": wall,
            "allocator_peak": allocator_peak,
            "windows": [r for r in records
                        if r.get("kind") == "step_window"]}


def cost_records(label: str, records: list, fns, mode: str = "auto"
                 ) -> dict:
    """fn -> (compile, compile_cost or None) of a run's records: every
    instrumented function in ``fns`` has its compile record and, unless
    ``mode`` is off, its compile_cost record on the same shapes_digest
    (``"counted_allocator"`` with temp_bytes under full); raises on a
    gap, so a silent one cannot pass."""
    compiles = {r["fn"]: r for r in records if r.get("kind") == "compile"}
    costs = {(r["fn"], r["shapes_digest"]): r for r in records
             if r.get("kind") == "compile_cost"}
    out = {}
    for fn in fns:
        rec = compiles.get(fn)
        cost = rec and costs.get((fn, rec["shapes_digest"]))
        want = {"off": None, "auto": "counted",
                "full": "counted_allocator"}[mode]
        got = cost and cost["analysis"]
        if (rec is None or got != want or (cost is not None and not (
                cost["flops"] > 0 and cost["argument_bytes"] > 0))
                or (mode == "full" and not cost["temp_bytes"] > 0)):
            raise AssertionError(f"{label}: {fn}'s compile record {rec}, "
                                 f"compile_cost {cost} under {mode}")
        out[fn] = (rec, cost)
    return out


def train_step_flops(layers: int, rows: int, seq: int, hidden: int,
                     inter: int, vocab: int, preds: int, micro: int,
                     flash: bool = True) -> int:
    """The cost counter's flops of one pretraining step, from the layer
    shapes (tests/test_torch_cost_analysis.py's closed form): each dense
    ``M x in x out`` 6MNK over forward and backward; attention
    12*rows*S^2*hidden dense, or with the flash kernels and remat dots
    their notes, forward 4 + its recompute 4 + dq 6 + dkv 8 (the dots are
    saved, not recomputed); the MLM transform and decoder on ``preds``
    rows a row, the pooler and NSP classifier on one."""
    def dense(m, k, n):
        return 6 * m * k * n

    tokens = rows * seq
    attention = (22 if flash else 12) * rows * seq * seq * hidden
    layer = (dense(tokens, hidden, 3 * hidden) + dense(tokens, hidden, hidden)
             + dense(tokens, hidden, inter) + dense(tokens, inter, hidden)
             + attention)
    heads = (dense(rows * preds, hidden, hidden)
             + dense(rows * preds, hidden, vocab)
             + dense(rows, hidden, hidden) + dense(rows, hidden, 2))
    return micro * (layers * layer + heads)


def check_feed_launches(label: str, launches: dict, layers: int,
                        extra_fwd: int = 0) -> None:
    """Phase 6's 4/2/2 per layer per step over FEED_STEPS steps (``extra_fwd``
    more forwards: the held-out passes), no other kernel."""
    per_step = layers * TRAIN_ACCUM
    want = {name: 0 for name in launches}
    want.update({"flash_attention_fwd": 2 * per_step * FEED_STEPS + extra_fwd,
                 "flash_attention_dq": per_step * FEED_STEPS,
                 "flash_attention_dkv": per_step * FEED_STEPS})
    if launches != want:
        raise AssertionError(f"{label} launches {launches}; expected {want}")


def h2d_copies(trace: str) -> dict:
    """The host-to-device copies of a Chrome trace of ``torch.profiler``
    against the stream most of its kernels ran on (the compute stream)."""
    from bert_pytorch_tpu_torch.tools.profile_train import load_trace

    events = load_trace(trace)
    streams = [e.get("args", {}).get("stream") for e in events
               if e.get("cat") == "kernel"]
    compute = statistics.mode(streams)
    pinned = [e for e in events if e.get("cat") == "gpu_memcpy"
              and PINNED_HTOD.search(e.get("name", ""))]
    pageable = [e for e in events if e.get("cat") == "gpu_memcpy"
                and "HtoD" in e.get("name", "") and e not in pinned]
    return {"compute_stream": compute,
            "memcpys": sorted({e.get("name") for e in events
                               if e.get("cat") == "gpu_memcpy"}),
            "pinned": len(pinned),
            "pinned_streams": sorted({e["args"].get("stream")
                                      for e in pinned}),
            "pinned_bytes": sum(e["args"].get("bytes", 0) for e in pinned),
            "pinned_us": round(sum(e.get("dur", 0) for e in pinned), 3),
            "pageable_on_compute": sum(
                1 for e in pageable
                if e["args"].get("stream") == compute)}


def step_p50_s(run: dict) -> float:
    """The median wall time of a run's steps after its first (the runner's
    per-step start and end, every step synced)."""
    return statistics.median(end - start for start, end in
                             run["summary"]["step_times"][1:])


def window_p50s(windows: list) -> list:
    return [(w["step"], w["data_wait_p50_s"], w.get("h2d_wait_p50_s"),
             w["step_p50_s"]) for w in windows]


def drive_feed(kernels: dict, root: str, card: str) -> dict:
    """Phase 15 (full width and depth of BERT-large; cut: 6 steps a run of
    the recipe's 1563, local batch 8 x 2 for 32 x 1024, a held-out set of
    4 batches): the feed of a long run through ``run_pretraining.main``.

    15a: --device_prefetch 2 against 0, in turns (0, then 2 traced, both
    at FEED_TRACED_LAYERS layers, then untraced 2, then 0 at 24, both
    under the default cost analysis; then 0 again under
    --telemetry_cost_analysis off, the counter's pair): per-step losses
    bit-equal within each pair, #1-#3 4 x layers / 2 x layers /
    2 x layers per step, the copies in the trace of steps 2-3
    pinned-to-device on a stream other than the compute kernels',
    data_wait/h2d_wait p50 of schema-clean windows, and the step p50 of
    each depth with and without the trace.
    15c: --num_workers 2 --num_steps_per_eval 2 --eval_batches 4: the
    losses 15a's bit for bit (the two workers' batches the in-process
    loader's), each worker's start to its first batch, ``val`` records
    at steps 2, 4 and 6, each equal to pretrain.make_eval_step on that
    step's params and the same batches; the eval route's kernel and
    launches per batch, a pass's seconds.
    15d: nonfinite@3 under --sentinel_policy abort raises with the
    injected record (FEED_TRACED_LAYERS layers since PR 17); then the
    kill cycle at dropout 0 and 6 layers: a
    child with die@4 and saves every 2 steps dies by SIGKILL, its newest
    checkpoint is truncated, a fresh child walks back to step 2 (a resume record
    naming the skip) and runs to step 6, its losses from step 3 on equal
    to an uninterrupted run's bit for bit (within RESUME_STEP_ATOL only if
    a kernel is not deterministic, as phase 9's rule)."""
    import gc

    from bert_pytorch_tpu_torch import pretrain, run_pretraining
    from bert_pytorch_tpu_torch.data.loader import DataLoader
    from bert_pytorch_tpu_torch.data.sampler import DistributedSampler
    from bert_pytorch_tpu_torch.telemetry.sentinels import NonFiniteError
    from bert_pytorch_tpu_torch.testing import faults
    from bert_pytorch_tpu_torch.utils import checkpoint as ckpt

    t_phase = time.perf_counter()
    layers = 24
    # 15a
    traced_dir = os.path.join(root, "feed_traced_config")
    os.makedirs(traced_dir)
    traced_config = cut_config(traced_dir,
                               num_hidden_layers=FEED_TRACED_LAYERS)
    runs = {}
    # The prefetch-0 run counts its first step under --telemetry_cost_analysis
    # full (the allocator's peak over it, after a reset): the allocator's
    # peak before it must survive into the run's memory records.
    peak_before = torch.cuda.max_memory_allocated()
    for depth in ("0", "2"):
        out = os.path.join(root, f"feed_prefetch_{depth}")
        extra = ["--device_prefetch", depth, "--telemetry_window",
                 str(FEED_WINDOW), "--telemetry_sync_every", "1"]
        if depth == "0":
            extra += ["--telemetry_cost_analysis", "full"]
        else:
            extra += ["--profile_steps", FEED_PROFILE_STEPS, "--profile_dir",
                      os.path.join(out, "profile")]
        runs[depth] = feed_main(kernels, out, extra, config=traced_config)
        check_feed_launches(f"15a prefetch {depth}", runs[depth]["launches"],
                            FEED_TRACED_LAYERS)
    full = cost_records("15a prefetch 0", runs["0"]["records"],
                        ["train_step"], "full")["train_step"][1]
    auto = cost_records("15a prefetch 2", runs["2"]["records"],
                        ["train_step"])["train_step"][1]
    peaks = [r["peak_bytes_in_use"] for r in runs["0"]["records"]
             if r.get("kind") == "memory"]
    if (full["flops"] != auto["flops"] or not peaks
            or min(peaks) < max(peak_before, full["temp_bytes"])):
        raise AssertionError(
            f"15a full vs auto: flops {full['flops']} / {auto['flops']}, "
            f"temp_bytes {full['temp_bytes']}, the run's peaks {peaks} "
            f"under the peak before it {peak_before}")
    if (runs["0"]["losses"] != runs["2"]["losses"]
            or len(runs["0"]["losses"]) != FEED_STEPS):
        raise AssertionError(f"15a losses differ: prefetch 0 "
                             f"{runs['0']['losses']}, 2 {runs['2']['losses']}")
    profile = os.path.join(root, "feed_prefetch_2", "profile")
    traces = [f for f in os.listdir(profile) if f.startswith("trace_")]
    if len(traces) != 1:
        raise AssertionError(f"15a profile traces {traces}")
    copies = h2d_copies(os.path.join(profile, traces[0]))
    if (copies["pinned"] < FEED_ARRAYS
            or copies["compute_stream"] in copies["pinned_streams"]):
        raise AssertionError(f"15a copies {copies}: a staged batch's five "
                             "arrays must arrive pinned, on a side stream")
    for depth, run in runs.items():
        if not run["windows"] or any(
                w["h2d_wait_p50_s"] > w["data_wait_p50_s"]
                for w in run["windows"]):
            raise AssertionError(f"15a windows of prefetch {depth}: "
                                 f"{run['windows']}")
    # The run after the full one has no floor of its own: its peak is the
    # allocator's, which full's reset lowered.
    peaks2 = [r["peak_bytes_in_use"] for r in runs["2"]["records"]
              if r.get("kind") == "memory"]
    if not peaks2 or max(peaks2) > runs["2"]["allocator_peak"]:
        raise AssertionError(f"15a prefetch 2 peaks {peaks2} above the "
                             f"allocator's {runs['2']['allocator_peak']}")
    # The traced run changes the depth and the trace together: an untraced
    # run of each depth follows, both under the default cost analysis, so
    # that step time is read against the depth alone. Then the counter's
    # own cost: the prefetch-0 run again under off, its losses the counted
    # runs', its first step and steps 2-N read beside the run before it.
    untraced = {"0": [], "2": []}
    untraced_runs = {}
    for i, (depth, mode) in enumerate(FEED_UNTRACED_RUNS):
        run = feed_main(kernels, os.path.join(
            root, f"feed_untraced_{i}_{depth}_{mode}"), [
            "--device_prefetch", depth, "--telemetry_window",
            str(FEED_WINDOW), "--telemetry_sync_every", "1",
            "--telemetry_cost_analysis", mode])
        check_feed_launches(f"15a untraced prefetch {depth} {mode}",
                            run["launches"], layers)
        untraced_runs[depth, mode] = run
        first = untraced_runs[FEED_UNTRACED_RUNS[0]]
        if run["losses"] != first["losses"]:
            raise AssertionError(f"15a untraced prefetch {depth} {mode} "
                                 f"losses {run['losses']} differ from "
                                 f"{first['losses']}")
        if mode == "auto":
            untraced[depth].append({"step_p50_s": step_p50_s(run),
                                    "windows": window_p50s(run["windows"]),
                                    "main_s": run["wall_s"]})
    counted = {key: cost_records(
        f"15a untraced prefetch {key[0]} {key[1]}", run["records"],
        ["train_step"], key[1])["train_step"]
        for key, run in untraced_runs.items()}
    cost = counted["2", "auto"][1]
    if counted["0", "auto"][1]["flops"] != cost["flops"]:
        raise AssertionError(f"15a untraced prefetch 0 counted "
                             f"{counted['0', 'auto'][1]}, 2 {cost}")
    counter_pair = {mode: {
        "first_step_s": counted["0", mode][0]["compile_s"],
        "steps_p50_s": step_p50_s(untraced_runs["0", mode])}
        for mode in ("auto", "off")}
    want = train_step_flops(layers, TRAIN_LOCAL_BATCH, TRAIN_SEQ, 1024, 4096,
                            FEED_VOCAB, FEED_MAX_PRED, TRAIN_ACCUM)
    # #1 twice (the remat recompute), #2 and #3 once, a layer a microbatch:
    # the notes from the backward come from autograd's thread.
    notes = 4 * layers * TRAIN_ACCUM
    if cost["flops"] != want or cost["kernel_notes"] != notes:
        raise AssertionError(f"15a train_step counted flops {cost['flops']}"
                             f" and {cost['kernel_notes']} kernel notes; "
                             f"the closed form {want}, {notes} notes")
    from bert_pytorch_tpu_torch.config import BertConfig
    from bert_pytorch_tpu_torch.utils import flops as flops_util

    model_flops = flops_util.bert_train_flops_per_seq(
        BertConfig.from_json_file(CONFIG), TRAIN_SEQ,
        FEED_MAX_PRED) * TRAIN_LOCAL_BATCH * TRAIN_ACCUM
    out_cost = {
        "flops": cost["flops"], "closed_form": want,
        "model_flops": model_flops,
        "counted_over_model": cost["flops"] / model_flops,
        "bytes_accessed": cost["bytes_accessed"],
        "argument_bytes": cost["argument_bytes"],
        "output_bytes": cost["output_bytes"],
        "counter_prefetch_0": counter_pair,
        "temp_bytes_6_layers": full["temp_bytes"],
        "peak_bytes_6_layers": max(peaks)}
    log(f"[cost] phase-2 train_step at 24 layers: counted flops "
        f"{cost['flops']:.6e} (the closed form's, exact), "
        f"utils/flops.py {model_flops:.6e}, counted / model "
        f"{out_cost['counted_over_model']:.4f}; bytes accessed "
        f"{cost['bytes_accessed']:.6e}, argument bytes "
        f"{cost['argument_bytes']}, output bytes {cost['output_bytes']}; "
        f"prefetch 0 (first step, steps 2-{FEED_STEPS} p50) "
        f"{counter_pair['auto']['first_step_s']} s, "
        f"{counter_pair['auto']['steps_p50_s']:.4f} s counted (auto), "
        f"{counter_pair['off']['first_step_s']} s, "
        f"{counter_pair['off']['steps_p50_s']:.4f} s off; at "
        f"{FEED_TRACED_LAYERS} layers full's temp_bytes "
        f"{full['temp_bytes']}, the run's peak {max(peaks)} (before it "
        f"{peak_before}) on {card}")
    log(f"[feed] 15a prefetch 0 then 2 ({FEED_TRACED_LAYERS} layers): "
        f"losses bit-equal {runs['2']['losses']}; launches "
        f"{runs['2']['launches']}; untraced (24 layers) losses bit-equal "
        f"{first['losses']}, launches {first['launches']}; "
        f"(step, data_wait p50, h2d_wait p50, step p50) s: prefetch 0 "
        f"{window_p50s(runs['0']['windows'])}, prefetch 2 "
        f"{window_p50s(runs['2']['windows'])}; steps 2-{FEED_STEPS} p50 "
        f"{step_p50_s(runs['0']):.4f} / {step_p50_s(runs['2']):.4f} s (the "
        f"2 run traced); the traced steps' copies {copies}; main() "
        f"{runs['0']['wall_s']:.1f} / {runs['2']['wall_s']:.1f} s; untraced "
        f"in turns {'/'.join(d for d, _ in FEED_UNTRACED_RUNS[:2])}, "
        f"auto: prefetch 0 "
        f"{untraced['0']}, prefetch 2 {untraced['2']} on {card}")
    # 15c
    out = os.path.join(root, "feed_eval")
    r = runner(out, PHASE2, feed_argv(out, [
        "--num_workers", str(FEED_WORKERS), "--num_steps_per_eval",
        str(FEED_EVERY), "--eval_batches", str(FEED_EVAL_BATCHES)]))
    val_dataset = feed_dataset(FEED_VAL_SEED, TRAIN_LOCAL_BATCH * TRAIN_ACCUM
                               * FEED_EVAL_BATCHES)
    snapshots = {}

    def on_step(metrics):
        step = len(snapshots) + 1
        snapshots[step] = ({n: p.detach().clone() for n, p in
                            r["model"].named_parameters()}
                           if step % FEED_EVERY == 0 else None)

    # The held-out passes' own launches, read around each of the runner's
    # validate calls in this run.
    held_out = {name: 0 for name in kernels}
    make_validation = run_pretraining.make_validation

    def counted_validation(*a, **kw):
        validate = make_validation(*a, **kw)

        def run(step, epoch):
            before = {name: k.launches for name, k in kernels.items()}
            try:
                return validate(step, epoch)
            finally:
                for name, k in kernels.items():
                    held_out[name] += k.launches - before[name]

        run.batches = validate.batches
        return run

    torch.cuda.synchronize()
    zero_counts(kernels)
    run_pretraining.make_validation = counted_validation
    try:
        summary = train_runner(r, feed_dataset(), on_step=on_step,
                               val_dataset=val_dataset)
    finally:
        run_pretraining.make_validation = make_validation
    eval_launches = {name: k.launches for name, k in kernels.items()}
    records = feed_records(out)
    passes = len(summary["val"])
    check_feed_launches("15c", eval_launches, layers,
                        extra_fwd=passes * FEED_EVAL_BATCHES * layers)
    if held_out != {name: (passes * FEED_EVAL_BATCHES * layers
                           if name == "flash_attention_fwd" else 0)
                    for name in kernels}:
        raise AssertionError(f"15c held-out passes launched {held_out}")
    if train_losses(records) != untraced_runs["2", "auto"]["losses"]:
        raise AssertionError(f"15c losses {train_losses(records)} differ "
                             f"from 15a's {first['losses']}")
    eval_cost = cost_records("15c", records, ["train_step", "eval_step"])[
        "eval_step"][1]
    out_cost["eval_step_flops"] = eval_cost["flops"]
    if [v["step"] for v in summary["val"]] != list(
            range(FEED_EVERY, FEED_STEPS + 1, FEED_EVERY)):
        raise AssertionError(f"15c val records {summary['val']}")
    eval_step = pretrain.make_eval_step(r["model"])
    pass_s = []
    zero_counts(kernels)
    for record in summary["val"]:
        with torch.no_grad():
            for name, p in r["model"].named_parameters():
                p.copy_(snapshots[record["step"]][name])
        loader = DataLoader(val_dataset, DistributedSampler(val_dataset),
                            batch_size=r["args"].global_batch_size)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss_sum = acc_sum = 0.0
        batches = iter(loader)
        for _, batch in zip(range(FEED_EVAL_BATCHES), batches):
            loss, acc = eval_step(pretrain.to_device(batch, "cuda"))
            loss_sum += float(loss)
            acc_sum += float(acc)
        batches.close()
        pass_s.append(time.perf_counter() - t0)
        want = (loss_sum / FEED_EVAL_BATCHES, acc_sum / FEED_EVAL_BATCHES)
        if (record["average_loss"], record["mlm_accuracy"]) != want:
            raise AssertionError(f"15c val record {record}; make_eval_step "
                                 f"on step {record['step']}'s params {want}")
    check_launches = {name: k.launches for name, k in kernels.items()}
    route = {name: n // (passes * FEED_EVAL_BATCHES)
             for name, n in check_launches.items() if n}
    if route != {"flash_attention_fwd": layers}:
        raise AssertionError(f"15c eval launches {check_launches}")
    starts = r["loader"].worker_first_batch_s
    if len(starts) != FEED_WORKERS or None in starts:
        raise AssertionError(f"15c the workers' first batches {starts}")
    starts = [round(s, 3) for s in starts]
    del r, snapshots, eval_step
    log(f"[feed] 15c {FEED_WORKERS} workers, losses 15a's bit for bit, "
        f"each worker's start to its first batch {starts} s; val "
        f"records {summary['val']} equal make_eval_step on each step's "
        f"params; the eval forward runs {route} launches per batch (the "
        f"training forward, #1; #4 none); a pass of {FEED_EVAL_BATCHES} "
        f"batches {[round(s, 3) for s in pass_s]} s on {card}")
    gc.collect()
    torch.cuda.empty_cache()
    # 15d
    out = os.path.join(root, "feed_nonfinite")
    try:
        feed_main(kernels, out, [
            "--fault_spec", f"nonfinite@{FEED_NONFINITE_AT}",
            "--sentinel_policy", "abort", "--sentinel_patience", "1",
            "--telemetry_sync_every", "1"], config=traced_config)
        raise AssertionError("nonfinite@3 under abort did not raise")
    except NonFiniteError as exc:
        aborted = str(exc)
    finally:
        faults.arm("")
    records = feed_records(out)
    injected = [r["step"] for r in records
                if r.get("fault") == "injected_nonfinite"]
    if injected != [FEED_NONFINITE_AT] or sorted(train_losses(records)) != \
            list(range(1, FEED_NONFINITE_AT)):
        raise AssertionError(f"15d nonfinite: injected at {injected}, "
                             f"trained {sorted(train_losses(records))}")
    gc.collect()
    torch.cuda.empty_cache()
    free = shutil.disk_usage(root).free
    if free < FEED_DISK_BYTES:
        raise AssertionError(f"phase 15 needs {FEED_DISK_BYTES} bytes of "
                             f"free disk, {free} are free")
    cut = os.path.join(root, "feed_dropout0")
    os.makedirs(cut)
    config0 = cut_config(cut, hidden_dropout_prob=0.0,
                         attention_probs_dropout_prob=0.0,
                         num_hidden_layers=FEED_KILL_LAYERS)
    reference = feed_main(kernels, os.path.join(root, "feed_reference"),
                          config=config0)
    out = os.path.join(root, "feed_kill")
    env = {k: v for k, v in os.environ.items() if k != faults.FAULTS_ENV}
    t0 = time.perf_counter()
    died = subprocess.run(
        [sys.executable, "-c", FEED_CHILD, REPO, *feed_argv(out, [
            "--fault_spec", f"die@{FEED_KILL_AT}",
            "--num_steps_per_checkpoint", str(FEED_EVERY),
            "--checkpoint_write", "sync"], config0)],
        env=env, cwd=REPO, capture_output=True, text=True,
        timeout=FEED_CHILD_TIMEOUT_S)
    kill_s = time.perf_counter() - t0
    ckpt_dir = os.path.join(out, "pretrain_ckpts")
    if died.returncode != -signal.SIGKILL or ckpt._ckpt_steps(ckpt_dir) != [
            FEED_EVERY, FEED_KILL_AT]:
        raise AssertionError(f"15d kill child rc {died.returncode}, saves "
                             f"{ckpt._ckpt_steps(ckpt_dir)}: "
                             f"{died.stdout[-1500:]} {died.stderr[-1500:]}")
    faults.corrupt_checkpoint(ckpt.checkpoint_path(ckpt_dir, FEED_KILL_AT),
                              "truncate")
    t0 = time.perf_counter()
    resumed = subprocess.run(
        [sys.executable, "-c", FEED_CHILD, REPO, *feed_argv(out, [
            "--steps", str(FEED_STEPS - FEED_EVERY)], config0)],
        env=env, cwd=REPO, capture_output=True, text=True,
        timeout=FEED_CHILD_TIMEOUT_S)
    resume_s = time.perf_counter() - t0
    if resumed.returncode != 0:
        raise AssertionError(f"15d resume child rc {resumed.returncode}: "
                             f"{resumed.stderr[-2000:]}")
    records = feed_records(out)
    resume = [r for r in records if r.get("kind") == "resume"]
    if len(resume) != 1 or resume[0]["step"] != FEED_EVERY or [
            s["step"] for s in resume[0]["skipped"]] != [FEED_KILL_AT]:
        raise AssertionError(f"15d resume records {resume}")
    after = train_losses(records[records.index(resume[0]):])
    want = {s: reference["losses"][s]
            for s in range(FEED_EVERY + 1, FEED_STEPS + 1)}
    exact = after == want
    diff = max((abs(after.get(s, math.inf) - v) for s, v in want.items()),
               default=math.inf)
    determinism = None if exact else kernels_deterministic()
    if not exact and (all(determinism.values())
                      or diff > RESUME_STEP_ATOL):
        raise AssertionError(f"15d resumed losses {after}, uninterrupted "
                             f"{want} (kernels deterministic: "
                             f"{determinism})")
    shutil.rmtree(out)
    phase_s = time.perf_counter() - t_phase
    log(f"[feed] 15d nonfinite@{FEED_NONFINITE_AT} under abort: "
        f"{aborted!r}, injected record at step {FEED_NONFINITE_AT}; kill "
        f"cycle (dropout 0, {FEED_KILL_LAYERS} layers): die@{FEED_KILL_AT} "
        f"rc {died.returncode} after "
        f"saves {FEED_EVERY}, {FEED_KILL_AT} in {kill_s:.1f} s; ckpt_"
        f"{FEED_KILL_AT} truncated; the resume walked back to "
        f"{resume[0]['step']} and ran to {FEED_STEPS} in {resume_s:.1f} s, "
        f"losses {after} (uninterrupted {want}; bit-equal {exact}); phase "
        f"15 {phase_s:.1f} s on {card}")
    shutil.rmtree(traced_dir)
    return {"launches": untraced_runs["2", "auto"]["launches"],
            "traced_launches": runs["2"]["launches"],
            "eval_launches": eval_launches, "held_out_launches": held_out,
            "eval_route": route, "eval_pass_s": pass_s,
            "losses": untraced_runs["2", "auto"]["losses"], "windows": {
                depth: window_p50s(run["windows"])
                for depth, run in runs.items()},
            "main_s": {depth: run["wall_s"] for depth, run in runs.items()},
            "step_p50_s": {depth: step_p50_s(run)
                           for depth, run in runs.items()},
            "untraced": untraced,
            "h2d_copies": copies,
            "worker_first_batch_s": starts,
            "val": summary["val"], "nonfinite": aborted,
            "kill_child_s": kill_s, "resume_child_s": resume_s,
            "resumed_losses": after, "resumed_bit_equal": exact,
            "phase_s": phase_s, "cost": out_cost}


# -- phase 16: RoBERTa-large and the text path --------------------------------

# The repo's RoBERTa-large config as published (24 x 1024, 16 heads, FFN
# 4096, vocab 50265, no NSP, byte-level BPE, cased); only its vocab_file
# names the vocab 16a trains (the published vocab.json is not in the repo).
ROBERTA = os.path.join(REPO, "configs", "roberta_large_cased_config.json")
# 16a: the synthetic corpus (make_synthetic_text's defaults: 4 files of
# 200 articles), shards of 100 kB, a BPE vocab of at most 2000 entries.
TEXT_FILES, TEXT_ARTICLES, TEXT_SHARD_BYTES, BPE_VOCAB = 4, 200, 100_000, 2000
ROBERTA_STEPS = 4
# The depth 16b-16e run at, cut from the published 24 to keep the smoke in
# its time since PR 20 (width, heads, FFN, vocab and the text path stay the
# published ones): the checkpoints, loads and steps shrink, not the code.
ROBERTA_LAYERS = 6
ROBERTA_DATA_SEED = 16
# 16c: MRPC at the GLUE recipe, 3 steps of 32.
ROBERTA_GLUE = (32, 96)
# 16d/16e: the requests 16d serves one at a time, after a concurrent wave
# that packs them, and 16e scores from a file in runs of one task (packed
# up to 8 to a forward).
ROBERTA_REQUESTS = 32
# The served fill_mask slots against the dense run of the same model on
# the same features, as log-probabilities: both bf16, so the two differ
# by bf16 rounding in the layers' attention, GLUE_SERVE_ATOL on a logit,
# twice that once the logsumexp moves too. Two ids whose reference
# log-probabilities lie within twice this are a tie at bf16 precision,
# and may trade places in a top-k.
FILL_MASK_LOGP_ATOL = 2 * GLUE_SERVE_ATOL
ROBERTA_DISK_BYTES = 14 * 2 ** 30


def roberta_requests() -> list:
    """ROBERTA_REQUESTS (task, payload) pairs over the synthetic corpus's
    words (cased text): the first half fill_mask (one or two [MASK]s),
    the second classify, so that a file of them holds one run of each
    task."""
    from bert_pytorch_tpu_torch.tools import make_synthetic_text as text

    rng = np.random.default_rng(16)
    words = sorted({w.strip(".?") for _, s, _ in text.RELATIONS
                    for w in s.split() if "{" not in w}
                   | set(text.ENTITIES))
    out = []
    for i in range(ROBERTA_REQUESTS):
        chosen = [str(w) for w in rng.choice(words, int(rng.integers(6, 40)))]
        chosen[0] = chosen[0].capitalize()
        if i < ROBERTA_REQUESTS // 2:
            for _ in range(1 + i % 2):
                chosen[int(rng.integers(len(chosen)))] = "[MASK]"
            out.append(("fill_mask", {"text": " ".join(chosen) + ".",
                                      "top_k": 5}))
        else:
            cut = len(chosen) // 2
            out.append(("classify", {"text": " ".join(chosen[:cut]),
                                     "text_pair": " ".join(chosen[cut:])}))
    return out


def move_mask_last(vocab: str, tokens: dict) -> str:
    """Trade the ids of ``[MASK]`` and the last entry of the BPE
    ``vocab.json`` at ``vocab`` (``tokens``, its token -> id, is updated
    in place), as the published vocab's mask token is last; returns the
    token that took [MASK]'s old id."""
    last = max(tokens.values())
    moved = next(t for t, i in tokens.items() if i == last)
    tokens[moved], tokens["[MASK]"] = tokens["[MASK]"], last
    with open(vocab, "w", encoding="utf-8") as f:
        json.dump(dict(sorted(tokens.items(), key=lambda kv: kv[1])), f,
                  ensure_ascii=False, separators=(",", ":"))
    return moved


def check_known_decode(engine, payload: dict, by_id: dict) -> list:
    """The fill_mask handler's answer to logits whose top-5 at every
    [MASK] of ``payload`` are known ids of the trained vocab (``by_id``,
    id -> token: its five longest tokens, ranked): each slot must carry
    the id and its vocab entry. Returns those ids."""
    handler = engine.tasks["fill_mask"].handler
    payload = dict(payload, top_k=5)
    features = handler.prepare(payload, engine.max_len())
    known = sorted(by_id, key=lambda i: (-len(by_id[i]), i))[:5]
    logits = np.zeros((len(features["input_ids"]), engine.config.vocab_size),
                      np.float32)
    logits[np.ix_(features["mask_positions"], known)] = np.arange(5, 0, -1)
    decoded = handler.postprocess(features, logits, payload)["masks"]
    want = [[(i, by_id[i]) for i in known]] * len(features["mask_positions"])
    if [[(s["id"], s["token"]) for s in m] for m in decoded] != want:
        raise AssertionError(f"16d: the handler decoded known top-k ids "
                             f"{known} as {decoded}")
    return known


def fill_mask_reference(engine, payloads: list) -> list:
    """Log-probabilities (float64 [masks, vocab]) at each [MASK] of each
    fill_mask payload: the engine's fill_mask model run with dense
    attention on the features its handler makes, one request alone in an
    unpacked row."""
    from bert_pytorch_tpu_torch.serve.batcher import Request

    spec = engine.tasks["fill_mask"]
    modules = [m for m in spec.model.modules()
               if hasattr(m, "attention_backend")]
    served = [m.attention_backend for m in modules]
    for m in modules:
        m.attention_backend = "dense"
    refs = []
    try:
        for payload in payloads:
            features = spec.handler.prepare(payload, engine.max_len())
            plan = engine.plan_batch(
                [Request("fill_mask", features, payload)], packed=False)
            rows = np.asarray(engine.execute("fill_mask", plan)[0][0],
                              np.float64)[features["mask_positions"]]
            rows = rows - rows.max(axis=-1, keepdims=True)
            refs.append(rows - np.log(np.exp(rows).sum(axis=-1,
                                                       keepdims=True)))
    finally:
        for m, backend in zip(modules, served):
            m.attention_backend = backend
    return refs


def check_fill_mask(answer: dict, ref: np.ndarray, label: str) -> float:
    """Hold one fill_mask answer to its reference log-probabilities: each
    slot's score is the reference's for its id within
    FILL_MASK_LOGP_ATOL, and the slots are a top-k of the reference up to
    ties (no slot below the reference's k-th by more than a tie, no id
    above it by more than a tie left out). Returns the largest error."""
    if len(answer["masks"]) != len(ref):
        raise AssertionError(f"{label}: {len(answer['masks'])} masks "
                             f"answered, {len(ref)} in the text")
    err = 0.0
    for slots, row in zip(answer["masks"], ref):
        kth = np.sort(row)[-len(slots)]
        ids = [s["id"] for s in slots]
        errs = [abs(math.log(s["score"]) - row[s["id"]]) for s in slots]
        missed = set(np.flatnonzero(row > kth + 2 * FILL_MASK_LOGP_ATOL)
                     .tolist()) - set(ids)
        low = [i for i in ids if row[i] < kth - 2 * FILL_MASK_LOGP_ATOL]
        if max(errs) > FILL_MASK_LOGP_ATOL or missed or low:
            raise AssertionError(
                f"{label}: slots {ids} with log-probability errors {errs} "
                f"(atol {FILL_MASK_LOGP_ATOL:g}); the reference's top ids "
                f"{np.argsort(-row)[:len(slots)].tolist()}, missed {missed},"
                f" below its k-th {low}")
        err = max(err, *errs)
    return err


def top_k_swaps(answer: dict, want: dict, ref: np.ndarray,
                label: str) -> int:
    """The rank positions where ``answer``'s fill_mask ids differ from
    ``want``'s; raises unless each such pair of ids is a tie in the
    reference (log-probabilities within 2 x FILL_MASK_LOGP_ATOL)."""
    swaps = 0
    for got, exp, row in zip(answer["masks"], want["masks"], ref):
        for a, b in zip(got, exp):
            if a["id"] == b["id"]:
                continue
            swaps += 1
            if abs(row[a["id"]] - row[b["id"]]) > 2 * FILL_MASK_LOGP_ATOL:
                raise AssertionError(
                    f"{label}: id {a['id']} where 16d answered {b['id']}, "
                    f"reference log-probabilities {row[a['id']]:.4f} and "
                    f"{row[b['id']]:.4f}")
    return swaps


def check_offline_answers(results: list, answers: list, refs: dict
                          ) -> tuple:
    """Hold batch_infer's ``results`` to the server's ``answers`` for the
    same requests: packed batches sum in other orders than one-request
    forwards, so they agree within the tolerances, not bit for bit.
    fill_mask (the requests ``refs`` holds, index -> reference
    log-probabilities) as check_fill_mask and rank for rank up to ties
    (top_k_swaps); classify log-probabilities within 2 x GLUE_SERVE_ATOL.
    Returns (fill_mask error, ranks swapped, classify error)."""
    swaps, fill_err, cls_err = 0, 0.0, 0.0
    for i, (got, body) in enumerate(zip(results, answers)):
        if i in refs:
            fill_err = max(fill_err, check_fill_mask(
                got, refs[i], f"16e request {i}"))
            swaps += top_k_swaps(got, body, refs[i], f"16e request {i}")
            continue
        d = max(abs(math.log(got["scores"][k]) - math.log(v))
                for k, v in body["scores"].items())
        cls_err = max(cls_err, d)
        if not d <= 2 * GLUE_SERVE_ATOL:
            raise AssertionError(f"16e request {i}: classify {got} where "
                                 f"16d answered {body}")
    return fill_err, swaps, cls_err


def bench_tools(bpe_vocab: str, card: str) -> dict:
    """The offline benches on the card: tools/bench_loader over
    SyntheticPretrainingDataset rows (the card has no h5py) at phase 6's
    S=512 in the process (no workers: 15c reads their start), and
    tools/bench_tokenizer's C++ BPE on 16a's vocabulary beside HF's where
    ``tokenizers`` imports. Each prints the JAX tool's JSON lines; a few
    seconds each."""
    import contextlib
    import io

    from bert_pytorch_tpu_torch.tools import bench_loader, bench_tokenizer

    lines = {}
    for name, tool, argv in (
            ("bench_loader", bench_loader,
             ["--source", "rows", "--seq_len", str(TRAIN_SEQ),
              "--batch_size", "16", "--samples", "1024", "--workers",
              "0"]),
            ("bench_tokenizer", bench_tokenizer,
             ["--lines", "5000", "--repeat", "3", "--vocab_file",
              bpe_vocab])):
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            tool.main(argv)
        lines[name] = [json.loads(line) for line in
                       buf.getvalue().splitlines() if line.startswith("{")]
        lines[name + "_s"] = time.perf_counter() - t0
    rates = [line["value"] for line in lines["bench_loader"]]
    cpp = [line for line in lines["bench_tokenizer"]
           if line.get("backend") == "cpp"]
    if len(rates) != 1 or min(rates) <= 0 or len(cpp) != 1 or not (
            cpp[0]["value"] > 0 and cpp[0]["metric"]
            == "bpe_encode_tokens_per_sec"):
        raise AssertionError(f"bench tools: {lines}")
    log(f"[tools] bench_loader rows S={TRAIN_SEQ} batch 16: {rates[0]} "
        f"seq/s in the process ({lines['bench_loader_s']:.1f} s); "
        f"bench_tokenizer C++ BPE on 16a's vocab: {cpp[0]['value']} "
        f"tokens/s over {cpp[0]['tokens']} tokens "
        f"({lines['bench_tokenizer_s']:.1f} s); "
        f"{lines['bench_tokenizer'][1:]} on {card}")
    return lines


def drive_roberta(kernels: dict, root: str, card: str) -> dict:
    """Phase 16: RoBERTa-large through the text path, at full width and
    ROBERTA_LAYERS layers (cut: 4 pretraining steps of the recipe, local
    batch 8 x 2).

    16a: a cold build of the tokenizer core into a fresh build directory
    (its ``compile`` record and seconds), then make_synthetic_text ->
    shard -> build_vocab --tokenizer bpe (the C++ trainer), each timed;
    the vocab's [MASK] then trades ids with its last entry, as the
    published vocab's mask token is last (build_vocab puts it at 4, the
    runner's fallback, where a wrong lookup would not show).
    16b: run_pretraining.main on the RoBERTa config with that vocab, in
    phase 6's shape on SyntheticPretrainingDataset rows masked with the
    runner's mask id: the id it logs is the C++ tokenizer's [MASK] and
    not 4, no NSP loss anywhere, finite losses, 4/2/2 launches of
    #1/#2/#3 per layer per step on the tensor cores, one sync save at the
    end.
    16c: run_glue MRPC --tokenizer bpe from that checkpoint at the
    recipe (S=128, batch 32, 3 steps) with its final save.
    16d: run_server --tasks classify,fill_mask (flash_infer) from 16c's
    and 16b's checkpoints: a concurrent wave, then the 32 requests one at
    a time, over HTTP; one launch of #4 per layer per forward; the
    classify logits
    of a dev row equal the GLUE model's within GLUE_SERVE_ATOL; each
    fill_mask answer a top-k of the same model run with dense attention
    on the same features (check_fill_mask), every token the vocab entry
    of its id, and the handler's decode of logits whose top-k are known
    in-vocab ids.
    16e: tools/batch_infer on a JSONL of the same 32 requests (a run of
    fill_mask, then one of classify) and checkpoints: its plans pack
    several requests to a forward; each result is 16d's answer (classify
    log-probabilities within 2 x GLUE_SERVE_ATOL, fill_mask ids rank for
    rank up to ties of the reference, and held to it as in 16d); one
    launch of #4 per layer per forward."""
    import gc

    from bert_pytorch_tpu_torch import run_glue, run_pretraining
    from bert_pytorch_tpu_torch.data import glue
    from bert_pytorch_tpu_torch.data.tokenization import get_bpe_tokenizer
    from bert_pytorch_tpu_torch.ops.kernels import build
    from bert_pytorch_tpu_torch.serve.batcher import Request
    from bert_pytorch_tpu_torch.serve.engine import InferenceEngine
    from bert_pytorch_tpu_torch.telemetry.compile_events import CompileMonitor
    from bert_pytorch_tpu_torch.tools import (batch_infer, build_vocab,
                                              make_synthetic_text, shard)
    from bert_pytorch_tpu_torch.tools import make_synthetic_data as synth
    from bert_pytorch_tpu_torch.tools.make_synthetic_data import (
        SyntheticPretrainingDataset)
    from bert_pytorch_tpu_torch.utils import checkpoint as ckpt

    t_phase = time.perf_counter()
    out = {"seconds": {}}
    work = os.path.join(root, "roberta")
    os.makedirs(work)
    free = shutil.disk_usage(root).free
    if free < ROBERTA_DISK_BYTES:
        raise AssertionError(f"phase 16 needs {ROBERTA_DISK_BYTES} bytes of "
                             f"disk for its checkpoints; {free} free")

    # -- 16a: the tokenizer core and the offline text chain ---------------
    t0 = time.perf_counter()
    build.set_build_dir(os.path.join(work, "build"))
    try:
        with CompileMonitor().installed() as monitor:
            build_s = build.build_host("tokenizer")
    finally:
        build.set_build_dir(None)
    events = [(e["fn"], e["cache"], e["compile_s"]) for e in monitor.events]
    if events != [("tokenizer", "miss", round(build_s, 4))] or build_s <= 0:
        raise AssertionError(f"16a: the cold build reported {events}")
    steps = {}
    t = time.perf_counter()
    corpus = make_synthetic_text.write_corpus(
        os.path.join(work, "text"), TEXT_FILES, TEXT_ARTICLES, 0)
    steps["make_synthetic_text"] = time.perf_counter() - t
    t = time.perf_counter()
    shards = shard.shard(corpus, os.path.join(work, "shards"),
                         TEXT_SHARD_BYTES)
    steps["shard"] = time.perf_counter() - t
    t = time.perf_counter()
    vocab = build_vocab.main([
        "--input_glob", os.path.join(work, "shards", "*.txt"),
        "--tokenizer", "bpe", "--output", os.path.join(work, "vocab"),
        "--vocab_size", str(BPE_VOCAB), "--uppercase"])
    steps["build_vocab"] = time.perf_counter() - t
    merges = vocab.replace("vocab.json", "merges.txt")
    with open(vocab, encoding="utf-8") as f:
        vocab_tokens = json.load(f)
    moved = move_mask_last(vocab, vocab_tokens)
    last = vocab_tokens["[MASK]"]
    with open(merges, encoding="utf-8") as f:
        n_merges = sum(1 for line in f if line.strip()
                       and not line.startswith("#version"))
    tokenizer = get_bpe_tokenizer(vocab, uppercase=True)
    mask_id = tokenizer.token_to_id("[MASK]")
    if mask_id != last or n_merges == 0:
        raise AssertionError(f"16a: vocab {len(vocab_tokens)}, merges "
                             f"{n_merges}, [MASK] {mask_id}")
    out["tokenizer"] = {"build_s": build_s, "steps_s": steps,
                        "corpus_bytes": sum(os.path.getsize(p)
                                            for p in corpus),
                        "shards": len(shards), "vocab": len(vocab_tokens),
                        "merges": n_merges, "mask_id": mask_id}
    out["seconds"]["16a"] = time.perf_counter() - t0
    log(f"[roberta 16a] tokenizer core cold build {build_s:.2f} s "
        f"(compile record {events}); corpus {out['tokenizer']['corpus_bytes']}"
        f" bytes in {steps['make_synthetic_text']:.2f} s, {len(shards)} "
        f"shards in {steps['shard']:.2f} s, BPE vocab {len(vocab_tokens)} "
        f"tokens / {n_merges} merges in {steps['build_vocab']:.2f} s; [MASK] "
        f"moved to id {mask_id} (its id 4 to {moved!r}) on {card}")
    with open(ROBERTA, encoding="utf-8") as f:
        published = json.load(f)
    config = os.path.join(work, "roberta.json")
    with open(config, "w", encoding="utf-8") as f:
        json.dump(dict(published, vocab_file=vocab,
                       num_hidden_layers=ROBERTA_LAYERS), f)

    # -- 16b: pretraining ----------------------------------------------------
    t0 = time.perf_counter()
    pre_out = os.path.join(work, "pretrain")
    vocab_padded = published["vocab_size"] + (-published["vocab_size"]) % 8
    dataset = SyntheticPretrainingDataset(
        ROBERTA_DATA_SEED, TRAIN_LOCAL_BATCH * TRAIN_ACCUM * ROBERTA_STEPS,
        TRAIN_SEQ, vocab_padded, FEED_MAX_PRED, mask_token_index=mask_id)
    argv = feed_argv(pre_out, config=config)
    argv[argv.index("--steps") + 1] = str(ROBERTA_STEPS)
    argv.remove("--skip_final_checkpoint")
    args = run_pretraining.parse_arguments(argv)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    zero_counts(kernels)
    t = time.perf_counter()
    summary = run_pretraining.main(args, dataset)
    wall = time.perf_counter() - t
    launches = {name: k.launches for name, k in kernels.items()}
    routes = {name: dict(kernels[name].route_launches)
              for name in TRAIN_REPLACES}
    peak = torch.cuda.max_memory_allocated()
    records = feed_records(pre_out)
    losses = train_losses(records)
    layers = ROBERTA_LAYERS
    per_step = layers * TRAIN_ACCUM
    want = {name: 0 for name in launches}
    want.update({"flash_attention_fwd": 2 * per_step * ROBERTA_STEPS,
                 "flash_attention_dq": per_step * ROBERTA_STEPS,
                 "flash_attention_dkv": per_step * ROBERTA_STEPS})
    if launches != want:
        raise AssertionError(f"16b launches {launches}; expected {want}")
    for name in TRAIN_REPLACES:
        if routes[name].get("tensor_cores") != launches[name]:
            raise AssertionError(f"16b {name} by route {routes[name]}")
    nsp_keys = sorted({k for r in records for k in r if "nsp" in k
                       or "next_sentence" in k})
    if (summary["mask_token_id"] != mask_id or mask_id == 4 or nsp_keys
            or sorted(losses) != list(range(1, ROBERTA_STEPS + 1))
            or not all(math.isfinite(v) for v in losses.values())
            or summary.get("finite", 1.0) != 1.0):
        raise AssertionError(f"16b: mask id {summary['mask_token_id']} (the "
                             f"tokenizer's {mask_id}), NSP keys {nsp_keys}, "
                             f"losses {losses}")
    saved = ckpt.latest_checkpoint(os.path.join(pre_out, "pretrain_ckpts"))
    write = next(w for w in reversed(ckpt.write_records)
                 if w["path"] == saved)
    if write["async"] or not os.path.exists(saved):
        raise AssertionError(f"16b: final save {write}")
    step_s = step_p50_s({"summary": summary})
    seq_per_s = TRAIN_LOCAL_BATCH * TRAIN_ACCUM / step_s
    out["pretraining"] = {
        "losses": losses, "mask_token_id": summary["mask_token_id"],
        "launches": launches, "routes": routes, "step_p50_s": step_s,
        "seq_per_s": seq_per_s, "wall_s": wall, "peak_bytes": peak,
        "checkpoint": {k: write[k] for k in ("bytes", "seconds", "async")}}
    del summary
    gc.collect()
    torch.cuda.empty_cache()
    out["seconds"]["16b"] = time.perf_counter() - t0
    log(f"[roberta 16b] RoBERTa-large pretraining (S={TRAIN_SEQ}, max_pred "
        f"{FEED_MAX_PRED}, bf16, remat dots, LAMB, flash), local batch "
        f"{TRAIN_LOCAL_BATCH} x {TRAIN_ACCUM}, {ROBERTA_STEPS} steps: step "
        f"p50 {step_s:.4f} s, {seq_per_s:.2f} seq/s, losses {losses}, mask "
        f"id {mask_id}, launches {launches}, allocator peak {peak} bytes, "
        f"final sync save {write['bytes']} bytes in {write['seconds']:.2f} s"
        f" on {card}")

    # -- 16c: GLUE --------------------------------------------------------
    t0 = time.perf_counter()
    mrpc = synth.write_mrpc_tsvs(os.path.join(work, "MRPC"), 21,
                                 ROBERTA_GLUE[1], 32)
    glue_out = os.path.join(work, "glue_out")
    glue_args = run_glue.parse_arguments([
        "--task", "mrpc", "--data_dir", mrpc, "--model_config_file", config,
        "--tokenizer", "bpe", "--vocab_file", vocab, "--uppercase",
        "--init_checkpoint", saved, "--device", "cuda", "--dtype",
        "bfloat16", "--max_seq_len", str(FT_SEQ), "--epochs", "1",
        "--batch_size", str(ROBERTA_GLUE[0]), "--output_dir", glue_out])
    zero_counts(kernels)
    results, glue_model, _ = run_glue.run(glue_args)
    if any(k.launches for k in kernels.values()):
        raise AssertionError("16c: a kernel launched on GLUE's dense path")
    glue_steps = results["global_step"]
    if glue_steps != ROBERTA_GLUE[1] // ROBERTA_GLUE[0] or not (
            0.0 <= results.get("accuracy", -1.0) <= 1.0):
        raise AssertionError(f"16c: {results}")
    glue_write = check_saved_model(glue_out, glue_steps, glue_model,
                                   "roberta glue")
    out["glue"] = {"steps": glue_steps,
                   "seq_per_s": results["training_sequences_per_second"],
                   "accuracy": results["accuracy"],
                   "checkpoint_bytes": glue_write["bytes"]}
    out["seconds"]["16c"] = time.perf_counter() - t0
    log(f"[roberta 16c] MRPC --tokenizer bpe from ckpt of 16b: {glue_steps} "
        f"steps at batch {ROBERTA_GLUE[0]}, S={FT_SEQ}, bf16: "
        f"{results['training_sequences_per_second']:.2f} seq/s, accuracy "
        f"{results['accuracy']:.4f}; final save {glue_write['bytes']} bytes "
        f"on {card}")

    # -- 16d: serving -----------------------------------------------------
    t0 = time.perf_counter()
    requests = roberta_requests()
    rng = np.random.default_rng(17)
    wave = [requests[i] for i in rng.permutation(len(requests))[:16]]
    served, engine = serve_waves(
        serve_args(vocab, "bfloat16", "flash_infer", "classify,fill_mask",
                   ["--classify_checkpoint", glue_out,
                    "--fill_mask_checkpoint", saved, "--uppercase"],
                   config=config),
        [wave] + [[r] for r in requests], kernels, keep_bodies=True)
    check_launches(served, "flash_attention_infer", [
        n for n in kernels if n != "flash_attention_infer"])
    answers = served.pop("bodies")[len(wave):]
    fill = [i for i, (task, _) in enumerate(requests) if task == "fill_mask"]
    refs = dict(zip(fill, fill_mask_reference(
        engine, [requests[i][1] for i in fill])))
    fill_err = max(check_fill_mask(answers[i], refs[i], f"16d request {i}")
                   for i in fill)
    # Each slot's token is the BPE decode of its id: the vocab entry for
    # an id the trained vocab holds, "" for a row past it (the model keeps
    # the published vocab's 50265 rows).
    by_id = {i: t for t, i in vocab_tokens.items()}
    slots = [s for i in fill for m in answers[i]["masks"] for s in m]
    bad = [s for s in slots if s["token"] != by_id.get(s["id"], "")
           or s["token"] != tokenizer.id_to_token(s["id"])]
    if bad or not slots:
        raise AssertionError(f"16d: fill_mask slots not decoded by the BPE "
                             f"vocab: {bad[:5]}")
    in_vocab = sum(s["id"] in by_id for s in slots)
    # Random weights put few top-k ids inside the small trained vocab, so
    # the decode is also held on logits whose top-k are known.
    known = check_known_decode(engine, requests[fill[-1]][1], by_id)
    example = glue.PROCESSORS["mrpc"]().get_dev_examples(mrpc)[0]
    payload = {"text": example.text_a, "text_pair": example.text_b}
    row = glue.features_to_arrays(glue.convert_examples_to_features(
        [example], tokenizer, FT_SEQ, glue.PROCESSORS["mrpc"].labels), False)
    spec = engine.tasks["classify"]
    features = spec.handler.prepare(payload, engine.max_len())
    n = int(row["input_mask"][0].sum())
    if list(features["input_ids"])[:n] != row["input_ids"][0][:n].tolist():
        raise AssertionError("16d: the server tokenizes the dev row "
                             "differently from run_glue")
    plan = engine.plan_batch([Request("classify", features, payload)],
                             packed=False)
    served_logits = torch.as_tensor(np.asarray(
        engine.execute("classify", plan)[0][0], np.float32)).reshape(-1)
    with torch.no_grad():
        t = {k: torch.from_numpy(v).long().cuda() for k, v in row.items()}
        runner_logits = glue_model(t["input_ids"], t["segment_ids"],
                                   t["input_mask"]).float().cpu()[0]
    err = (served_logits - runner_logits).abs().max().item()
    if not err <= GLUE_SERVE_ATOL:
        raise AssertionError(f"16d: served logits {served_logits.tolist()} "
                             f"vs the GLUE model's {runner_logits.tolist()}")
    del engine, glue_model
    gc.collect()
    torch.cuda.empty_cache()
    out["serving"] = dict(served, classify_logit_err=err,
                          fill_mask_logp_err=fill_err,
                          fill_mask_slots=len(slots),
                          fill_mask_slots_in_vocab=in_vocab)
    out["seconds"]["16d"] = time.perf_counter() - t0
    log(f"[roberta 16d] run_server classify,fill_mask (flash_infer, bf16) "
        f"from 16c's and 16b's checkpoints: {served['requests']} requests "
        f"over {served['forwards']} forwards, p50 {served['p50_ms']:.1f} ms,"
        f" max {served['max_ms']:.1f} ms; classify logits vs the GLUE model "
        f"max |d| {err:.3e} (atol {GLUE_SERVE_ATOL:g}); fill_mask top-k vs "
        f"dense attention max |d log p| {fill_err:.3e} (atol "
        f"{FILL_MASK_LOGP_ATOL:g}); {in_vocab} of {len(slots)} fill_mask "
        f"slots inside the trained vocab; known top-k {known} decoded "
        f"{[by_id[i] for i in known]} on {card}")

    # -- 16e: batch_infer -------------------------------------------------
    t0 = time.perf_counter()
    request_file = os.path.join(work, "requests.jsonl")
    with open(request_file, "w", encoding="utf-8") as f:
        for i, (task, payload) in enumerate(requests):
            f.write(json.dumps({"id": i, "task": task, "payload": payload})
                    + "\n")
    scored = os.path.join(work, "scored.jsonl")
    plans = []
    plan_batch = InferenceEngine.plan_batch

    def recording(engine, todo, packed=None):
        plan = plan_batch(engine, todo, packed)
        plans.append((plan.requests[0].task, len(plan.requests),
                      plan.bucket, plan.packed))
        return plan

    InferenceEngine.plan_batch = recording
    zero_counts(kernels)
    try:
        stats = batch_infer.main([
        "--input", request_file, "--output", scored,
        "--model_config_file", config, "--vocab_file", vocab,
        "--device", "cuda", "--dtype", "bfloat16",
        "--attention_backend", "flash_infer",
        "--tasks", "classify,fill_mask", "--buckets", "128,512",
        "--max_batch_size", "8", "--pack_requests", "--uppercase",
        "--classify_checkpoint", glue_out, "--fill_mask_checkpoint", saved])
    finally:
        InferenceEngine.plan_batch = plan_batch
    batch_launches = {name: k.launches for name, k in kernels.items()}
    with open(scored, encoding="utf-8") as f:
        lines = [json.loads(line) for line in f]
    if (stats["errors"] or len(lines) != len(requests)
            or [line["id"] for line in lines] != list(range(len(requests)))
            or sum(n for _, n, _, _ in plans) != len(requests)
            or max(n for _, n, _, _ in plans) < 2):
        raise AssertionError(f"16e: {stats}; plans (task, requests, bucket, "
                             f"packed) {plans}")
    fill_err_e, swaps, cls_err = check_offline_answers(
        [line["result"] for line in lines], answers, refs)
    want_infer = layers * stats["forwards"]
    if batch_launches["flash_attention_infer"] != want_infer or any(
            v for n, v in batch_launches.items()
            if n != "flash_attention_infer"):
        raise AssertionError(f"16e launches {batch_launches}; expected "
                             f"{want_infer} of #4 over {stats['forwards']} "
                             "forwards")
    out["batch_infer"] = dict(stats, launches=batch_launches, plans=plans,
                              fill_mask_logp_err=fill_err_e,
                              fill_mask_swaps=swaps,
                              classify_logp_err=cls_err)
    # The same file through --quantize int8 (int8 weights and GEMMs, #5's
    # int8 scores, the fused gather): held to 16d's answers at the int8
    # bound (log-probabilities within INT8_LOGIT_ATOL, the JAX package's
    # 1e-1; the classify bound 2 x GLUE_SERVE_ATOL is the same 1e-1), one
    # launch of #5 per layer per forward and none of #4.
    scored8 = os.path.join(work, "scored_int8.jsonl")
    zero_counts(kernels)
    stats8 = batch_infer.main([
        "--input", request_file, "--output", scored8,
        "--model_config_file", config, "--vocab_file", vocab,
        "--device", "cuda", "--dtype", "bfloat16",
        "--attention_backend", "flash_infer_int8", *INT8_FLAGS,
        "--tasks", "classify,fill_mask", "--buckets", "128,512",
        "--max_batch_size", "8", "--pack_requests", "--uppercase",
        "--classify_checkpoint", glue_out, "--fill_mask_checkpoint", saved])
    int8_launches = {name: k.launches for name, k in kernels.items()}
    with open(scored8, encoding="utf-8") as f:
        lines8 = [json.loads(line) for line in f]
    if (stats8["errors"] or stats8["quantize"] != "int8"
            or [line["id"] for line in lines8] != list(range(len(requests)))):
        raise AssertionError(f"16e int8: {stats8}")
    assert FILL_MASK_LOGP_ATOL == 2 * GLUE_SERVE_ATOL == INT8_LOGIT_ATOL
    fill_err8, swaps8, cls_err8 = check_offline_answers(
        [line["result"] for line in lines8], answers, refs)
    want_int8 = layers * stats8["forwards"]
    if int8_launches["flash_attention_infer_int8"] != want_int8 or any(
            v for n, v in int8_launches.items()
            if n != "flash_attention_infer_int8"):
        raise AssertionError(f"16e int8 launches {int8_launches}; expected "
                             f"{want_int8} of #5 over {stats8['forwards']} "
                             "forwards")
    out["batch_infer_int8"] = dict(stats8, launches=int8_launches,
                                   fill_mask_logp_err=fill_err8,
                                   fill_mask_swaps=swaps8,
                                   classify_logp_err=cls_err8)
    log(f"[roberta 16e] batch_infer --quantize int8: {stats8['requests']} "
        f"requests, {stats8['forwards']} forwards, #5 {want_int8} launches "
        f"({layers} per forward), wall {stats8['wall_s']} s; against 16d's "
        f"answers classify max |d log p| {cls_err8:.3e}, fill_mask max "
        f"|d log p| vs dense {fill_err8:.3e} (bound {INT8_LOGIT_ATOL:g}), "
        f"{swaps8} top-k ranks swapped at ties on {card}")
    out["tools"] = bench_tools(vocab, card)
    out["seconds"]["16e"] = time.perf_counter() - t0
    gc.collect()
    torch.cuda.empty_cache()
    shutil.rmtree(work)
    out["seconds"]["phase"] = time.perf_counter() - t_phase
    log(f"[roberta 16e] batch_infer: {stats['requests']} requests in plans "
        f"(task, requests, bucket, packed) {plans}; against 16d's answers "
        f"classify max |d log p| {cls_err:.3e} (atol "
        f"{2 * GLUE_SERVE_ATOL:g}), fill_mask max |d log p| vs dense "
        f"{fill_err_e:.3e}, {swaps} top-k ranks swapped at ties; "
        f"{stats['forwards']} forwards (warmup included), "
        f"#4 {want_infer} launches ({layers} per forward), wall "
        f"{stats['wall_s']} s; phase 16 seconds "
        f"{ {k: round(v, 2) for k, v in out['seconds'].items()} } on {card}")
    return out


# -- phase 17: data-parallel and fully-sharded pretraining -------------------

# 17a: phase 6's rows (its four global batches of 16, seeds 0-3, as one
# dataset) through torchrun at world size 1, --mesh dp=1, on nccl.
# 17b / 17c: two ranks sharing the card (so gloo: NCCL refuses two ranks
# on one device) at BERT-large width cut to P17_LAYERS layers, a local
# batch of 4 a rank (2 ranks x 4 rows x 2 microbatches = phase 6's 16
# rows a step): 17b --mesh dp=2, P17B_STEPS steps at dropout 0, at 0.1 and
# at 0.1 with --overlap_grad_reduce; 17c --mesh fsdp=2, P17C_STEPS steps,
# then a sharded and a gathered save of the same state, each resumed at
# world size 1 in this process.
P17_LAYERS = 6
P17_LOCAL_BATCH = TRAIN_LOCAL_BATCH // 2
P17B_STEPS, P17C_STEPS = 3, 2
P17_DATA_SEED = 17
P17_CHILD_TIMEOUT_S = 420
# 17b's first dp=2 step at dropout 0 against one process on the same 16
# rows: the same sums, with bf16 activations through GEMMs of 4 rows a
# microbatch against 8 (cuBLAS may take other kernels), and the loss
# summed in another order over the ranks: relative 2e-3 on an fp32 mean
# near ln(30528) + ln(2).
P17_LOSS_RTOL = 2e-3
# --overlap_grad_reduce against the plain reduction: the same sums, so
# the fp32 master weights within 1e-6 after P17B_STEPS steps.
P17_OVERLAP_ATOL = 1e-6
DIST_CHILD = ("import sys; sys.path.insert(0, sys.argv[1]); "
              "import chip_smoke; sys.exit(chip_smoke.dist_child("
              "sys.argv[2:]))")


class ConcatRows:
    """The rows of several datasets, one after another (the runner's
    sampler, loader and resume take it as they take the shards)."""

    packed = False
    max_sequences_per_pack = 1

    def __init__(self, parts):
        self.parts = list(parts)

    def set_epoch(self, epoch: int) -> None:
        for part in self.parts:
            part.set_epoch(epoch)

    def __len__(self) -> int:
        return sum(len(p) for p in self.parts)

    def __getitem__(self, idx: int):
        for part in self.parts:
            if idx < len(part):
                return part[idx]
            idx -= len(part)
        raise IndexError(idx)


def phase6_rows():
    """Phase 6's batches as rows: batch i is synthetic_pretraining_batch(i,
    16, ...), which is SyntheticPretrainingDataset(i, 16, ...) at epoch 0,
    row for row (the same samples and per-row mask generators)."""
    from bert_pytorch_tpu_torch.tools.make_synthetic_data import (
        SyntheticPretrainingDataset)

    return ConcatRows(SyntheticPretrainingDataset(
        i, TRAIN_LOCAL_BATCH * TRAIN_ACCUM, TRAIN_SEQ, FEED_VOCAB,
        FEED_MAX_PRED) for i in range(TRAIN_STEPS))


def params_digest(model) -> str:
    """sha256 of every parameter's bytes (the whole tensor, gathered under
    FSDP), in the state dict's order."""
    import hashlib

    from bert_pytorch_tpu_torch.parallel import sharding

    digest = hashlib.sha256()
    for _, value in sorted(sharding.full_state_dict(model).items()):
        digest.update(value.detach().float().cpu().numpy().tobytes())
    return digest.hexdigest()


def child_kernels() -> dict:
    from bert_pytorch_tpu_torch.ops.kernels import attention as a, build
    from bert_pytorch_tpu_torch.ops.kernels.layernorm import layer_norm_fwd

    build.build()  # the parent's libraries: a load, not an nvcc
    kernels = {name: getattr(a, name) for name in TRAIN_REPLACES}
    kernels["layer_norm_fwd"] = layer_norm_fwd
    return kernels


def counted(kernels: dict) -> tuple:
    return ({name: k.launches for name, k in kernels.items()},
            {name: dict(k.route_launches) for name, k in kernels.items()
             if hasattr(k, "route_launches")})


def timed_reductions() -> list:
    """Wrap ``GradReducer.finish`` (the step's gradient reduction after
    the last backward: all of it, or what the overlap left exposed) so
    that each call's seconds, the card synchronized before and after,
    land in the returned list."""
    from bert_pytorch_tpu_torch.parallel import overlap

    seconds = []
    # The reducer's own finish, however many runs this process times.
    finish = getattr(overlap.GradReducer, "untimed_finish",
                     overlap.GradReducer.finish)
    overlap.GradReducer.untimed_finish = finish

    def timed(self):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        finish(self)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)

    overlap.GradReducer.finish = timed
    return seconds


def child_17a(spec: dict, kernels: dict) -> dict:
    """17a in a torchrun rank: run_pretraining.main on phase 6's rows."""
    from bert_pytorch_tpu_torch import run_pretraining

    args = run_pretraining.parse_arguments(spec["argv"])
    dataset = phase6_rows()
    reduce_s = timed_reductions()
    torch.cuda.synchronize()
    zero_counts(kernels)
    t0 = time.perf_counter()
    summary = run_pretraining.main(args, dataset)
    wall = time.perf_counter() - t0
    launches, routes = counted(kernels)
    return {"launches": launches, "routes": routes, "wall_s": wall,
            "backend": args.backend, "world_size": args.world_size,
            "mesh": args.mesh_spec.canonical(),
            "step_s": [b - a for a, b in summary["step_times"]],
            "reduce_s": reduce_s,
            "losses": train_losses(feed_records(args.output_dir))
            if args.rank == 0 else None}


def child_dp_run(kernels: dict, out: str, config: str, mesh: str,
                 steps: int, extra=()) -> tuple:
    """One run of the runner's own functions under ``mesh`` on the
    phase's rows: (result, model, optimizer, args, config, first
    batch)."""
    from bert_pytorch_tpu_torch import pretrain, run_pretraining

    args = run_pretraining.setup_training(run_pretraining.parse_arguments(
        feed_argv(out, ["--mesh", mesh, "--steps", str(steps),
                        "--local_batch_size", str(P17_LOCAL_BATCH),
                        *extra], config)))
    model, cfg = run_pretraining.prepare_model(args)
    optimizer, schedule = run_pretraining.prepare_optimizer(args, model)
    step = run_pretraining.make_step(args, model, optimizer, schedule, cfg)
    loader, _ = run_pretraining.prepare_dataset(
        args, cfg, None, feed_dataset(P17_DATA_SEED, TRAIN_LOCAL_BATCH
                                      * TRAIN_ACCUM * steps))
    hosts = iter(loader)
    batches = [pretrain.to_device(pretrain.stack_microbatches(
        next(hosts), args.accumulation_steps), args.device)
        for _ in range(steps)]
    hosts.close()
    reduce_s = timed_reductions()
    torch.cuda.synchronize()
    zero_counts(kernels)
    losses, digests, step_s = [], [], []
    for batch in batches:
        t0 = time.perf_counter()
        metrics = step(batch)
        losses.append(float(metrics["loss"]))  # synchronises
        step_s.append(time.perf_counter() - t0)
        digests.append(params_digest(model))
    launches, routes = counted(kernels)
    reducer = getattr(step, "reducer", None)
    result = {"losses": losses, "digests": digests, "step_s": step_s,
              "reduce_s": reduce_s,
              "launches": launches, "routes": routes,
              "backend": args.backend, "mesh": args.mesh_spec.canonical(),
              "accumulation": args.accumulation_steps,
              "bucket_launches": reducer.launches[:3] if reducer else None}
    return result, model, optimizer, args, cfg, batches[0]


def child_17bc(spec: dict, kernels: dict) -> dict:
    """17b and 17c in one of two torchrun ranks sharing the card."""
    from bert_pytorch_tpu_torch import run_pretraining
    from bert_pytorch_tpu_torch.parallel import launcher, sharding

    rank = int(os.environ["RANK"])
    out = spec["out"]
    results = {}
    plain = None
    for label, config, extra in (
            ("dropout0", spec["config0"], ()),
            ("dropout", spec["config"], ()),
            ("overlap", spec["config"], ("--overlap_grad_reduce",))):
        result, model, optimizer, args, cfg, first = child_dp_run(
            kernels, os.path.join(out, label), config, "dp=2", P17B_STEPS,
            extra)
        if label == "dropout0":
            np.savez(os.path.join(out, f"batch.rank{rank}.npz"),
                     **{k: v.cpu().numpy() for k, v in first.items()})
        params = {n: p.detach().float().cpu()
                  for n, p in model.named_parameters()}
        if label == "dropout":
            plain = params
        if label == "overlap":
            result["overlap_max_abs_diff"] = max(
                (params[n] - plain[n]).abs().max().item() for n in params)
        results[label] = result
        del model, optimizer, params
        torch.cuda.empty_cache()
    # 17c
    log(f"[dp] rank {rank}: 17b done; 17c fsdp=2")
    result, model, optimizer, args, cfg, _ = child_dp_run(
        kernels, os.path.join(out, "fsdp"), spec["config0"], "fsdp=2",
        P17C_STEPS)
    log(f"[dp] rank {rank}: 17c steps done; saves")
    result["sharded"] = sharding.is_fsdp(model)
    t0 = time.perf_counter()
    for layout in ("sharded", "gathered"):
        run_pretraining.write_checkpoint(
            os.path.join(out, f"ckpt_{layout}", "pretrain_ckpts"),
            P17C_STEPS, model, optimizer, cfg, {"index": 0}, 0,
            layout=layout, mesh_spec=args.mesh_spec.as_dict())
        result[f"{layout}_save_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
    results["fsdp"] = result
    launcher.shutdown()
    return results


def dist_child(argv) -> int:
    """A torchrun rank of phase 17: ``dist_child([mode, spec.json])``
    writes its results to ``<out>/<mode>.rank<r>.json``."""
    import faulthandler

    faulthandler.enable()  # a rank that crashes prints its Python stack
    mode, spec_path = argv
    with open(spec_path, encoding="utf-8") as f:
        spec = json.load(f)
    kernels = child_kernels()
    result = {"17a": child_17a, "17bc": child_17bc,
              "18": child_18, "20": child_20,
              "18_20": child_18_20}[mode](spec, kernels)
    rank = int(os.environ["RANK"])
    with open(os.path.join(spec["out"], f"{mode}.rank{rank}.json"), "w",
              encoding="utf-8") as f:
        json.dump(result, f)
    return 0


def child_18_20(spec: dict, kernels: dict) -> dict:
    """Phases 18 and 20 in one torchrun rank: ``child_18`` then
    ``child_20`` on the same process group."""
    from bert_pytorch_tpu_torch.parallel import launcher

    result = {"18": child_18(spec["18"], kernels, shutdown=False),
              "20": child_20(spec["20"], kernels, shutdown=False)}
    launcher.shutdown()
    return result


def torchrun(mode: str, nproc: int, spec: dict) -> tuple:
    """``python -m torch.distributed.run --standalone --nproc_per_node
    nproc`` of :func:`dist_child`; (each rank's results, seconds)."""
    path = os.path.join(spec["out"], f"{mode}.json")
    with open(path, "w", encoding="utf-8") as f:
        json.dump(spec, f)
    t0 = time.perf_counter()
    done = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", str(nproc), "--no-python", sys.executable,
         "-c", DIST_CHILD, REPO, mode, path],
        cwd=REPO, capture_output=True, text=True,
        timeout=P17_CHILD_TIMEOUT_S)
    seconds = time.perf_counter() - t0
    if done.returncode != 0:
        raise AssertionError(f"phase {mode} torchrun rc {done.returncode}: "
                             f"{done.stdout[-3000:]} {done.stderr[-4000:]}")
    results = []
    for rank in range(nproc):
        with open(os.path.join(spec["out"], f"{mode}.rank{rank}.json"),
                  encoding="utf-8") as f:
            results.append(json.load(f))
    return results, seconds, done.stdout


def check_dp_launches(label: str, launches: dict, routes: dict,
                      layers: int, steps: int) -> None:
    """Phase 6's counts per step (remat dots recomputes the forward), all
    on the tensor cores, the LayerNorm kernel never."""
    check_launches_per_step(launches, routes, layers, TRAIN_ACCUM, steps)
    log(f"[dp] {label}: launches {launches}, by route {routes}")


def resume_world1(kernels: dict, out: str, config: str, batch: dict) -> dict:
    """17c: the runner at world size 1 resumed from ``out``, then one step
    on ``batch``: its state and the step's loss."""
    r = runner(out, PHASE2, ["--local_batch_size", str(TRAIN_LOCAL_BATCH),
                             "--global_batch_size",
                             str(TRAIN_LOCAL_BATCH * TRAIN_ACCUM),
                             "--attention_backend", "flash",
                             "--previous_phase_end_step", "0"], config)
    resumed = host_copy(training_state(r))
    loss = float(runner_step(r)(batch)["loss"])
    return {"global_step": r["global_step"], "resumed": resumed,
            "after": host_copy(training_state(r)), "loss": loss,
            "resume_s": r["resume_s"]}


def drive_mesh(kernels: dict, root: str, card: str,
               phase6_losses: list) -> dict:
    """Phase 17: the port's pretraining across ranks, through torchrun.

    17a: ``run_pretraining.main`` at world size 1 on nccl (``--mesh
    dp=1``: the data-parallel step, its reductions over one rank) at
    BERT-large's full width and depth in phase 6's shape on phase 6's
    rows, 4 steps: #1-#3 96/48/48 per step on the tensor cores, and the
    losses phase 6's bit for bit (rank 0's dropout seeds are the
    single-process draw).
    17b: two ranks sharing the card over gloo, --mesh dp=2, P17_LAYERS
    layers, P17B_STEPS steps at dropout 0 and 0.1: both ranks' parameters
    bit-equal after every step, the launches phase 6's per step on each
    rank, and at dropout 0 the first loss within P17_LOSS_RTOL of one
    process's step on the same 16 rows; --overlap_grad_reduce (its
    buckets heads, encoder, embeddings) within P17_OVERLAP_ATOL of the
    plain reduction's fp32 weights.
    17c: --mesh fsdp=2 on the same ranks, P17C_STEPS steps, then a sharded
    save (a shard file a rank) and a gathered one of the same state; a
    runner at world size 1 resumes each: the restored states bit-equal,
    and the next step from each bit-equal."""
    from bert_pytorch_tpu_torch import pretrain, run_pretraining
    from bert_pytorch_tpu_torch.tools.make_synthetic_data import (
        synthetic_pretraining_batch)

    t_phase = time.perf_counter()
    out = os.path.join(root, "mesh")
    os.makedirs(out)
    # 17a
    argv = feed_argv(os.path.join(out, "dp1"), [
        "--mesh", "dp=1", "--steps", str(TRAIN_STEPS)])
    (a,), a_s, a_stdout = torchrun("17a", 1, {"out": out, "argv": argv})
    check_dp_launches("17a", a["launches"], a["routes"], 24, TRAIN_STEPS)
    losses = [a["losses"][str(s)] for s in range(1, TRAIN_STEPS + 1)]
    if (a["backend"], a["world_size"], a["mesh"]) != ("nccl", 1, "dp=1"):
        raise AssertionError(f"17a ran {a['backend']}, world "
                             f"{a['world_size']}, mesh {a['mesh']}")
    if "event mesh" not in a_stdout:
        raise AssertionError(f"17a printed no mesh line: {a_stdout[-1500:]}")
    if losses != phase6_losses:
        raise AssertionError(f"17a losses {losses} differ from phase 6's "
                             f"{phase6_losses}")
    log(f"[dp] 17a torchrun world 1 ({a['backend']}, mesh {a['mesh']}), "
        f"BERT-large phase 2, {TRAIN_STEPS} steps: losses {losses}, phase "
        f"6's bit for bit; steps {[round(s, 4) for s in a['step_s']]} s, "
        f"the reduction of each (one rank on nccl) "
        f"{[round(s, 4) for s in a['reduce_s']]} s; "
        f"main() {a['wall_s']:.1f} s, torchrun {a_s:.1f} s on {card}")
    # 17b, 17c
    config0 = cut_config(out, num_hidden_layers=P17_LAYERS,
                         hidden_dropout_prob=0.0,
                         attention_probs_dropout_prob=0.0)
    cut = os.path.join(out, "dropout")
    os.makedirs(cut)
    config = cut_config(cut, num_hidden_layers=P17_LAYERS)
    ranks, bc_s, _ = torchrun("17bc", 2, {"out": out, "config0": config0,
                                          "config": config})
    for label in ("dropout0", "dropout", "overlap"):
        r0, r1 = ranks[0][label], ranks[1][label]
        if (r0["backend"], r0["mesh"], r0["accumulation"]) != (
                "gloo", "dp=2", TRAIN_ACCUM):
            raise AssertionError(f"17b {label}: {r0['backend']} "
                                 f"{r0['mesh']} A={r0['accumulation']}")
        if r0["digests"] != r1["digests"] or r0["losses"] != r1["losses"]:
            raise AssertionError(f"17b {label}: the ranks' parameters "
                                 f"differ after a step: {r0['digests']} vs "
                                 f"{r1['digests']}")
        for rank, res in enumerate((r0, r1)):
            check_dp_launches(f"17b {label} rank {rank}", res["launches"],
                              res["routes"], P17_LAYERS, P17B_STEPS)
    if ranks[0]["overlap"]["bucket_launches"] != ["heads", "encoder",
                                                  "embeddings"]:
        raise AssertionError(f"17b overlap buckets "
                             f"{ranks[0]['overlap']['bucket_launches']}")
    overlap_diff = max(r["overlap"]["overlap_max_abs_diff"] for r in ranks)
    if overlap_diff > P17_OVERLAP_ATOL:
        raise AssertionError(f"17b --overlap_grad_reduce off the plain "
                             f"reduction by {overlap_diff}")
    # One process, the same 16 rows: rank r's rows of microbatch a are
    # rows 4r..4r+3 of the global microbatch a.
    halves = [dict(np.load(os.path.join(out, f"batch.rank{r}.npz")))
              for r in range(2)]
    batch = {k: torch.from_numpy(np.concatenate([h[k] for h in halves],
                                                axis=1)).cuda()
             for k in halves[0]}
    args = run_pretraining.setup_training(run_pretraining.parse_arguments(
        feed_argv(os.path.join(out, "single"), ["--steps", "1"], config0)))
    model, cfg = run_pretraining.prepare_model(args)
    optimizer, schedule = run_pretraining.prepare_optimizer(args, model)
    single = float(run_pretraining.make_step(
        args, model, optimizer, schedule, cfg)(batch)["loss"])
    del model, optimizer
    torch.cuda.empty_cache()
    dp_loss = ranks[0]["dropout0"]["losses"][0]
    if abs(dp_loss / single - 1.0) > P17_LOSS_RTOL:
        raise AssertionError(f"17b dp=2 first loss {dp_loss}, one process "
                             f"{single}: beyond {P17_LOSS_RTOL}")
    log(f"[dp] 17b two ranks on one card (gloo), dp=2, {P17_LAYERS} "
        f"layers, {P17B_STEPS} steps: parameters bit-equal across ranks "
        f"after every step; losses at dropout 0 "
        f"{ranks[0]['dropout0']['losses']}, 0.1 "
        f"{ranks[0]['dropout']['losses']}, overlap "
        f"{ranks[0]['overlap']['losses']}; first step against one process "
        f"{dp_loss} / {single} (rel {abs(dp_loss / single - 1):.3e}); "
        f"overlap vs plain max |w| diff {overlap_diff:.3e}; step s plain "
        f"{[round(s, 3) for s in ranks[0]['dropout']['step_s']]}, overlap "
        f"{[round(s, 3) for s in ranks[0]['overlap']['step_s']]}; the "
        f"reduction after the last backward (gloo) plain "
        f"{[round(s, 3) for s in ranks[0]['dropout']['reduce_s']]} s, "
        f"overlap (exposed) "
        f"{[round(s, 3) for s in ranks[0]['overlap']['reduce_s']]} s on "
        f"{card}")
    # 17c
    f0, f1 = ranks[0]["fsdp"], ranks[1]["fsdp"]
    if not f0["sharded"] or f0["mesh"] != "dp=1,fsdp=2" or (
            f0["digests"] != f1["digests"]):
        raise AssertionError(f"17c: sharded {f0['sharded']}, mesh "
                             f"{f0['mesh']}, digests {f0['digests']} / "
                             f"{f1['digests']}")
    for rank, res in enumerate((f0, f1)):
        check_dp_launches(f"17c rank {rank}", res["launches"], res["routes"],
                          P17_LAYERS, P17C_STEPS)
    shard_dir = os.path.join(out, "ckpt_sharded", "pretrain_ckpts")
    files = sorted(os.listdir(shard_dir))
    if not {f"ckpt_{P17C_STEPS}.shard0of2.msgpack",
            f"ckpt_{P17C_STEPS}.shard1of2.msgpack"} <= set(files):
        raise AssertionError(f"17c sharded save wrote {files}")
    next_batch = pretrain.to_device(pretrain.stack_microbatches(
        synthetic_pretraining_batch(
            P17_DATA_SEED + 1, TRAIN_LOCAL_BATCH * TRAIN_ACCUM, TRAIN_SEQ,
            FEED_VOCAB, FEED_MAX_PRED), TRAIN_ACCUM), "cuda")
    sharded = resume_world1(kernels, os.path.join(out, "ckpt_sharded"),
                            config0, next_batch)
    gathered = resume_world1(kernels, os.path.join(out, "ckpt_gathered"),
                             config0, next_batch)
    if sharded["global_step"] != P17C_STEPS or \
            gathered["global_step"] != P17C_STEPS:
        raise AssertionError(f"17c resumed at {sharded['global_step']} / "
                             f"{gathered['global_step']}")
    check_same_state("17c sharded resume vs gathered", sharded["resumed"],
                     gathered["resumed"])
    check_same_state("17c step after the sharded resume vs the gathered",
                     sharded["after"], gathered["after"])
    if sharded["loss"] != gathered["loss"]:
        raise AssertionError(f"17c resumed step loss {sharded['loss']} vs "
                             f"{gathered['loss']}")
    phase_s = time.perf_counter() - t_phase
    log(f"[dp] 17c fsdp=2 on the two ranks, {P17C_STEPS} steps, losses "
        f"{f0['losses']}; saves sharded {f0['sharded_save_s']:.2f} s, "
        f"gathered {f0['gathered_save_s']:.2f} s; resumed at world size 1 "
        f"in {sharded['resume_s']:.2f} / {gathered['resume_s']:.2f} s, "
        f"states and the next step bit-equal (loss {sharded['loss']}); "
        f"torchrun 17a {a_s:.1f} s, 17b+17c {bc_s:.1f} s; phase 17 "
        f"{phase_s:.1f} s on {card}")
    shutil.rmtree(out)
    return {"dp1": a, "dp2": {k: ranks[0][k] for k in
                              ("dropout0", "dropout", "overlap")},
            "fsdp2": f0, "single_loss": single, "dp2_first_loss": dp_loss,
            "overlap_max_abs_diff": overlap_diff,
            "resume_loss": sharded["loss"],
            "torchrun_s": {"17a": a_s, "17bc": bc_s}, "seconds": phase_s,
            "launches": {
                "dp1": a["launches"],
                "dp2": {name: sum(ranks[0][k]["launches"][name] for k in
                                  ("dropout0", "dropout", "overlap"))
                        for name in a["launches"]},
                "fsdp2": f0["launches"]}}


# -- phase 18: model-parallel pretraining ------------------------------------

# One torchrun launch of 4 ranks sharing the card (gloo), BERT-large width
# cut to P17_LAYERS layers, 16 rows a step from the phase's seeded rows
# (P18_DATA_SEED), bf16, remat dots, the runner's own functions:
# 18a --mesh pipe=2,model=2 (local batch 8: 2 microbatches through 2
# stages), P18A_STEPS steps at dropout 0, then a sharded save resumed at
# world size 1 in this process; 18b --mesh pipe=2,seq=2 at S=512 (the
# ring inside each stage), one step at dropout 0 and one at 0.1; 18c
# --mesh dp=4 --kfac (local batch 4, factors and inverses every step),
# P18C_STEPS steps at dropout 0.
P18_WORLD = 4
P18A_STEPS, P18C_STEPS = 2, 2
P18_DATA_SEED = 18
P18_CHILD_TIMEOUT_S = 420
# 18c's first K-FAC update (the preconditioned gradients of step 1, what
# the optimizer receives) against one process's K-FAC step on the same 16
# rows: relative L2 distance over every parameter, at most 0.1. What it
# must let through is bf16 rounding: the gradients and factors come from
# GEMMs of 4 rows a rank against 16, through 6 layers of bf16 backward,
# and the damped inverses amplify a relative perturbation by up to their
# condition number. Readings on the card (NVIDIA H100 80GB HBM3, 700.00
# W): the dp=4 update 3.128e-2 off one process's; one process's own
# update with fp32 inverses 1.460e-2 off its bf16 one (about half the gap
# is the inverses' storage); the planted fault (next) 0.5215. A first bar
# of 3e-2, set before any reading, sat under the rounding; 0.1 sits
# between the two readings. (Not LAMB's parameter step: its first step
# is sign(g) elementwise, which turns the rounding of a near-zero
# gradient into a full step; it read 0.319.)
P18_KFAC_UPDATE_RTOL = 0.1
# Held against that bar in every run: one process's K-FAC update with a
# planted fault, the factors of a dp=4 rank that leaves out the "x
# replicas" of its row count and per-sample scale (A 4x too large, G 4x
# too small), must land beyond it; one process's update with fp32
# inverses is read beside it.

# 18b's ring attention layer on the card, against the plain dense
# attention on the whole sequence with the ring's own dropout masks laid
# into the [S, S] grid: one layer at 18b's shape (8 rows, S=512, 16
# heads of 64, bf16; the last P18B_RING_PAD keys of every other row
# padded), at dropout 0 and P18B_RING_RATE, its output and q/k/v
# gradients within TRAIN_TOL's bf16 bars (those of #1-#3 against their
# plain versions), the masks' kept share within P18B_KEEP_ATOL of
# 1 - rate.
P18B_RING_RATE = 0.1
P18B_RING_SEED = 0x18B
P18B_RING_PAD = 64
P18B_KEEP_ATOL = 1e-3


def whole_state_digest(model, optimizer) -> str:
    """sha256 of every parameter and both moments, whole (gathered over
    FSDP, pipe and model: a collective under a layout), by name."""
    import hashlib

    from bert_pytorch_tpu_torch import run_pretraining
    from bert_pytorch_tpu_torch.optim import transforms
    from bert_pytorch_tpu_torch.parallel import sharding

    regroup = run_pretraining.whole_parts(model)
    params = dict(model.named_parameters())
    state = regroup({n: v for n, v in sharding.full_state_dict(
        model).items() if n in params})
    mu, nu = (regroup({n: sharding.gather_like(t, params[n])
                       for n, t in m.items()})
              for m in transforms.moments(optimizer, params))
    digest = hashlib.sha256()
    for tree in (state, mu, nu):
        for _, value in sorted(tree.items()):
            digest.update(value.detach().float().cpu().numpy().tobytes())
    return digest.hexdigest()


def kfac_state_digest(state) -> str:
    import hashlib

    digest = hashlib.sha256()
    for field in ("a", "g", "qa", "la", "qg", "lg"):
        for _, value in sorted(getattr(state, field).items()):
            digest.update(value.detach().float().cpu().numpy().tobytes())
    digest.update(str(int(state.count)).encode())
    return digest.hexdigest()


def whole_grads(model) -> dict:
    """Every parameter's ``.grad`` whole, fp32 on the host (gathered over
    FSDP, pipe and model: a collective under a layout)."""
    from bert_pytorch_tpu_torch import run_pretraining
    from bert_pytorch_tpu_torch.parallel import sharding

    named = {n: sharding.gather_like(sharding.local(p.grad), p)
             for n, p in model.named_parameters()}
    return {n: t.detach().float().cpu()
            for n, t in run_pretraining.whole_parts(model)(named).items()}


def child_18_run(kernels: dict, out: str, config: str, mesh: str,
                 steps: int, local_batch: int, extra=(),
                 keep_first: bool = False, seed: int = P18_DATA_SEED,
                 data_steps: int = 0) -> tuple:
    """One run of the runner's functions under ``mesh`` on the phase's
    rows (``seed``'s, ``data_steps`` steps of them: ``steps`` when 0):
    (result, model, optimizer, args, config, kfac state)."""
    from bert_pytorch_tpu_torch import pretrain, run_pretraining

    args = run_pretraining.setup_training(run_pretraining.parse_arguments(
        feed_argv(out, ["--mesh", mesh, "--steps", str(steps),
                        "--local_batch_size", str(local_batch), *extra],
                  config)))
    model, cfg = run_pretraining.prepare_model(args)
    optimizer, schedule = run_pretraining.prepare_optimizer(args, model)
    kfac, kfac_state = run_pretraining.prepare_kfac(args, model, cfg)
    step = run_pretraining.make_step(args, model, optimizer, schedule, cfg,
                                     kfac, kfac_state)
    loader, _ = run_pretraining.prepare_dataset(
        args, cfg, None, feed_dataset(seed, TRAIN_LOCAL_BATCH * TRAIN_ACCUM
                                      * (data_steps or steps)))
    hosts = iter(loader)
    batches = [pretrain.to_device(pretrain.stack_microbatches(
        next(hosts), args.accumulation_steps), args.device)
        for _ in range(steps)]
    hosts.close()
    torch.cuda.synchronize()
    zero_counts(kernels)
    losses, step_s, first_update = [], [], None
    for i, batch in enumerate(batches):
        t0 = time.perf_counter()
        metrics = step(batch)
        losses.append(float(metrics["loss"]))  # synchronises
        step_s.append(time.perf_counter() - t0)
        if keep_first and i == 0:
            # The optimizer's input: the preconditioned gradients.
            first_update = whole_grads(model)
    launches, routes = counted(kernels)
    result = {"losses": losses, "step_s": step_s, "launches": launches,
              "routes": routes, "backend": args.backend,
              "data_index": args.data_index,
              "mesh": args.mesh_spec.canonical(),
              "accumulation": args.accumulation_steps,
              "attention_backend": args.attention_backend,
              "peak_bytes": torch.cuda.max_memory_allocated()}
    result["first_update"] = first_update
    result["first_batch"] = {k: v.cpu().numpy() for k, v in
                             batches[0].items()}
    return result, model, optimizer, args, cfg, kfac_state


def ring_layer_check(seq, rows: int, heads: int, depth: int) -> dict:
    """One ring attention layer over the ``seq`` group (this rank's S/n
    slice) on the card at dropout 0 and P18B_RING_RATE, forward and
    backward, against the plain dense attention on the whole sequence in
    fp32 with the same dropout masks (each block's ``keep_scale`` at its
    ``block_seed``, laid where that block's keys meet its queries).
    Returns, per rate, the worst |ring - plain| / (atol + rtol
    |plain|) of the output and of dq, dk, dv at TRAIN_TOL's bf16 bars
    (at most 1 passes) and the masks' kept share."""
    from bert_pytorch_tpu_torch.ops.ring import (block_seed, keep_scale,
                                                 ring_attention)

    n, r = seq.size, seq.index
    width = TRAIN_SEQ // n
    gen = torch.Generator(device="cuda").manual_seed(P18_DATA_SEED)
    shape = (rows, TRAIN_SEQ, heads, depth)
    q, k, v, d_out = (torch.randn(shape, generator=gen, device="cuda")
                      .to(torch.bfloat16) for _ in range(4))
    bias = torch.zeros((rows, TRAIN_SEQ), device="cuda")
    bias[::2, -P18B_RING_PAD:] = -10000.0  # make_attention_bias' value
    mine = slice(r * width, (r + 1) * width)
    tol = TRAIN_TOL[torch.bfloat16]
    out = {}
    for rate in (0.0, P18B_RING_RATE):
        ql, kl, vl = (t[:, mine].clone().requires_grad_(True)
                      for t in (q, k, v))
        got = ring_attention(ql, kl, vl, bias[:, mine].contiguous(), seq,
                             rate, P18B_RING_SEED if rate else None)
        got.backward(d_out[:, mine])
        # The plain version over the whole sequence: every rank's
        # queries, whose gradients reach this rank's keys round the ring.
        keep = torch.ones((rows, heads, TRAIN_SEQ, TRAIN_SEQ), device="cuda")
        if rate:
            for src_q in range(n):
                for step in range(n):
                    src_k = (src_q - step) % n  # held at this ring step
                    keep[:, :, src_q * width:(src_q + 1) * width,
                         src_k * width:(src_k + 1) * width] = keep_scale(
                        (rows, heads, width, width), rate,
                        block_seed(P18B_RING_SEED, src_q, step), "cuda")
        q32, k32, v32 = (t.float().requires_grad_(True) for t in (q, k, v))
        scores = torch.einsum("bqhd,bkhd->bhqk", q32, k32) / (
            depth ** 0.5) + bias[:, None, None, :]
        want = torch.einsum("bhqk,bkhd->bqhd",
                            torch.softmax(scores, dim=-1) * keep, v32)
        want.backward(d_out.float())
        worst = {}
        for name, x, y in (("out", got, want), ("dq", ql.grad, q32.grad),
                           ("dk", kl.grad, k32.grad),
                           ("dv", vl.grad, v32.grad)):
            atol, rtol = tol[name]
            y = y[:, mine]
            worst[name] = float(((x.float() - y).abs()
                                 / (atol + rtol * y.abs())).max())
        worst["kept"] = float((keep > 0).float().mean())
        out[str(rate)] = worst
    return out


def child_18(spec: dict, kernels: dict, shutdown: bool = True) -> dict:
    """18a, 18b and 18c in one of the four torchrun ranks sharing the
    card (``shutdown``: leave the process group after them)."""
    from bert_pytorch_tpu_torch import run_pretraining
    from bert_pytorch_tpu_torch.parallel import launcher
    from bert_pytorch_tpu_torch.parallel.mesh import AXIS_SEQ

    t_child = time.perf_counter()
    rank = int(os.environ["RANK"])
    out = spec["out"]
    results = {}
    # 18a
    res, model, optimizer, args, cfg, _ = child_18_run(
        kernels, os.path.join(out, "pp_tp"), spec["config0"],
        "pipe=2,model=2", P18A_STEPS, TRAIN_LOCAL_BATCH)
    if rank == 0:
        np.savez(os.path.join(out, "batch18.npz"), **res["first_batch"])
    t0 = time.perf_counter()
    run_pretraining.write_checkpoint(
        os.path.join(out, "ckpt_pp_tp", "pretrain_ckpts"), P18A_STEPS,
        model, optimizer, cfg, {"index": 0}, 0, layout="sharded",
        mesh_spec=args.mesh_spec.as_dict())
    res["sharded_save_s"] = time.perf_counter() - t0
    res["digest"] = whole_state_digest(model, optimizer)
    res["transport"] = args.layout.transports()
    res.pop("first_batch")
    res.pop("first_update")
    results["18a"] = res
    del model, optimizer
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    log(f"[mp] rank {rank}: 18a done; 18b pipe=2,seq=2")
    # 18b: dropout 0 then 0.1, one step each
    for label, config in (("dropout0", spec["config0"]),
                          ("dropout", spec["config"])):
        res, model, optimizer, args, cfg, _ = child_18_run(
            kernels, os.path.join(out, f"pp_sp_{label}"), config,
            "pipe=2,seq=2", 1, TRAIN_LOCAL_BATCH)
        res.pop("first_batch")
        res.pop("first_update")
        res["transport"] = args.layout.transports()
        if label == "dropout0":
            res["ring_layer"] = ring_layer_check(
                args.layout.axis(AXIS_SEQ), TRAIN_LOCAL_BATCH,
                cfg.num_attention_heads,
                cfg.hidden_size // cfg.num_attention_heads)
        results[f"18b_{label}"] = res
        del model, optimizer
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    log(f"[mp] rank {rank}: 18b done; 18c dp=4 --kfac")
    # 18c
    res, model, optimizer, args, cfg, kstate = child_18_run(
        kernels, os.path.join(out, "kfac"), spec["config0"], "dp=4",
        P18C_STEPS, TRAIN_LOCAL_BATCH * TRAIN_ACCUM // P18_WORLD,
        ["--kfac", "--kfac_factor_interval", "1", "--kfac_inv_interval", "1"],
        keep_first=True)
    res["kfac_digest"] = kfac_state_digest(kstate)
    if rank == 0:
        torch.save(res["first_update"], os.path.join(out, "update18c.pt"))
        np.savez(os.path.join(out, "batch18c.r0.npz"), **res["first_batch"])
    else:
        np.savez(os.path.join(out, f"batch18c.r{rank}.npz"),
                 **res["first_batch"])
    res.pop("first_update")
    res.pop("first_batch")
    results["18c"] = res
    results["child_s"] = time.perf_counter() - t_child
    if shutdown:
        launcher.shutdown()
    return results


def check_launches_per_rank(label: str, launches: dict, routes: dict,
                            layers: int, accumulation: int,
                            steps: int) -> None:
    """#1-#3 at phase 6's rate for the layers one rank runs (remat dots
    recomputes the forward: 2/1/1 a layer a microbatch), all on the
    tensor cores; 0 when ``layers`` is 0 (ring layers)."""
    per = layers * accumulation * steps
    want = {"flash_attention_fwd": 2 * per, "flash_attention_dq": per,
            "flash_attention_dkv": per, "layer_norm_fwd": 0}
    for name, n in want.items():
        if launches[name] != n:
            raise AssertionError(f"{label}: {name} launched {launches[name]} "
                                 f"times; expected {n}")
    for name in TRAIN_REPLACES:
        if routes[name]["tensor_cores"] != launches[name]:
            raise AssertionError(f"{label}: {name} by route {routes[name]}")


def single_process_step(out: str, config: str, batch: dict,
                        extra=(), tweak=None) -> tuple:
    """One runner step at world size 1 on ``batch`` (the 16 rows as one
    microbatch of 16 with ``--kfac``, else 2 of 8): (loss, model); the
    model's ``.grad`` hold what the optimizer received. ``tweak(kfac,
    kfac_state) -> kfac_state`` changes K-FAC before the step is built."""
    from bert_pytorch_tpu_torch import run_pretraining

    args = run_pretraining.setup_training(run_pretraining.parse_arguments(
        feed_argv(out, ["--steps", "1", *extra], config)))
    model, cfg = run_pretraining.prepare_model(args)
    optimizer, schedule = run_pretraining.prepare_optimizer(args, model)
    kfac, kfac_state = run_pretraining.prepare_kfac(args, model, cfg)
    if tweak is not None:
        kfac_state = tweak(kfac, kfac_state)
    step = run_pretraining.make_step(args, model, optimizer, schedule, cfg,
                                     kfac, kfac_state)
    loss = float(step(batch)["loss"])
    return loss, model


def unreplicated_factors(kfac, kfac_state):
    """The planted fault: factors folded as a dp=4 rank would fold them
    without the "x replicas" of its rows and per-sample scale (phase 20
    holds its layouts against the same fault)."""
    fold = kfac.ema_factors
    kfac.ema_factors = lambda state, sums, rows, scale: fold(
        state, sums, rows / P18_WORLD, scale / P18_WORLD)
    return kfac_state


def fp32_inverses(kfac, kfac_state):
    kfac.inv_dtype = torch.float32
    return kfac.init()


def update_rel(got: dict, want: dict) -> float:
    """Relative L2 distance of two updates over every parameter."""
    diff = math.sqrt(sum(float((got[n] - want[n]).square().sum())
                         for n in want))
    return diff / math.sqrt(sum(float(want[n].square().sum())
                                for n in want))


def phase_spec(root: str, name: str) -> dict:
    """A torchrun phase's directory under ``root`` and its two configs,
    BERT-large cut to P17_LAYERS layers: ``config0`` at dropout 0 and
    ``config`` at the config's own dropout."""
    out = os.path.join(root, name)
    os.makedirs(out)
    config0 = cut_config(out, num_hidden_layers=P17_LAYERS,
                         hidden_dropout_prob=0.0,
                         attention_probs_dropout_prob=0.0)
    cut = os.path.join(out, "dropout")
    os.makedirs(cut)
    return {"out": out, "config0": config0,
            "config": cut_config(cut, num_hidden_layers=P17_LAYERS)}


def drive_model_parallel(kernels: dict, root: str, card: str,
                         launched=None) -> dict:
    """Phase 18: the port's model-parallel pretraining, one torchrun launch
    of P18_WORLD ranks sharing the card over gloo (NCCL refuses two ranks
    on one device), at BERT-large width cut to P17_LAYERS layers.

    18a: ``--mesh pipe=2,model=2``, P18A_STEPS steps at dropout 0: the
    first loss within P17_LOSS_RTOL of one process's step on the same 16
    rows; a sharded save (a shard file a rank, the JAX slice records:
    ``layers`` on pipe, the rule-table axes on model) resumed by the
    runner at world size 1 here: its state digest equal to the ranks'
    whole state's. 18b: ``--mesh pipe=2,seq=2`` at S=512 (the runner
    switches to the ring), one step at dropout 0 (the same loss bar) and
    one at 0.1 (finite); then one ring layer on every rank against the
    plain dense attention with the ring's masks (:func:`ring_layer_check`).
    18c: ``--mesh dp=4 --kfac`` (fused capture, factors and inverses every
    step), P18C_STEPS steps: the K-FAC state digests equal on all ranks,
    the first update (the preconditioned gradients) within
    P18_KFAC_UPDATE_RTOL of one process's, and one process's update with
    the planted fault beyond it. Exact launch counts of #1-#3 per rank:
    18a each rank's 3 layers (H/2 heads each), 18c all 6, 18b none (ring
    layers launch no flash kernel). ``launched``: (spec, each rank's
    results, seconds) of a launch shared with phase 20
    (:func:`drive_phases_18_and_20`) instead of a launch of its own."""
    t_phase = time.perf_counter()
    if launched is None:
        spec = phase_spec(root, "model_parallel")
        ranks, run_s, _ = torchrun("18", P18_WORLD, spec)
    else:
        spec, ranks, run_s = launched
    out, config0 = spec["out"], spec["config0"]
    a = [r["18a"] for r in ranks]
    per_stage = P17_LAYERS // 2
    for rank, res in enumerate(a):
        check_launches_per_rank(f"18a rank {rank}", res["launches"],
                                res["routes"], per_stage, TRAIN_ACCUM,
                                P18A_STEPS)
    # gloo where the ranks share a card (NCCL refuses two ranks on one
    # device), nccl with a card a rank.
    backend = ("nccl" if torch.cuda.device_count() >= P18_WORLD else "gloo")
    if a[0]["mesh"] != "dp=1,pipe=2,model=2" or a[0]["backend"] != backend:
        raise AssertionError(f"18a mesh {a[0]['mesh']} {a[0]['backend']}, "
                             f"expected {backend}")
    if len({r["digest"] for r in a}) != 1 or len(
            {tuple(r["losses"]) for r in a}) != 1:
        raise AssertionError("18a: the ranks disagree on the state or the "
                             f"losses: {[r['losses'] for r in a]}")
    for label in ("18b_dropout0", "18b_dropout"):
        for rank, r in enumerate(ranks):
            res = r[label]
            check_launches_per_rank(f"{label} rank {rank}", res["launches"],
                                    res["routes"], 0, TRAIN_ACCUM, 1)
            if res["attention_backend"] != "ring" or not all(
                    np.isfinite(res["losses"])):
                raise AssertionError(f"{label} rank {rank}: backend "
                                     f"{res['attention_backend']}, losses "
                                     f"{res['losses']}")
    ring_layer = [r["18b_dropout0"]["ring_layer"] for r in ranks]
    for rank, by_rate in enumerate(ring_layer):
        for rate, worst in by_rate.items():
            kept = 1.0 - float(rate)
            if max(worst[k] for k in ("out", "dq", "dk", "dv")) > 1.0 or abs(
                    worst["kept"] - kept) > P18B_KEEP_ATOL:
                raise AssertionError(f"18b ring layer rank {rank} at "
                                     f"dropout {rate}: {worst}")
    c = [r["18c"] for r in ranks]
    for rank, res in enumerate(c):
        check_launches_per_rank(f"18c rank {rank}", res["launches"],
                                res["routes"], P17_LAYERS, 1, P18C_STEPS)
    if len({r["kfac_digest"] for r in c}) != 1:
        raise AssertionError(f"18c: K-FAC state digests differ: "
                             f"{[r['kfac_digest'][:12] for r in c]}")
    # One process on the same 16 rows (18a/18b's first batch).
    batch = {k: torch.from_numpy(v).cuda() for k, v in
             np.load(os.path.join(out, "batch18.npz")).items()}
    single, model = single_process_step(os.path.join(out, "single"),
                                        config0, batch)
    del model
    torch.cuda.empty_cache()
    rel = {label: abs(loss / single - 1.0) for label, loss in (
        ("18a", a[0]["losses"][0]),
        ("18b", ranks[0]["18b_dropout0"]["losses"][0]))}
    if max(rel.values()) > P17_LOSS_RTOL:
        raise AssertionError(f"first losses against one process {single}: "
                             f"{rel} beyond {P17_LOSS_RTOL}")
    # 18a's sharded save at world size 1.
    resumed = runner(os.path.join(out, "ckpt_pp_tp"), PHASE2, [
        "--local_batch_size", str(TRAIN_LOCAL_BATCH), "--global_batch_size",
        str(TRAIN_LOCAL_BATCH * TRAIN_ACCUM), "--attention_backend", "flash",
        "--previous_phase_end_step", "0"], config0)
    resumed_digest = whole_state_digest(resumed["model"],
                                        resumed["optimizer"])
    if resumed["global_step"] != P18A_STEPS or resumed_digest != a[0][
            "digest"]:
        raise AssertionError(f"18a resume at world 1: step "
                             f"{resumed['global_step']}, digest "
                             f"{resumed_digest[:12]} vs {a[0]['digest'][:12]}")
    resume_s = resumed["resume_s"]
    del resumed
    torch.cuda.empty_cache()
    # 18c's first update against one process's K-FAC step.
    parts = [np.load(os.path.join(out, f"batch18c.r{r}.npz"))
             for r in range(P18_WORLD)]
    batch_c = {k: torch.from_numpy(np.concatenate(
        [p[k] for p in parts], axis=1)).cuda() for k in parts[0]}
    singles = {}
    for label, tweak in (("plain", None), ("fault", unreplicated_factors),
                         ("fp32_inverses", fp32_inverses)):
        _, model = single_process_step(
            os.path.join(out, f"single_kfac_{label}"), config0, batch_c, [
                "--local_batch_size", str(TRAIN_LOCAL_BATCH * TRAIN_ACCUM),
                "--kfac", "--kfac_factor_interval", "1",
                "--kfac_inv_interval", "1"], tweak)
        singles[label] = {n: p.grad.detach().float().cpu()
                          for n, p in model.named_parameters()}
        del model
        torch.cuda.empty_cache()
    want = singles["plain"]
    kfac_rel = update_rel(torch.load(os.path.join(out, "update18c.pt")),
                          want)
    fault_rel = update_rel(singles["fault"], want)
    inv32_rel = update_rel(singles["fp32_inverses"], want)
    if not kfac_rel <= P18_KFAC_UPDATE_RTOL < fault_rel:
        raise AssertionError(f"18c first update {kfac_rel:.3e} off one "
                             f"process's, the planted fault {fault_rel:.3e} "
                             f"(bar {P18_KFAC_UPDATE_RTOL} between them)")
    # A shared launch's ranks ran this phase's part in child_s.
    phase_s = time.perf_counter() - t_phase + (
        0.0 if launched is None else ranks[0]["child_s"])
    log(f"[mp] 18a pipe=2,model=2 ({P18_WORLD} ranks, gloo, transport "
        f"{a[0]['transport']}), {P17_LAYERS} layers, {P18A_STEPS} steps: "
        f"losses {a[0]['losses']}, step s "
        f"{[round(x, 3) for x in a[0]['step_s']]}, first loss against one "
        f"process {a[0]['losses'][0]} / {single} (rel {rel['18a']:.3e}); "
        f"sharded save {a[0]['sharded_save_s']:.2f} s, resumed at world 1 "
        f"in {resume_s:.2f} s with the same state digest; launches a rank "
        f"{a[0]['launches']}; peak {a[0]['peak_bytes']} bytes (rank 0)")
    b0, b1 = ranks[0]["18b_dropout0"], ranks[0]["18b_dropout"]
    log(f"[mp] 18b pipe=2,seq=2, S={TRAIN_SEQ}, ring: losses dropout 0 "
        f"{b0['losses']} (rel {rel['18b']:.3e}), 0.1 {b1['losses']}; step s "
        f"{b0['step_s'][0]:.3f}, {b1['step_s'][0]:.3f}; launches "
        f"{b0['launches']}; peak {b0['peak_bytes']} bytes; one ring layer "
        f"against plain, worst share of the bar by rank {ring_layer}")
    log(f"[mp] 18c dp=4 --kfac: losses {c[0]['losses']}, step s "
        f"{[round(x, 3) for x in c[0]['step_s']]}, K-FAC digests equal on "
        f"{P18_WORLD} ranks, first update against one process rel "
        f"{kfac_rel:.3e} (bar {P18_KFAC_UPDATE_RTOL}; the planted fault "
        f"{fault_rel:.3e}, fp32 inverses {inv32_rel:.3e}); launches a rank "
        f"{c[0]['launches']}; peak {c[0]['peak_bytes']} bytes; torchrun "
        f"{run_s:.1f} s, phase 18 {phase_s:.1f} s on {card}")
    shutil.rmtree(out)
    return {"18a": a[0], "18b": {"dropout0": b0, "dropout": b1},
            "18c": c[0], "single_loss": single, "first_loss_rel": rel,
            "kfac_update_rel": kfac_rel, "kfac_fault_rel": fault_rel,
            "kfac_fp32_inverses_rel": inv32_rel, "ring_layer": ring_layer,
            "resume_s": resume_s,
            "torchrun_s": run_s, "seconds": phase_s,
            "launches": {"pp_tp": a[0]["launches"],
                         "pp_sp": {n: b0["launches"][n]
                                   + b1["launches"][n]
                                   for n in b0["launches"]},
                         "kfac_dp4": c[0]["launches"]}}


# -- phase 19: measured attention geometry for serving ------------------------

# 19a: every candidate geometry of #4 and #5 (ops/kernels/autotune.py) at
# B=8, H=16, D=64, bf16, S in SEQS, padded and packed, against its plain
# version at ATOL; each candidate's time as measure() takes it (CUDA events
# over P19_LAUNCHES back-to-back launches queued behind a sleep, median of
# its rounds, after an untimed call and an untimed pass of as many
# launches), SDPA's the same way; the winner also by device time
# (torch.profiler, 100 launches after 10), beside phases 3 and 4's device
# times of the default and SDPA.
P19_LAUNCHES = 100
# 19b: run_server subprocesses at BERT-large width and depth (fill_mask and
# classify, buckets 128 and 512, batch 8, unpacked, so each sequential
# request runs alone in its forward at row 0), sharing one fresh
# --compile_cache_dir: A measures, B loads (nothing measured, nothing
# built), C serves the default geometry (off), D measures the int8 path.
# The directory starts with copies of the libraries this process built
# already (#4's, #5's and the tokenizer core's; phase 14 shows a fresh
# --compile_cache_dir's cold build), so no replica runs a compiler.
P19_TASKS = "fill_mask,classify"
P19_REPLICA_S = 300
# The served answers of the tuned and the default geometry: the same
# model in bf16 with the attention's online softmax taken over other key
# tiles, so probabilities within the GLUE bar (a bf16 logit).
P19_SCORE_ATOL = GLUE_SERVE_ATOL


def p19_requests() -> list:
    """Sequential requests for 19b: classify at two lengths in each bucket,
    fill_mask in the 128 one (its unfused 512 batch ships [8, 512, V]
    logits to the host)."""
    from bert_pytorch_tpu_torch.tools.make_synthetic_data import TRACE_WORDS

    rng = np.random.default_rng(19)
    out = []
    for n in (12, 90, 250, 400):
        words = [str(w) for w in rng.choice(TRACE_WORDS, n)]
        if n < 120:
            out.append(("fill_mask", {"text": " ".join(
                words[:n // 2] + ["[MASK]"] + words[n // 2:]), "top_k": 5}))
        out.append(("classify", {"text": " ".join(words)}))
    return out


def check_geometries(card: str) -> dict:
    """Phase 19a. Returns, per kernel, the kernels-line fields
    ``geometries`` (each candidate's time at each S and its worst error)
    and ``winner`` (per S: measure()'s winner, its time and the default's
    and SDPA's by events, its device time, and the bound)."""
    from bert_pytorch_tpu_torch.ops.kernels import attention as ka
    from bert_pytorch_tpu_torch.ops.kernels import autotune

    t_phase = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(19)
    dtype = torch.bfloat16
    errs = {}   # (kernel, seq, geometry) -> worst error over padded/packed
    timed = {}  # (kernel, seq) -> padded calls: geometry -> fn, and SDPA
    for seq in SEQS:
        for packed in (False, True):
            q, k, v, kw = attention_inputs(seq, dtype, packed, gen)
            key_bias, seg = ka._infer_bias_seg(
                kw.get("bias"), kw.get("sequence_ids"), B, seq)
            q8, q_scale, k8, k_scale = ka.quantize_qk(q, k)
            args8 = (q8, k8, q_scale, k_scale, v, key_bias, seg)
            refs = {"infer": ka.flash_attention_infer_reference(q, k, v,
                                                                **kw),
                    "infer_int8": ka._int8_forward_math(*args8)}
            calls = {"infer": lambda g, q=q, k=k, v=v, kw=kw: (
                         ka.flash_attention_infer(q, k, v, geometry=g,
                                                  **kw)),
                     "infer_int8": lambda g, args8=args8: (
                         ka.flash_attention_infer_int8_prequantized(
                             *args8, geometry=g))}
            for kernel in autotune.KERNELS:
                for geom in autotune.candidates(seq, B * H, D, kernel):
                    out = calls[kernel](geom)
                    torch.cuda.synchronize()
                    name = (f"S={seq} {'packed' if packed else 'padded'} "
                            f"geometry {geom}")
                    err = check_case(f"[19a] {kernel}", name, dtype, out,
                                     refs[kernel])
                    key = (kernel, seq, geom)
                    errs[key] = max(errs.get(key, 0.0), err)
            if not packed:
                deq = [(t8.float() * s[:, None, :, None]).to(dtype)
                       for t8, s in ((q8, q_scale), (k8, k_scale))]
                timed[("infer", seq)] = (calls["infer"],
                                         library_call(q, k, v, kw))
                timed[("infer_int8", seq)] = (
                    calls["infer_int8"], library_call(deq[0], deq[1], v, kw))
    fields = {kernel: {"geometries": [], "winner": {}}
              for kernel in autotune.KERNELS}
    for (kernel, seq), (call, sdpa) in timed.items():
        autotune.clear_winners()
        result = autotune.measure(kernel, seq, B * H, D, heads=H,
                                  launches=P19_LAUNCHES)
        win = tuple(result["winner"][f] for f in ("block_q", "block_k",
                                                  "bh_block"))
        sdpa_event, = autotune.time_rounds(
            [sdpa], P19_LAUNCHES, result["rounds"], True,
            time.perf_counter)
        times = result["times_ms"]
        for geom in autotune.candidates(seq, B * H, D, kernel):
            fields[kernel]["geometries"].append({
                "seq": seq, "geometry": list(geom),
                "ms": times["%dx%dg%d" % geom],
                "max_abs_err": errs[(kernel, seq, geom)]})
        default = autotune.DEFAULT_GEOMETRY
        device_ms = device_time_ms(lambda: call(win))
        bound, by = (bound_ms if kernel == "infer" else int8_bound_ms)(
            seq, dtype)
        fields[kernel]["winner"][str(seq)] = {
            "geometry": list(win), "ms": result["measured_ms"],
            "spread_ms": result["spread_ms"],
            "launches": result["launches"], "resolved": result["resolved"],
            "default_ms": times["%dx%dg%d" % default],
            "sdpa_ms": round(statistics.median(sdpa_event), 5),
            "device_ms": device_ms, "bound_ms": bound, "bound_by": by,
            "failed": result["failed"]}
        log(f"[19a] {kernel} S={seq}: {result['candidates']} candidates, "
            f"winner {win} {result['measured_ms']:.5f} ms (spread "
            f"{result['spread_ms']:.5f}, {result['launches']} launches, "
            f"resolved {result['resolved']}) vs default "
            f"{times['%dx%dg%d' % default]:.5f} vs SDPA "
            f"{statistics.median(sdpa_event):.5f} ms (CUDA events); the "
            f"winner's device time {device_ms:.5f} ms; bound "
            f"{bound:.5f} ms ({by}); every candidate "
            f"{json.dumps(times)} on {card}")
    autotune.clear_winners()
    worst = max(errs.values())
    log(f"[19a] {len(errs)} (kernel, S, geometry) cases against the plain "
        f"versions, worst {worst:.3e} (atol {ATOL[dtype]:g}) in "
        f"{time.perf_counter() - t_phase:.1f} s on {card}")
    return fields


def start_replica(label: str, root: str, vocab: str, cache: str,
                  extra=()) -> tuple:
    """A ``run_server`` subprocess of phase 19b with its own output dir,
    sharing ``cache`` as its --compile_cache_dir: (process, port, output
    dir, log path, start time)."""
    out = os.path.join(root, f"replica_19{label}")
    port = free_port()
    cmd = [sys.executable, "-m", "bert_pytorch_tpu_torch.run_server",
           "--model_config_file", CONFIG, "--vocab_file", vocab,
           "--tasks", P19_TASKS, "--buckets", "128,512",
           "--max_batch_size", "8", "--max_wait_ms", "1",
           "--port", str(port), "--trace_sample_rate", "0",
           "--output_dir", out, "--compile_cache_dir", cache, *extra]
    log_path = os.path.join(root, f"replica_19{label}.log")
    with open(log_path, "w") as log_file:
        proc = subprocess.Popen(cmd, cwd=REPO, stdout=log_file,
                                stderr=subprocess.STDOUT)
    return proc, port, out, log_path, time.perf_counter()


def await_replica(label: str, replica: tuple) -> float:
    """Seconds until the replica answers /healthz."""
    proc, port, _, log_path, t0 = replica
    while True:
        try:
            get(port, "/healthz")
            return time.perf_counter() - t0
        except OSError:
            if proc.poll() is not None or \
                    time.perf_counter() - t0 > P19_REPLICA_S:
                raise AssertionError(
                    f"19{label} replica did not start (rc {proc.poll()}): "
                    + open(log_path).read()[-3000:])
            time.sleep(0.25)


def serve_and_stop(label: str, replica: tuple, requests: list) -> dict:
    """Send ``requests`` one at a time, read /statsz, stop the replica with
    Ctrl-C (rc 0) and read its JSONL: answers, the kernel launches its
    forwards made, and its autotune and compile records."""
    from bert_pytorch_tpu_torch.telemetry import schema

    proc, port, out, log_path, _ = replica
    try:
        answers = []
        for task, payload in requests:
            status, body, _ = post(port, task, payload)
            if status != 200:
                raise AssertionError(f"19{label} {task} answered {status}: "
                                     f"{body}")
            check_body(task, payload, body, ["0", "1"])
            answers.append(body)
        stats = get(port, "/statsz")
        proc.send_signal(signal.SIGINT)
        rc = proc.wait(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    if rc != 0:
        raise AssertionError(f"19{label} replica exited {rc}: "
                             + open(log_path).read()[-3000:])
    jsonl = os.path.join(out, "serve_telemetry.jsonl")
    errors = schema.validate_file(jsonl)
    if errors:
        raise AssertionError(f"19{label} JSONL: {errors[:5]}")
    kinds = read_records(jsonl)
    return {"answers": answers, "launches": stats.get("kernel_launches"),
            "forwards": stats.get("forwards"),
            "autotune": kinds.get("autotune", []),
            "compile": [(e["fn"], e["cache"]) for e in kinds.get("compile",
                                                                  [])],
            "cold_start": (kinds.get("serve_cold_start") or [{}])[-1]}


def tuned_geometries(label: str, served: dict, source: str,
                     kernel: str) -> dict:
    """Bucket -> the winner of a 19b start whose every autotune record
    must have ``source`` for ``kernel``."""
    recs = served["autotune"]
    if sorted(r["seq"] for r in recs) != [128, 512] or any(
            r["source"] != source or r["kernel"] != kernel
            or r["bh"] != 8 * H for r in recs):
        raise AssertionError(f"19{label} autotune records: {recs}")
    return {r["seq"]: (r["winner"], r["digest"]) for r in recs}


def close_scores(a: dict, b: dict) -> float:
    """The largest score gap between two answers of one request: classify
    scores by label; fill_mask slots by token id (ids past the demo vocab
    all decode to ""), an id in only one top-k no more than the bar above
    the other's lowest score (a tie at the cut)."""
    if "scores" in a:
        return max(abs(a["scores"][k] - b["scores"][k]) for k in a["scores"])
    gap = 0.0
    for ma, mb in zip(a["masks"], b["masks"]):
        sb = {s["id"]: s["score"] for s in mb}
        for slot in ma:
            if slot["id"] in sb:
                gap = max(gap, abs(slot["score"] - sb[slot["id"]]))
            else:
                gap = max(gap, slot["score"] - min(sb.values()))
    return gap


def drive_autotune_serving(vocab: str, root: str, card: str) -> dict:
    """Phase 19b: run_server with --autotune measure, then load, off, and
    the int8 path with measure (P19_TASKS at BERT-large width)."""
    from bert_pytorch_tpu_torch.ops.kernels import autotune

    from bert_pytorch_tpu_torch.ops.kernels import build

    t_phase = time.perf_counter()
    cache = os.path.join(root, "compile_cache_19")
    os.makedirs(cache)
    for built in (build.host_library_path("tokenizer"),
                  build.library_path("flash_attention_infer"),
                  build.library_path("flash_attention_infer_int8")):
        if built.exists():
            shutil.copy(built, cache)
    winners = os.path.join(cache, "autotune.json")
    winners8 = os.path.join(cache, "autotune_int8.json")
    requests = p19_requests()
    starts = {}
    # A: measure, alone on the card.
    a = start_replica("a", root, vocab, cache,
                      ("--autotune", "measure", "--autotune_cache", winners))
    starts["a"] = await_replica("a", a)
    served_a = serve_and_stop("a", a, requests)
    geom_a = tuned_geometries("a", served_a, "measured", "infer")
    if autotune.validate_winners_file(winners):
        raise AssertionError(f"19a winners file: "
                             f"{autotune.validate_winners_file(winners)}")
    with open(winners, encoding="utf-8") as f:
        stamp = json.load(f)["platform"]
    if stamp != f"cuda:{torch.cuda.get_device_name(0)}":
        raise AssertionError(f"19b winners file stamped {stamp!r}")
    # B (load), C (off) and D (int8, measure) together: B and C measure
    # nothing and are warm before D measures.
    b = start_replica("b", root, vocab, cache,
                      ("--autotune", "load", "--autotune_cache", winners))
    c = start_replica("c", root, vocab, cache)
    d = start_replica("d", root, vocab, cache,
                      ("--autotune", "measure", "--autotune_cache", winners8,
                       "--quantize", "int8", "--attention_backend",
                       "flash_infer_int8", "--fuse_epilogues"))
    for label, replica in (("b", b), ("c", c), ("d", d)):
        starts[label] = await_replica(label, replica)
    served_b = serve_and_stop("b", b, requests)
    served_c = serve_and_stop("c", c, requests)
    served_d = serve_and_stop("d", d, requests)
    geom_b = tuned_geometries("b", served_b, "cached", "infer")
    if geom_b != geom_a:
        raise AssertionError(f"19b B loaded {geom_b}, A measured {geom_a}")
    if any(cache_ != "hit" for _, cache_ in served_b["compile"]) or \
            served_b["cold_start"].get("compiles_cold") != 0:
        raise AssertionError(f"19b B built a library: {served_b['compile']}")
    if served_b["answers"] != served_a["answers"]:
        raise AssertionError("19b B's answers are not A's bit for bit")
    if served_c["autotune"]:
        raise AssertionError(f"19b C (off) wrote {served_c['autotune']}")
    gap = max(close_scores(x, y) for x, y in zip(served_a["answers"],
                                                 served_c["answers"]))
    if not gap <= P19_SCORE_ATOL:
        raise AssertionError(f"19b tuned vs default answers {gap} apart "
                             f"(bar {P19_SCORE_ATOL})")
    geom_d = tuned_geometries("d", served_d, "measured", "infer_int8")
    for label, served, kernel in (("a", served_a, "flash_attention_infer"),
                                  ("b", served_b, "flash_attention_infer"),
                                  ("c", served_c, "flash_attention_infer"),
                                  ("d", served_d,
                                   "flash_attention_infer_int8")):
        launches = served["launches"].get(kernel)
        if launches != 24 * served["forwards"]:
            raise AssertionError(f"19{label}: {launches} launches of "
                                 f"{kernel} over {served['forwards']} "
                                 "forwards, not 24 each")
    seconds = time.perf_counter() - t_phase
    result = {
        "start_s": starts,
        "winners": {"a": {str(s): g for s, g in geom_a.items()},
                    "d": {str(s): g for s, g in geom_d.items()}},
        "measure_s": {label: {str(r["seq"]): r.get("measure_s")
                              for r in served["autotune"]}
                      for label, served in (("a", served_a),
                                            ("d", served_d))},
        "compile": {label: served["compile"] for label, served in (
            ("a", served_a), ("b", served_b), ("c", served_c),
            ("d", served_d))},
        "launches": {label: served["launches"] for label, served in (
            ("a", served_a), ("b", served_b), ("c", served_c),
            ("d", served_d))},
        "forwards": {label: served["forwards"] for label, served in (
            ("a", served_a), ("b", served_b), ("c", served_c),
            ("d", served_d))},
        "tuned_vs_default_gap": gap,
        "default_bit_equal": served_c["answers"] == served_a["answers"],
        "seconds": seconds}
    log(f"[19b] run_server --autotune measure (A, {starts['a']:.1f} s to "
        f"/healthz, the measurement included): winners "
        f"{result['winners']['a']}, measure s {result['measure_s']['a']}; "
        f"load (B, {starts['b']:.1f} s): cached, compile records "
        f"{served_b['compile']}, answers bit-equal to A's; off (C): "
        f"answers within {gap:.3e} of A's (bit-equal "
        f"{result['default_bit_equal']}); int8 measure (D): winners "
        f"{result['winners']['d']}; launches {result['launches']} over "
        f"forwards {result['forwards']}; phase 19b {seconds:.1f} s on {card}")
    return result


def drive_autotune(root: str, card: str) -> dict:
    """Phase 19: 19a in this process, then 19b's replicas."""
    from bert_pytorch_tpu_torch.tools.make_synthetic_data import (
        write_trace_vocab)

    t0 = time.perf_counter()
    fields = check_geometries(card)
    vocab = write_trace_vocab(os.path.join(root, "vocab_19.txt"))
    served = drive_autotune_serving(vocab, root, card)
    seconds = time.perf_counter() - t0
    log(f"[19] phase 19 {seconds:.1f} s on {card}")
    return {"fields": fields, "serving": served, "seconds": seconds}


# -- phase 20: the last pretraining layouts -----------------------------------
# One torchrun launch of P18_WORLD ranks sharing the card (gloo), BERT-large
# width cut to P17_LAYERS layers, 16 rows a step from the phase's seeded rows
# (P20_DATA_SEED), bf16, remat dots, the runner's own functions:
# 20a --mesh fsdp=2,pipe=2 (local batch 4 a data replica: 2 microbatches
# through 2 stages, each stage's layers FSDP2 units on its fsdp group),
# P20A_STEPS steps at dropout 0, then a sharded save resumed at world size 1
# in this process; 20b --mesh fsdp=2,seq=2 at S=512 (local batch 4, 2
# microbatches; the ring inside FSDP2 units), one step at dropout 0 and one
# at 0.1; 20c --mesh fsdp=2,model=2 --kfac and 20d --mesh dp=2,seq=2 --kfac
# (local batch 8, one microbatch; the fused capture, factors and inverses
# every step), P20K_STEPS steps at dropout 0, each first update held to
# P18_KFAC_UPDATE_RTOL against one process's and the planted fault of
# phase 18 beyond it.
P20A_STEPS, P20K_STEPS = 2, 2
P20_DATA_SEED = 20
P20_LOCAL_BATCH = TRAIN_LOCAL_BATCH // 2
P20_KFAC_FLAGS = ("--kfac", "--kfac_factor_interval", "1",
                  "--kfac_inv_interval", "1")
# Each K-FAC layout: (mesh, whether its layers run flash attention).
P20_KFAC_LAYOUTS = {"20c": ("fsdp=2,model=2", True),
                    "20d": ("dp=2,seq=2", False)}


def child_20(spec: dict, kernels: dict, shutdown: bool = True) -> dict:
    """20a, 20b, 20c and 20d in one of the four torchrun ranks sharing the
    card (``shutdown``: leave the process group after them); each rank
    saves its first batch of each part, so the driver can lay the global
    batch out for one process."""
    from bert_pytorch_tpu_torch import run_pretraining
    from bert_pytorch_tpu_torch.parallel import launcher, sharding

    t_child = time.perf_counter()
    rank = int(os.environ["RANK"])
    out = spec["out"]
    results = {}

    def keep_batch(label, res):
        np.savez(os.path.join(out, f"batch{label}.r{rank}.npz"),
                 **res.pop("first_batch"))

    def release():
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()

    # 20a
    res, model, optimizer, args, cfg, _ = child_18_run(
        kernels, os.path.join(out, "fsdp_pp"), spec["config0"],
        "fsdp=2,pipe=2", P20A_STEPS, P20_LOCAL_BATCH, seed=P20_DATA_SEED)
    keep_batch("20a", res)
    res["sharded"] = sharding.is_fsdp(model)
    t0 = time.perf_counter()
    run_pretraining.write_checkpoint(
        os.path.join(out, "ckpt_fsdp_pp", "pretrain_ckpts"), P20A_STEPS,
        model, optimizer, cfg, {"index": 0}, 0, layout="sharded",
        mesh_spec=args.mesh_spec.as_dict())
    res["sharded_save_s"] = time.perf_counter() - t0
    res["digest"] = whole_state_digest(model, optimizer)
    res["transport"] = args.layout.transports()
    res.pop("first_update")
    results["20a"] = res
    del model, optimizer
    release()
    log(f"[layouts] rank {rank}: 20a done; 20b fsdp=2,seq=2")
    # 20b: dropout 0 then 0.1, one step each
    for label, config in (("dropout0", spec["config0"]),
                          ("dropout", spec["config"])):
        # 20a's rows, so one process's step on them serves both.
        res, model, optimizer, args, cfg, _ = child_18_run(
            kernels, os.path.join(out, f"fsdp_sp_{label}"), config,
            "fsdp=2,seq=2", 1, P20_LOCAL_BATCH, seed=P20_DATA_SEED,
            data_steps=P20A_STEPS)
        keep_batch(f"20b_{label}", res)
        res.pop("first_update")
        res["sharded"] = sharding.is_fsdp(model)
        res["transport"] = args.layout.transports()
        results[f"20b_{label}"] = res
        del model, optimizer
        release()
    # 20c and 20d
    for key, (mesh, _) in P20_KFAC_LAYOUTS.items():
        log(f"[layouts] rank {rank}: {key} {mesh} --kfac")
        res, model, optimizer, args, cfg, kstate = child_18_run(
            kernels, os.path.join(out, f"kfac_{key}"), spec["config0"], mesh,
            P20K_STEPS, TRAIN_LOCAL_BATCH, P20_KFAC_FLAGS, keep_first=True,
            seed=P20_DATA_SEED)
        keep_batch(key, res)
        res["kfac_digest"] = kfac_state_digest(kstate)
        if rank == 0:
            torch.save(res["first_update"], os.path.join(
                out, f"update{key}.pt"))
        res.pop("first_update")
        results[key] = res
        del model, optimizer, kstate
        release()
    results["child_s"] = time.perf_counter() - t_child
    if shutdown:
        launcher.shutdown()
    return results


def batch_digest(batch: dict) -> str:
    """sha256 of a batch's arrays, by key."""
    import hashlib

    digest = hashlib.sha256()
    for key, value in sorted(batch.items()):
        digest.update(key.encode())
        digest.update(value.cpu().numpy().tobytes())
    return digest.hexdigest()


def drive_phases_18_and_20(kernels: dict, root: str, card: str) -> tuple:
    """Phases 18 and 20 from ONE torchrun launch of P18_WORLD ranks sharing
    the card (each rank runs ``child_18`` then ``child_20``): the ranks
    start once, and each phase's checks are those it makes alone
    (:func:`drive_model_parallel`, :func:`drive_layouts`). Returns (phase
    18's result, phase 20's)."""
    t0 = time.perf_counter()
    spec = {"out": os.path.join(root, "phases_18_20"),
            "18": phase_spec(root, "model_parallel"),
            "20": phase_spec(root, "layouts")}
    os.makedirs(spec["out"])
    ranks, run_s, _ = torchrun("18_20", P18_WORLD, spec)
    model_parallel = drive_model_parallel(
        kernels, root, card, (spec["18"], [r["18"] for r in ranks], run_s))
    torch.cuda.empty_cache()
    layouts = drive_layouts(
        kernels, root, card, (spec["20"], [r["20"] for r in ranks], run_s))
    shutil.rmtree(spec["out"])
    start_s = run_s - ranks[0]["18"]["child_s"] - ranks[0]["20"]["child_s"]
    seconds = time.perf_counter() - t0
    log(f"[mp] phases 18 and 20 from one torchrun of {P18_WORLD} ranks: "
        f"launch {run_s:.1f} s (the ranks' start and exit {start_s:.1f} s), "
        f"both phases {seconds:.1f} s on {card}")
    for result in (model_parallel, layouts):
        result.update(shared_launch_s=run_s, shared_start_s=start_s,
                      shared_phases_s=seconds)
    return model_parallel, layouts


def global_first_batch(out: str, label: str, ranks: list) -> dict:
    """The global first batch of part ``label``: each data coordinate's
    rows (from the first rank that holds it), concatenated in coordinate
    order along the rows of every microbatch, on the card."""
    firsts = {}
    for rank, res in enumerate(ranks):
        firsts.setdefault(res["data_index"], rank)
    parts = [np.load(os.path.join(out, f"batch{label}.r{r}.npz"))
             for _, r in sorted(firsts.items())]
    return {k: torch.from_numpy(np.concatenate([p[k] for p in parts],
                                               axis=1)).cuda()
            for k in parts[0]}


def drive_layouts(kernels: dict, root: str, card: str,
                  launched=None) -> dict:
    """Phase 20: the last pretraining layouts, one torchrun launch of
    P18_WORLD ranks sharing the card over gloo, at BERT-large width cut to
    P17_LAYERS layers.

    20a: ``--mesh fsdp=2,pipe=2``, P20A_STEPS steps at dropout 0: the first
    loss within P17_LOSS_RTOL of one process's step on the same 16 rows,
    the ranks' losses and whole-state digests equal, a sharded save
    resumed by the runner at world size 1 here with the same digest. 20b:
    ``--mesh fsdp=2,seq=2`` at S=512 (the runner switches to the ring), one
    step at dropout 0 (the same loss bar) and one at 0.1 (finite). 20c
    ``--mesh fsdp=2,model=2 --kfac`` and 20d ``--mesh dp=2,seq=2 --kfac``
    (the fused capture, factors and inverses every step), P20K_STEPS steps
    each: the K-FAC digests equal on every rank, the first update (the
    preconditioned gradients, whole) within P18_KFAC_UPDATE_RTOL of one
    process's on the same 16 rows, and one process's update with phase
    18's planted fault beyond it. Exact launch counts of #1-#3 per rank:
    20a its stage's 3 layers, 20c all 6 (H/2 heads each), 20b and 20d
    none (ring layers launch no flash kernel). 20a and 20b read the same
    rows, and so do 20c and 20d: one process's step on them serves both.
    ``launched`` as :func:`drive_model_parallel`'s."""
    t_phase = time.perf_counter()
    if launched is None:
        spec = phase_spec(root, "layouts")
        ranks, run_s, _ = torchrun("20", P18_WORLD, spec)
    else:
        spec, ranks, run_s = launched
    out, config0 = spec["out"], spec["config0"]
    backend = ("nccl" if torch.cuda.device_count() >= P18_WORLD else "gloo")
    a = [r["20a"] for r in ranks]
    for rank, res in enumerate(a):
        check_launches_per_rank(f"20a rank {rank}", res["launches"],
                                res["routes"], P17_LAYERS // 2,
                                res["accumulation"], P20A_STEPS)
    if (a[0]["mesh"] != "dp=1,fsdp=2,pipe=2" or a[0]["backend"] != backend
            or a[0]["accumulation"] != 2 or not all(r["sharded"] for r in a)):
        raise AssertionError(f"20a mesh {a[0]['mesh']} {a[0]['backend']}, "
                             f"accumulation {a[0]['accumulation']}, FSDP "
                             f"{[r['sharded'] for r in a]}")
    if len({r["digest"] for r in a}) != 1 or len(
            {tuple(r["losses"]) for r in a}) != 1:
        raise AssertionError("20a: the ranks disagree on the state or the "
                             f"losses: {[r['losses'] for r in a]}")
    for label in ("20b_dropout0", "20b_dropout"):
        for rank, r in enumerate(ranks):
            res = r[label]
            check_launches_per_rank(f"{label} rank {rank}", res["launches"],
                                    res["routes"], 0, res["accumulation"], 1)
            if (res["attention_backend"] != "ring" or not res["sharded"]
                    or not all(np.isfinite(res["losses"]))):
                raise AssertionError(f"{label} rank {rank}: backend "
                                     f"{res['attention_backend']}, FSDP "
                                     f"{res['sharded']}, losses "
                                     f"{res['losses']}")
    # One process on the same 16 rows (2 microbatches of 8), once for
    # each distinct batch.
    rel, singles, by_batch = {}, {}, {}
    for label, loss in (("20a", a[0]["losses"][0]),
                        ("20b_dropout0",
                         ranks[0]["20b_dropout0"]["losses"][0])):
        batch = global_first_batch(out, label, [r[label] for r in ranks])
        key = batch_digest(batch)
        if key not in by_batch:
            by_batch[key], model = single_process_step(
                os.path.join(out, f"single_{label}"), config0, batch)
            del model
            torch.cuda.empty_cache()
        singles[label] = by_batch[key]
        rel[label] = abs(loss / singles[label] - 1.0)
    if max(rel.values()) > P17_LOSS_RTOL:
        raise AssertionError(f"first losses against one process {singles}: "
                             f"{rel} beyond {P17_LOSS_RTOL}")
    # 20a's sharded save at world size 1.
    resumed = runner(os.path.join(out, "ckpt_fsdp_pp"), PHASE2, [
        "--local_batch_size", str(TRAIN_LOCAL_BATCH), "--global_batch_size",
        str(TRAIN_LOCAL_BATCH * TRAIN_ACCUM), "--attention_backend", "flash",
        "--previous_phase_end_step", "0"], config0)
    resumed_digest = whole_state_digest(resumed["model"],
                                        resumed["optimizer"])
    if resumed["global_step"] != P20A_STEPS or resumed_digest != a[0][
            "digest"]:
        raise AssertionError(f"20a resume at world 1: step "
                             f"{resumed['global_step']}, digest "
                             f"{resumed_digest[:12]} vs {a[0]['digest'][:12]}")
    resume_s = resumed["resume_s"]
    del resumed
    torch.cuda.empty_cache()
    # 20c and 20d: the first update against one process's K-FAC step.
    kfac_rel, fault_rel, kfac_parts, kfac_singles = {}, {}, {}, {}
    for key, (mesh, flash) in P20_KFAC_LAYOUTS.items():
        parts = [r[key] for r in ranks]
        for rank, res in enumerate(parts):
            check_launches_per_rank(f"{key} rank {rank}", res["launches"],
                                    res["routes"],
                                    P17_LAYERS if flash else 0,
                                    res["accumulation"], P20K_STEPS)
        if len({r["kfac_digest"] for r in parts}) != 1 or not all(
                np.isfinite(r["losses"]).all() for r in parts):
            raise AssertionError(f"{key}: K-FAC state digests "
                                 f"{[r['kfac_digest'][:12] for r in parts]}"
                                 f", losses {[r['losses'] for r in parts]}")
        batch = global_first_batch(out, key, parts)
        updates = kfac_singles.setdefault(batch_digest(batch), {})
        for label, tweak in (("plain", None),
                             ("fault", unreplicated_factors)):
            if label in updates:
                continue
            _, model = single_process_step(
                os.path.join(out, f"single_{key}_{label}"), config0, batch,
                ["--local_batch_size", str(TRAIN_LOCAL_BATCH * TRAIN_ACCUM),
                 *P20_KFAC_FLAGS], tweak)
            updates[label] = {n: p.grad.detach().float().cpu()
                              for n, p in model.named_parameters()}
            del model
            torch.cuda.empty_cache()
        kfac_rel[key] = update_rel(torch.load(os.path.join(
            out, f"update{key}.pt")), updates["plain"])
        fault_rel[key] = update_rel(updates["fault"], updates["plain"])
        if not kfac_rel[key] <= P18_KFAC_UPDATE_RTOL < fault_rel[key]:
            raise AssertionError(
                f"{key} first update {kfac_rel[key]:.3e} off one process's, "
                f"the planted fault {fault_rel[key]:.3e} (bar "
                f"{P18_KFAC_UPDATE_RTOL} between them)")
        kfac_parts[key] = parts[0]
    phase_s = time.perf_counter() - t_phase + (
        0.0 if launched is None else ranks[0]["child_s"])
    log(f"[layouts] 20a fsdp=2,pipe=2 ({P18_WORLD} ranks, gloo, transport "
        f"{a[0]['transport']}), {P17_LAYERS} layers, {P20A_STEPS} steps: "
        f"losses {a[0]['losses']}, step s "
        f"{[round(x, 3) for x in a[0]['step_s']]}, first loss against one "
        f"process {a[0]['losses'][0]} / {singles['20a']} (rel "
        f"{rel['20a']:.3e}); sharded save {a[0]['sharded_save_s']:.2f} s, "
        f"resumed at world 1 in {resume_s:.2f} s with the same state digest; "
        f"launches a rank {a[0]['launches']}; peak {a[0]['peak_bytes']} "
        f"bytes (rank 0)")
    b0, b1 = ranks[0]["20b_dropout0"], ranks[0]["20b_dropout"]
    log(f"[layouts] 20b fsdp=2,seq=2, S={TRAIN_SEQ}, ring: losses dropout 0 "
        f"{b0['losses']} (rel {rel['20b_dropout0']:.3e}), 0.1 "
        f"{b1['losses']}; step s {b0['step_s'][0]:.3f}, "
        f"{b1['step_s'][0]:.3f}; launches {b0['launches']}; peak "
        f"{b0['peak_bytes']} bytes")
    for key, (mesh, _) in P20_KFAC_LAYOUTS.items():
        res = kfac_parts[key]
        log(f"[layouts] {key} {mesh} --kfac: losses {res['losses']}, step s "
            f"{[round(x, 3) for x in res['step_s']]}, K-FAC digests equal on "
            f"{P18_WORLD} ranks, first update against one process rel "
            f"{kfac_rel[key]:.3e} (bar {P18_KFAC_UPDATE_RTOL}; the planted "
            f"fault {fault_rel[key]:.3e}); launches a rank "
            f"{res['launches']}; peak {res['peak_bytes']} bytes")
    log(f"[layouts] torchrun {run_s:.1f} s, phase 20 {phase_s:.1f} s "
        f"({len(by_batch)} one-process loss steps, "
        f"{sum(len(u) for u in kfac_singles.values())} K-FAC ones) on "
        f"{card}")
    shutil.rmtree(out)
    c, d = kfac_parts["20c"], kfac_parts["20d"]
    return {"20a": a[0], "20b": {"dropout0": b0, "dropout": b1},
            "20c": c, "20d": d, "single_losses": singles,
            "first_loss_rel": rel, "kfac_update_rel": kfac_rel,
            "kfac_fault_rel": fault_rel, "resume_s": resume_s,
            "torchrun_s": run_s, "seconds": phase_s,
            "launches": {"fsdp_pp": a[0]["launches"],
                         "fsdp_sp": {n: b0["launches"][n]
                                     + b1["launches"][n]
                                     for n in b0["launches"]},
                         "fsdp_kfac_tp": c["launches"],
                         "kfac_sp": d["launches"]}}


def only_autotune() -> int:
    """Phase 19 alone: the kernels built, then :func:`drive_autotune` and
    its result line (also in chiprun_out/phase19.json)."""
    from bert_pytorch_tpu_torch.ops.kernels import build

    torch.backends.cuda.matmul.allow_tf32 = False
    card = card_line()
    t0 = time.perf_counter()
    log(f"[build] {build.build()} in {time.perf_counter() - t0:.2f}s")
    with tempfile.TemporaryDirectory() as tmp:
        result = drive_autotune(tmp, card)
    log(f"[result] {json.dumps({'autotune': result})}")
    os.makedirs(os.path.join(REPO, "chiprun_out"), exist_ok=True)
    with open(os.path.join(REPO, "chiprun_out", "phase19.json"), "w",
              encoding="utf-8") as f:
        json.dump({"card": card, "autotune": result}, f)
    print(card)
    return 0


# -- phase 21: the static analysis on the port --------------------------------
# The port's lint gate (bert_pytorch_tpu_torch/tools/check_all.py) in a
# subprocess of the card machine's own Python: torchlint over the port's
# package and this script, the telemetry schema leg over the JSONL files
# the earlier phases wrote, the winners leg over phase 19b's winners files.
# No kernel runs: the gate parses the code, it never imports it.


def collect_jsonl(root: str, dest: str) -> list:
    """Copy every ``*.jsonl`` under ``root`` into ``dest``, named by its
    path under ``root`` (the phases' working directories are removed when
    their block ends); returns the copies."""
    os.makedirs(dest, exist_ok=True)
    copies = []
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames[:] = [d for d in dirnames
                       if os.path.join(dirpath, d) != dest]
        for name in sorted(filenames):
            if not name.endswith(".jsonl"):
                continue
            path = os.path.join(dirpath, name)
            rel = os.path.relpath(path, root).replace(os.sep, "__")
            copy = os.path.join(dest, rel)
            shutil.copyfile(path, copy)
            copies.append(copy)
    return copies


def winners_files(root: str) -> list:
    """Phase 19b's winners files under ``root``."""
    cache = os.path.join(root, "compile_cache_19")
    return [os.path.join(cache, name)
            for name in ("autotune.json", "autotune_int8.json")]


def drive_lint(jsonls: list, winners: list, card: str) -> dict:
    """Phase 21: ``python -m bert_pytorch_tpu_torch.tools.check_all
    --format json`` over the port's tree and the named artifacts; fails
    on any finding, stale baseline entry or failing artifact."""
    if not jsonls:
        raise AssertionError("phase 21: the earlier phases left no JSONL")
    cmd = [sys.executable, "-m", "bert_pytorch_tpu_torch.tools.check_all",
           "--format", "json", *jsonls, *winners]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True,
                          timeout=600)
    seconds = time.perf_counter() - t0
    try:
        payload = json.loads(proc.stdout)
    except ValueError:
        raise AssertionError(
            f"phase 21: check_all rc {proc.returncode} printed no JSON: "
            f"{proc.stdout[-2000:]} {proc.stderr[-2000:]}") from None
    lint = payload["torchlint"]
    new = [f for f in lint["findings"] if f["status"] == "new"]
    failing = [r for r in payload["schema"] + payload["autotune_winners"]
               if not r["ok"]]
    lines = 0
    for path in jsonls:
        with open(path, "rb") as f:
            lines += sum(1 for _ in f)
    result = {
        "rc": proc.returncode,
        "files_linted": lint["files"],
        "findings": len(new),
        "baselined": len(lint["findings"]) - len(new),
        "stale_baseline": len(lint["stale_baseline"]),
        "jsonl_files": len(payload["schema"]),
        "jsonl_records": lines,
        "jsonl_bytes": sum(os.path.getsize(p) for p in jsonls),
        "winners_files": len(payload["autotune_winners"]),
        "failing_artifacts": [r["path"] for r in failing],
        "seconds": seconds,
    }
    log(f"[21] check_all (torchlint + schema + winners) over the port: "
        f"{result['files_linted']} files linted, {result['findings']} "
        f"findings ({result['baselined']} baselined, "
        f"{result['stale_baseline']} stale entries); {result['jsonl_files']}"
        f" JSONL artifacts of the earlier phases ({lines} records, "
        f"{result['jsonl_bytes']} bytes) and {result['winners_files']} "
        f"winners files of 19b, {len(failing)} failing; rc "
        f"{proc.returncode} in {seconds:.2f} s on {card}")
    if proc.returncode != 0 or new or failing or lint["stale_baseline"]:
        raise AssertionError(
            "phase 21: the gate failed: "
            + "; ".join([f"{f['path']}:{f['line']}: {f['check']} "
                         f"{f['message']}" for f in new]
                        + [f"{r['path']}: {r['errors'][:3]}"
                           for r in failing]
                        + [f"stale {e}" for e in lint["stale_baseline"]]))
    return result


def only_lint() -> int:
    """Phase 21 alone, after phase 19 (whose 19b writes the winners files
    and JSONL artifacts the gate lints): the kernels built, the two
    phases, their result line (also in chiprun_out/phase21.json)."""
    from bert_pytorch_tpu_torch.ops.kernels import build

    torch.backends.cuda.matmul.allow_tf32 = False
    card = card_line()
    t0 = time.perf_counter()
    log(f"[build] {build.build()} in {time.perf_counter() - t0:.2f}s")
    with tempfile.TemporaryDirectory() as tmp:
        tuned = drive_autotune(tmp, card)
        jsonls = collect_jsonl(tmp, os.path.join(tmp, "lint_21"))
        lint = drive_lint(jsonls, winners_files(tmp), card)
    log(f"[result] {json.dumps({'autotune': tuned['serving'], 'lint': lint})}")
    os.makedirs(os.path.join(REPO, "chiprun_out"), exist_ok=True)
    with open(os.path.join(REPO, "chiprun_out", "phase21.json"), "w",
              encoding="utf-8") as f:
        json.dump({"card": card, "lint": lint}, f)
    print(card)
    return 0


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs a CUDA card", file=sys.stderr)
        return 2
    if sys.argv[1:] == ["--only", "18"]:
        return only_model_parallel()
    if sys.argv[1:] == ["--only", "19"]:
        return only_autotune()
    if sys.argv[1:] == ["--only", "20"]:
        return only_layouts()
    if sys.argv[1:] == ["--only", "21"]:
        return only_lint()
    if sys.argv[1:3] == ["--only", "14"]:
        return only_fleet(sys.argv[3:])
    from bert_pytorch_tpu_torch.ops.kernels import build
    from bert_pytorch_tpu_torch.ops.kernels.attention import (
        flash_attention_dkv, flash_attention_dq, flash_attention_fwd,
        flash_attention_infer, flash_attention_infer_int8)
    from bert_pytorch_tpu_torch.ops.kernels.layernorm import layer_norm_fwd

    # fp32 matmuls in full fp32 for every comparison below (TF32 keeps
    # about three decimal digits).
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    device = torch.cuda.get_device_name(0)
    log(f"[card] {card}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, {torch.cuda.device_count()} device(s)")
    from bert_pytorch_tpu_torch.telemetry.compile_events import CompileMonitor

    t0 = time.perf_counter()
    # The cold build's compile records (phase 13's nvcc seconds per kernel).
    with CompileMonitor().installed() as monitor:
        built = build.build()
    log(f"[build] {built} in {time.perf_counter() - t0:.2f}s")
    log("[build] compile records (cold nvcc seconds per library) on "
        f"{card}: " + ", ".join(f"{e['fn']} {e['cache']} {e['compile_s']} s"
                                for e in monitor.events))
    kernels = {"flash_attention_infer": flash_attention_infer,
               "flash_attention_infer_int8": flash_attention_infer_int8,
               "flash_attention_fwd": flash_attention_fwd,
               "flash_attention_dq": flash_attention_dq,
               "flash_attention_dkv": flash_attention_dkv,
               "layer_norm_fwd": layer_norm_fwd}
    infer_entry = check_and_time_attention()
    int8_entry = check_and_time_int8_attention()
    worst = check_training_kernels()
    check_training_edges(worst)
    mask_shares = check_keep_masks()
    cases = time_training_kernels()
    ln_entry = check_and_time_layer_norm()
    cost_notes = check_cost_notes()
    # 12a beside phases 3, 4 and 7, so the fp16 and bf16 times are read at
    # the same point of the process.
    worst16, shares16, cases16, ln16 = check_fp16_kernels()
    with tempfile.TemporaryDirectory() as tmp:
        from bert_pytorch_tpu_torch.tools.make_synthetic_data import (
            write_trace_vocab)

        vocab = write_trace_vocab(os.path.join(tmp, "vocab.txt"))
        root = os.path.join(tmp, "checkpoints")
        os.makedirs(root)
        memory, paths, write_s = write_checkpoints(vocab, root)
        served, engine = drive_main_path(vocab, kernels, memory, paths)
        del engine
        log(f"[serve] {served['requests']} requests served from "
            f"checkpoints, p50 {served['p50_ms']:.1f} ms, max "
            f"{served['max_ms']:.1f} ms on {card}")
        torch.cuda.empty_cache()
        swap = check_hot_swap(vocab, kernels, paths)
        torch.cuda.empty_cache()
        engine_err, fp32_rows = check_flash_vs_dense(vocab)
        torch.cuda.empty_cache()
        served8 = drive_int8_main_path(vocab, kernels, memory, paths)
        del memory
        shutil.rmtree(root)
        torch.cuda.empty_cache()
        log(f"[serve int8] {served8['requests']} requests served, p50 "
            f"{served8['p50_ms']:.1f} ms, max {served8['max_ms']:.1f} ms; "
            f"weight bytes int8 {served8['weight_bytes_by_task']} vs fp32 "
            f"{served['weight_bytes_by_task']} on {card}")
        log(f"[ckpt] BERT-large heads on {card}: write s "
            f"{ {k: round(v, 2) for k, v in write_s.items()} }, load s fp32 "
            f"{served['load_s_by_task']}, int8 {served8['load_s_by_task']}, "
            f"swap load_s {swap['load_s']}")
        int8_errs = check_int8_engines(vocab, fp32_rows)
        torch.cuda.empty_cache()
        debug = drive_debug_planes(vocab, tmp, kernels, card)
        torch.cuda.empty_cache()
        drain = drive_replica_drain(vocab, tmp, card)
        fleet = drive_fleet(tmp, card)
        # Phase 21 lints these phases' JSONL too: keep copies past the
        # block.
        lint_dir = tempfile.mkdtemp(prefix="chip_smoke_21_")
        jsonls = collect_jsonl(tmp, os.path.join(lint_dir, "serving"))
    torch.cuda.empty_cache()
    trained = drive_training(kernels, capture_turns=True)
    log(f"[train] BERT-large phase 2 (S=512, max_pred 80, bf16, remat dots, "
        f"LAMB), local batch {TRAIN_LOCAL_BATCH} x {TRAIN_ACCUM}: "
        f"{trained['step_ms']:.1f} ms/step, {trained['seq_per_s']:.2f} "
        f"seq/s, first step {trained['first_step_ms']:.1f} ms, peak "
        f"{trained['peak_gib']:.1f} GiB on {card}")
    train_check = check_training_flash_vs_dense()
    with tempfile.TemporaryDirectory() as tmp:
        from bert_pytorch_tpu_torch.tools.make_synthetic_data import (
            write_trace_vocab)

        vocab = write_trace_vocab(os.path.join(tmp, "vocab.txt"))
        squad = drive_squad(vocab, tmp, kernels)
        shutil.rmtree(os.path.join(tmp, "squad_out"))
        handoff = drive_handoff(kernels, tmp, card)
        finetuned = drive_finetune(vocab, tmp, handoff["init_checkpoint"],
                                   handoff["config"],
                                   kernels, card)
        shutil.rmtree(os.path.join(tmp, "pretrain"))
        kfac = drive_kfac(kernels, tmp, card)
        kfac_parity = check_kfac_parity(tmp)
        trained16 = drive_training(kernels, "float16", trained["losses"][0])
        log(f"[train float16] BERT-large phase 2 as phase 6: "
            f"{trained16['step_ms']:.1f} ms/step, "
            f"{trained16['seq_per_s']:.2f} seq/s, losses "
            f"{trained16['losses']} (bf16 {trained['losses']}), loss scales "
            f"{trained16['loss_scales']}, peak {trained16['peak_gib']:.1f} "
            f"GiB (bf16 {trained['peak_gib']:.1f}) on {card}")
        overflow16 = drive_fp16_overflow(kernels, tmp, card)
        squad16 = drive_squad(vocab, tmp, kernels, "float16")
        shutil.rmtree(os.path.join(tmp, "squad_out"))
        log(f"[squad float16] {squad16['global_step']} steps, losses "
            f"{squad16['step_losses']}, final loss scale "
            f"{squad16['loss_scale']}, train "
            f"{squad16['training_sequences_per_second']:.2f} seq/s, EM "
            f"{squad16['exact_match']}, F1 {squad16['F1']}, #6 launches "
            f"{squad16['launches']['layer_norm_fwd']} over "
            f"{squad16['forwards']} forwards, peak "
            f"{squad16['peak_gib']:.1f} GiB on {card}")
        torch.cuda.empty_cache()
        feed = drive_feed(kernels, tmp, card)
        torch.cuda.empty_cache()
        roberta = drive_roberta(kernels, tmp, card)
        torch.cuda.empty_cache()
        mesh = drive_mesh(kernels, tmp, card, trained["losses"])
        torch.cuda.empty_cache()
        model_parallel, layouts = drive_phases_18_and_20(kernels, tmp,
                                                          card)
        torch.cuda.empty_cache()
        tuned = drive_autotune(tmp, card)
        jsonls += collect_jsonl(tmp, os.path.join(lint_dir, "training"))
        lint = drive_lint(jsonls, winners_files(tmp), card)
    shutil.rmtree(lint_dir)
    log(f"[squad] BERT-large SQuAD (S={SQUAD_SEQ}, batch {SQUAD_BATCH}, "
        f"bf16, AdamW, LayerNorm kernel): {squad['global_step']} steps, "
        f"losses {squad['step_losses']}, train "
        f"{squad['e2e_train_time']:.2f} s "
        f"({squad['training_sequences_per_second']:.2f} seq/s), predict "
        f"{squad['predict_batches']} batches in "
        f"{squad['e2e_inference_time']:.2f} s, EM {squad['exact_match']}, "
        f"F1 {squad['F1']}, peak {squad['peak_gib']:.1f} GiB on {card}")
    infer_entry["launches"] = served["launches"]["flash_attention_infer"]
    infer_entry["launches_glue_serving"] = finetuned["served"]["launches"][
        "flash_attention_infer"]
    infer_entry["launches_debug_planes"] = debug["launches"][
        "flash_attention_infer"]
    infer_entry["launches_fleet"] = fleet["launches_fleet"]
    infer_entry["route_launches"] = served["routes"]["flash_attention_infer"]
    int8_entry["launches"] = served8["launches"]["flash_attention_infer_int8"]
    int8_entry["route_launches"] = served8["routes"][
        "flash_attention_infer_int8"]
    # Phase 19: each candidate geometry, the winners, and the launches of
    # the measured starts' forwards (19b A for #4, D for #5).
    for entry, kernel, label in ((infer_entry, "infer", "a"),
                                 (int8_entry, "infer_int8", "d")):
        entry.update(tuned["fields"][kernel])
        entry["launches_autotune"] = tuned["serving"]["launches"][label][
            entry["name"]]
    ln_entry["launches"] = squad["launches"]["layer_norm_fwd"]
    ln16["launches"] = squad16["launches"]["layer_norm_fwd"]
    entries = [infer_entry, int8_entry] + training_entries(
        worst, cases, trained) + [ln_entry] + training_entries(
        worst16, cases16, trained16, "float16", "_fp16") + [ln16]
    for entry in entries:
        # Phase 15 runs bf16: an fp16 instance launches nothing there.
        entry["launches_feed"] = (0 if entry["name"].endswith("_fp16")
                                  else feed["launches"][entry["name"]])
        if entry["name"] == "flash_attention_fwd":
            entry["launches_feed_eval"] = feed["held_out_launches"][
                "flash_attention_fwd"]
        # Phase 16 runs bf16 too.
        entry["launches_roberta"] = (
            0 if entry["name"].endswith("_fp16") else
            roberta["pretraining"]["launches"][entry["name"]]
            + roberta["serving"]["launches"][entry["name"]])
        if entry["name"] == "flash_attention_infer":
            entry["launches_roberta_batch_infer"] = roberta["batch_infer"][
                "launches"]["flash_attention_infer"]
        if entry["name"] == "flash_attention_infer_int8":
            entry["launches_roberta_batch_infer_int8"] = roberta[
                "batch_infer_int8"]["launches"]["flash_attention_infer_int8"]
        if entry["name"] in cost_notes:
            entry["cost_note"] = cost_notes[entry["name"]]
        # Phase 17 runs bf16 #1-#3 (and no other kernel): 17a through
        # torchrun at world size 1, 17b's three dp=2 runs and 17c's fsdp=2
        # run on rank 0 of the two sharing the card.
        for key, counts in mesh["launches"].items():
            entry[f"launches_mesh_{key}"] = (
                0 if entry["name"].endswith("_fp16")
                else counts.get(entry["name"], 0))
        # Phase 18: rank 0's counts (bf16 #1-#3; 0 under the ring).
        for key, counts in model_parallel["launches"].items():
            entry[f"launches_mp_{key}"] = (
                0 if entry["name"].endswith("_fp16")
                else counts.get(entry["name"], 0))
        # Phase 20: rank 0's counts, as phase 18's.
        for key, counts in layouts["launches"].items():
            entry[f"launches_mesh_{key}"] = (
                0 if entry["name"].endswith("_fp16")
                else counts.get(entry["name"], 0))
        if entry["name"] in TRAIN_REPLACES:
            entry["launches_handoff"] = handoff["launches"][entry["name"]]
            entry["launches_kfac"] = kfac["launches"][entry["name"]]
            entry["launches_kfac_stats"] = kfac["stats_launches"][
                entry["name"]]
    log(f"[result] {json.dumps(dict(served, checkpoint_write_s=write_s, hot_swap=swap, engine_fp32_max_abs_err=engine_err, int8_serving=served8, int8_engines=int8_errs, training=trained, training_flash_vs_dense=train_check, keep_mask_shares=mask_shares, cost_notes=cost_notes, squad=squad, handoff=handoff, finetune=finetuned, kfac=kfac, kfac_parity=kfac_parity, fp16=dict(keep_mask_shares=shares16, training=trained16, overflow=overflow16, squad=squad16), debug_planes=dict(replica=debug, drain=drain, build=monitor.events), fleet=fleet, feed=feed, roberta=roberta, mesh=mesh, model_parallel=model_parallel, autotune=tuned["serving"], layouts=layouts, lint=lint))}")
    print(json.dumps({"kernels": entries}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": device,
        "count": torch.cuda.device_count()}}))
    return 0


def only_fleet(argv) -> int:
    """Phase 14 alone, at FLEET_LAYERS layers, or at the depth
    ``--fleet_layers N`` names (24, BERT-large's, for the depth's cost):
    :func:`drive_fleet` and its result line (also in
    chiprun_out/phase14_<layers>.json)."""
    layers = FLEET_LAYERS
    if argv:
        if len(argv) != 2 or argv[0] != "--fleet_layers":
            raise SystemExit("usage: chip_smoke.py --only 14 "
                             "[--fleet_layers N]")
        layers = int(argv[1])
    card = card_line()
    with tempfile.TemporaryDirectory() as tmp:
        result = drive_fleet(tmp, card, layers)
    result["layers"] = layers
    log(f"[result] {json.dumps({'fleet': result})}")
    os.makedirs(os.path.join(REPO, "chiprun_out"), exist_ok=True)
    with open(os.path.join(REPO, "chiprun_out", f"phase14_{layers}.json"),
              "w", encoding="utf-8") as f:
        json.dump({"card": card, "fleet": result}, f)
    print(card)
    return 0


def only_layouts() -> int:
    """Phase 20 alone: the kernels built, then :func:`drive_layouts` and its
    result line (also in chiprun_out/phase20.json)."""
    from bert_pytorch_tpu_torch.ops.kernels import build

    torch.backends.cuda.matmul.allow_tf32 = False
    card = card_line()
    t0 = time.perf_counter()
    log(f"[build] {build.build()} in {time.perf_counter() - t0:.2f}s")
    kernels = child_kernels()
    with tempfile.TemporaryDirectory() as tmp:
        result = drive_layouts(kernels, tmp, card)
    log(f"[result] {json.dumps({'layouts': result})}")
    os.makedirs(os.path.join(REPO, "chiprun_out"), exist_ok=True)
    with open(os.path.join(REPO, "chiprun_out", "phase20.json"), "w",
              encoding="utf-8") as f:
        json.dump({"card": card, "layouts": result}, f)
    print(card)
    return 0


def only_model_parallel() -> int:
    """Phase 18 alone: the kernels built, then :func:`drive_model_parallel`
    and its result line."""
    from bert_pytorch_tpu_torch.ops.kernels import build

    card = card_line()
    t0 = time.perf_counter()
    log(f"[build] {build.build()} in {time.perf_counter() - t0:.2f}s")
    kernels = child_kernels()
    with tempfile.TemporaryDirectory() as tmp:
        result = drive_model_parallel(kernels, tmp, card)
    log(f"[result] {json.dumps({'model_parallel': result})}")
    os.makedirs(os.path.join(REPO, "chiprun_out"), exist_ok=True)
    with open(os.path.join(REPO, "chiprun_out", "phase18.json"), "w",
              encoding="utf-8") as f:
        json.dump({"card": card, "model_parallel": result}, f)
    print(card)
    return 0


if __name__ == "__main__":
    try:
        rc = main()
    except Exception:
        traceback.print_exc()
        rc = 1
    sys.exit(rc)
