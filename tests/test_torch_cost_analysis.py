"""The port's compile and cost attribution on the CPU: the trainers' step
functions wrapped by ``TrainTelemetry.instrument``
(telemetry/compile_events.py ``CompileMonitor.instrument``), the cost
counter around each new shapes digest's first call (telemetry/memory.py
``analyze_executable``), and the hand-written kernels' cost notes
(ops/kernels/attention.py, layernorm.py).

Held here: the tiny pretraining, SQuAD and GLUE runs emit one ``compile``
and one ``compile_cost`` record per instrumented function, joined by
``shapes_digest`` and valid under the port's schema and the JAX one; at
remat ``none`` the train step's counted flops equal the closed form from
the layer shapes exactly (both count each product's ``2*M*N*K``), under
``auto`` and ``full`` alike, and ``off`` emits none; each kernel's note
equals the count of its plain version; the counter runs once per digest;
``nvcc`` builds inside a call set its ``cache``; ``full``'s allocator
reading keeps the memory sampler's peak; and rank 0 of a dp=2 gloo run
counts what one process counts at the same local batch.
"""

import json
import threading

import numpy as np
import pytest
import torch

from bert_pytorch_tpu.telemetry import schema as jax_schema
from bert_pytorch_tpu_torch import pretrain, run_glue, run_pretraining, \
    run_squad
from bert_pytorch_tpu_torch.config import BertConfig
from bert_pytorch_tpu_torch.models import bert
from bert_pytorch_tpu_torch.ops.kernels import attention as ka
from bert_pytorch_tpu_torch.ops.kernels import build
from bert_pytorch_tpu_torch.ops.kernels import layernorm as kl
from bert_pytorch_tpu_torch.optim import schedules, transforms
from bert_pytorch_tpu_torch.telemetry import compile_events, memory, report, \
    schema
from bert_pytorch_tpu_torch.tools import make_synthetic_data as synth

# The pretraining runs: 2 layers at hidden 32, S=32, 4 rows x 2
# microbatches a step, 5 MLM predictions a row.
L, H, I, V, S, B, A, P = 2, 32, 64, 64, 32, 4, 2, 5
PRETRAIN = dict(vocab_size=V, hidden_size=H, num_hidden_layers=L,
                num_attention_heads=4, intermediate_size=I,
                max_position_embeddings=S, type_vocab_size=2,
                next_sentence=True, hidden_dropout_prob=0.0,
                attention_probs_dropout_prob=0.0)


def train_flops(layers, rows, seq, hidden, inter, vocab, preds, micro=1,
                nsp=True):
    """The closed form of a pretraining step's products at remat none:
    each dense layer ``M x in x out`` costs 2MNK forward and twice that
    backward (the input's and the weight's gradients); attention's QK^T
    and PV cost 4*rows*S^2*hidden forward and twice that backward; the MLM
    transform and tied decoder run on the gathered ``preds`` rows, the
    pooler and NSP classifier on the [CLS] rows."""
    def dense(m, k, n):
        return 6 * m * k * n

    tokens = rows * seq
    layer = (dense(tokens, hidden, 3 * hidden) + dense(tokens, hidden, hidden)
             + dense(tokens, hidden, inter) + dense(tokens, inter, hidden)
             + 12 * rows * seq * seq * hidden)
    heads = (dense(rows * preds, hidden, hidden)
             + dense(rows * preds, hidden, vocab))
    if nsp:
        heads += dense(rows, hidden, hidden) + dense(rows, hidden, 2)
    return micro * (layers * layer + heads)


def read_kinds(path) -> dict:
    kinds = {}
    with open(path) as f:
        for line in f:
            rec = json.loads(line)
            kinds.setdefault(rec.get("kind", "metric"), []).append(rec)
    return kinds


def joined(kinds) -> dict:
    """fn -> [(compile, compile_cost)] joined by shapes_digest; every
    record has its partner."""
    costs = {(r["fn"], r["shapes_digest"]): r
             for r in kinds.get("compile_cost", [])}
    assert len(costs) == len(kinds.get("compile_cost", []))
    pairs = {}
    for rec in kinds.get("compile", []):
        cost = costs.pop((rec["fn"], rec["shapes_digest"]))
        pairs.setdefault(rec["fn"], []).append((rec, cost))
    assert not costs
    return pairs


def both_schemas_accept(path):
    assert schema.validate_file(str(path)) == []
    assert jax_schema.validate_file(str(path)) == []


@pytest.fixture(scope="module")
def pretrain_runs(tmp_path_factory):
    """run_pretraining at remat none, 2 steps: ``auto`` with a held-out
    pass every step, ``full`` and ``off`` without."""
    root = tmp_path_factory.mktemp("cost_pre")
    config = root / "tiny.json"
    config.write_text(json.dumps(PRETRAIN))
    runs = {}
    for mode in ("auto", "full", "off"):
        out = root / mode
        argv = ["--model_config_file", str(config), "--output_dir", str(out),
                "--global_batch_size", str(A * B), "--local_batch_size",
                str(B), "--max_steps", "2", "--steps", "2", "--device",
                "cpu", "--dtype", "float32", "--max_predictions_per_seq",
                str(P), "--skip_final_checkpoint", "--remat", "none",
                "--telemetry_cost_analysis", mode]
        val = None
        if mode == "auto":
            argv += ["--num_steps_per_eval", "1", "--eval_batches", "1"]
            val = synth.SyntheticPretrainingDataset(9, A * B, S, V, P)
        run_pretraining.main(
            run_pretraining.parse_arguments(argv),
            synth.SyntheticPretrainingDataset(0, 2 * A * B, S, V, P), val)
        runs[mode] = out / "pretraining_telemetry.jsonl"
    return runs


def test_pretraining_records_join_and_pass_both_schemas(pretrain_runs):
    path = pretrain_runs["auto"]
    both_schemas_accept(path)
    pairs = joined(read_kinds(path))
    assert sorted(pairs) == ["eval_step", "train_step"]
    for fn, recs in pairs.items():
        (rec, cost), = recs  # one digest each: the shapes never change
        assert rec["cache"] == "jit" and rec["backend_compile_s"] == 0.0
        assert rec["compile_s"] > 0 and cost["analysis"] == "counted"
        assert cost["flops"] > 0 and cost["bytes_accessed"] > 0
        assert cost["argument_bytes"] > 0 and cost["output_bytes"] > 0
        assert "temp_bytes" not in cost
    train = pairs["train_step"][0][1]
    # The step reads the parameters, LAMB's two moments and the batch; it
    # writes the parameters and moments in place.
    n_params = sum(p.numel() for p in bert.BertForPreTraining(
        BertConfig(**PRETRAIN), torch.float32, "dense").parameters())
    assert train["argument_bytes"] >= 3 * 4 * n_params
    assert train["output_bytes"] >= 3 * 4 * n_params
    # The held-out step runs one microbatch forward only.
    assert pairs["eval_step"][0][1]["flops"] < train["flops"] / A


def test_train_step_flops_equal_the_closed_form(pretrain_runs):
    want = train_flops(L, B, S, H, I, V, P, micro=A)
    for mode in ("auto", "full"):
        (_, cost), = joined(read_kinds(pretrain_runs[mode]))["train_step"]
        assert cost["flops"] == want, mode
        # On the CPU full has no allocator to read.
        assert cost["analysis"] == "counted" and "temp_bytes" not in cost


def test_off_emits_no_compile_records(pretrain_runs):
    kinds = read_kinds(pretrain_runs["off"])
    assert "compile_cost" not in kinds
    # The compile record is the monitor's, whatever the cost mode.
    assert [r["fn"] for r in kinds["compile"]] == ["train_step"]
    both_schemas_accept(pretrain_runs["off"])


@pytest.fixture(scope="module")
def squad_run(tmp_path_factory):
    """run_squad with --layer_norm_backend kernel: 2 steps and the
    prediction."""
    root = tmp_path_factory.mktemp("cost_squad")
    vocab = synth.write_trace_vocab(str(root / "vocab.txt"))
    data = synth.write_squad_json(str(root / "s.json"), 0, 1)
    config = root / "tiny.json"
    config.write_text(json.dumps(dict(
        PRETRAIN, vocab_size=48, max_position_embeddings=128,
        tokenizer="wordpiece")))
    out = root / "out"
    run_squad.main(run_squad.parse_args([
        "--output_dir", str(out), "--config_file", str(config),
        "--vocab_file", vocab, "--do_lower_case", "--skip_checkpoint",
        "--device", "cpu", "--dtype", "float32", "--max_seq_length", "64",
        "--doc_stride", "32", "--max_query_length", "16", "--train_file",
        data, "--predict_file", data, "--do_train", "--do_predict",
        "--train_batch_size", "4", "--predict_batch_size", "4",
        "--max_steps", "2", "--layer_norm_backend", "kernel",
        "--skip_cache"]))
    return out / "squad_telemetry.jsonl"


def test_squad_train_and_predict_steps(squad_run):
    both_schemas_accept(squad_run)
    pairs = joined(read_kinds(squad_run))
    assert sorted(pairs) == ["predict_step", "train_step"]
    (_, train), = pairs["train_step"]
    (_, predict), = pairs["predict_step"]
    # Forward + backward against forward, 4 rows each: up to 3x.
    assert 2 * predict["flops"] < train["flops"] <= 3 * predict["flops"]


def test_report_names_the_heaviest_function(squad_run):
    summary = report.summarize_file(str(squad_run))
    assert summary["profile_critical_device"] == "train_step"


def test_glue_train_and_eval_steps(tmp_path):
    root = tmp_path
    vocab = synth.write_trace_vocab(str(root / "vocab.txt"))
    config = root / "model.json"
    config.write_text(json.dumps(dict(
        PRETRAIN, vocab_size=37, max_position_embeddings=64,
        vocab_file=vocab, tokenizer="wordpiece")))
    mrpc = synth.write_mrpc_tsvs(str(root / "MRPC"), 0, 16, 8)
    out = root / "out"
    run_glue.main(run_glue.parse_arguments([
        "--task", "mrpc", "--data_dir", mrpc, "--batch_size", "8",
        "--model_config_file", str(config), "--output_dir", str(out),
        "--device", "cpu", "--dtype", "float32", "--max_seq_len", "32",
        "--epochs", "1"]))
    path = out / "glue_telemetry.jsonl"
    both_schemas_accept(path)
    pairs = joined(read_kinds(path))
    assert sorted(pairs) == ["eval_step", "train_step"]
    assert len(pairs["train_step"]) == 1  # every batch padded to 8 rows


# -- the kernels' notes ------------------------------------------------------

SHAPES = ((2, 24, 3, 16), (1, 64, 2, 32), (3, 40, 4, 8))
DTYPES = (torch.float32, torch.bfloat16, torch.float16)


def counted(fn):
    counter = memory.CostCounter()
    with counter:
        out = fn()
    assert counter.kernel_notes == 0  # the CPU ran the plain version
    return counter.flops, out


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_training_kernel_notes_equal_their_plain_counts(shape, dtype, rate):
    batch, seq, heads, depth = shape
    gen = torch.Generator().manual_seed(seq)
    q, k, v, do = (torch.randn(shape, generator=gen).to(dtype)
                   for _ in range(4))
    key_bias = torch.zeros(batch, seq)
    flops, (out, lse) = counted(lambda: ka.flash_attention_fwd(
        q, k, v, key_bias, None, 11, rate))
    assert flops == ka.train_cost("flash_attention_fwd", *shape, dtype).flops
    flops, (_, delta) = counted(lambda: ka.flash_attention_dq(
        q, k, v, out, do, lse, key_bias, None, 11, rate))
    assert flops == ka.train_cost("flash_attention_dq", *shape, dtype).flops
    flops, _ = counted(lambda: ka.flash_attention_dkv(
        q, k, v, do, lse, delta, key_bias, None, 11, rate))
    assert flops == ka.train_cost("flash_attention_dkv", *shape, dtype).flops


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_serving_and_layer_norm_notes_equal_their_plain_counts(shape):
    batch, seq, heads, depth = shape
    gen = torch.Generator().manual_seed(seq)
    q, k, v = (torch.randn(shape, generator=gen) for _ in range(3))
    flops, _ = counted(lambda: ka.flash_attention_infer(q, k, v))
    assert flops == ka.infer_cost(*shape, torch.float32).flops
    q8, q_scale, k8, k_scale = ka.quantize_qk(q, k)
    flops, _ = counted(lambda: ka.flash_attention_infer_int8_prequantized(
        q8, k8, q_scale, k_scale, v))
    cost = ka.infer_int8_cost(*shape, torch.float32)
    assert flops == cost.flops == 2 * cost.int8_ops
    x = torch.randn(batch * seq, heads * depth, generator=gen)
    flops, _ = counted(lambda: kl.layer_norm_fwd(
        x, torch.ones(heads * depth), torch.zeros(heads * depth)))
    assert flops == kl.layer_norm_cost(batch * seq, heads * depth,
                                       torch.float32).flops == 0


def test_a_note_reaches_the_counter_from_another_thread():
    """A kernel's note made during an instrumented call reaches that
    call's counter, from its own thread or from another (autograd's CUDA
    backward thread), as a build does; outside a call, or under ``off``,
    nothing counts it and its cost is never computed."""
    cost = build.KernelCost(flops=10, bytes_accessed=7)
    computed = []

    def cost_fn():
        computed.append(1)
        return cost

    def step(x):
        build.note_cost(cost_fn)
        worker = threading.Thread(target=build.note_cost, args=(cost_fn,))
        worker.start()
        worker.join()
        return x

    records = []
    compile_events.CompileMonitor(records.append, cost_analysis="auto") \
        .instrument(step, "step")(torch.ones(1))
    assert [(r["flops"], r["bytes_accessed"], r["kernel_notes"])
            for r in records if r["kind"] == "compile_cost"] == [(20, 14, 2)]
    build.note_cost(cost_fn)  # no call running: dropped
    compile_events.CompileMonitor(cost_analysis="off").instrument(
        step, "step")(torch.ones(1))
    assert len(computed) == 2
    # A counter entered by hand is no instrumented call's: notes miss it.
    counter = memory.CostCounter()
    with counter:
        build.note_cost(cost_fn)
    assert (counter.kernel_notes, len(computed)) == (0, 2)


# -- the monitor ---------------------------------------------------------------

def test_a_tensor_the_call_allocates_is_no_argument():
    """A buffer the call makes bare (``empty*``, as a kernel wrapper makes
    its outputs) and then writes and reads is neither an argument nor an
    output: only the tensor passed in and the result are."""
    x = torch.randn(1000)

    def step(x):
        y = torch.empty_like(x)
        y.copy_(x)
        return (y * 2).sum()

    _, fields = memory.analyze_executable(step, (x,), {})
    assert (fields["argument_bytes"], fields["output_bytes"]) == (4000, 4)


def test_the_counter_runs_once_per_digest(monkeypatch):
    calls = []
    analyze = memory.analyze_executable

    def spy(*args, **kwargs):
        calls.append(1)
        return analyze(*args, **kwargs)

    monkeypatch.setattr(memory, "analyze_executable", spy)
    records = []
    monitor = compile_events.CompileMonitor(records.append,
                                           cost_analysis="auto")
    weight = torch.randn(8, 8)
    step = monitor.instrument(lambda x: x @ weight, "step")
    for value in (1.0, 2.0, 3.0):  # values never make a new digest
        step(torch.full((4, 8), value))
    step(torch.ones(6, 8))
    assert len(calls) == 2
    assert [r["kind"] for r in records] == ["compile", "compile_cost"] * 2
    assert [r["flops"] for r in records[1::2]] == [2 * 4 * 64, 2 * 6 * 64]
    assert records[0]["shapes_digest"] != records[2]["shapes_digest"]
    assert len(records[0]["shapes_digest"]) == 12
    with pytest.raises(ValueError, match="cost_analysis"):
        compile_events.CompileMonitor(records.append,
                                      cost_analysis="lowered")


def test_builds_inside_a_call_set_its_cache():
    """A build reported during the call (on its thread, or on another,
    as autograd's CUDA backward thread) is that call's: nvcc ran = miss
    with its seconds, found on disk = hit, none = jit."""
    records = []
    monitor = compile_events.CompileMonitor(records.append,
                                           cost_analysis="off")

    def builds(x, built):
        compile_events.report_build("lib_a", "d1", 2.5, built)
        other = threading.Thread(target=compile_events.report_build,
                                 args=("lib_b", "d2", 1.0, built))
        other.start()
        other.join()
        return x

    step = monitor.instrument(builds, "step")
    step(torch.ones(1), True)
    step(torch.ones(2), False)
    caches = [(r["cache"], r["backend_compile_s"]) for r in records]
    assert caches == [("miss", 3.5), ("hit", 0.0)]
    records.clear()
    monitor.instrument(lambda x: x, "idle")(torch.ones(1))
    assert records[0]["cache"] == "jit"


def test_full_keeps_the_samplers_peak(monkeypatch):
    """``full`` resets the CUDA allocator's peak for its reading; the
    run's memory sampler's peak_bytes_in_use stays the run's high-water
    mark, while a later sampler, after the caller's own reset, reads the
    allocator's new peak (the allocator is faked: no card here)."""
    state = {"allocated": 100, "peak": 900}

    def reset(device=None):
        state["peak"] = state["allocated"]

    def run(x):
        state["allocated"] += 300  # a temporary of 300 bytes
        state["peak"] = max(state["peak"], state["allocated"])
        state["allocated"] -= 300
        return x

    monkeypatch.setattr(torch.cuda, "synchronize", lambda device=None: None)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "memory_allocated",
                        lambda device=None: state["allocated"])
    monkeypatch.setattr(torch.cuda, "max_memory_allocated",
                        lambda device=None: state["peak"])
    monkeypatch.setattr(torch.cuda, "reset_peak_memory_stats", reset)
    monkeypatch.setattr(torch.cuda, "memory_stats", lambda device: {
        "allocated_bytes.all.current": state["allocated"],
        "allocated_bytes.all.peak": state["peak"]})

    class Props:
        total_memory = 10 ** 6

    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda device: Props())
    records = []
    sampler = memory.MemorySampler(records.append, device="cuda:0")
    monitor = compile_events.CompileMonitor(
        records.append, cost_analysis="full", device="cuda:0",
        sampler=sampler)
    monitor.instrument(run, "step")(torch.ones(1))
    cost, = [r for r in records if r["kind"] == "compile_cost"]
    assert cost["temp_bytes"] == 300
    assert cost["analysis"] == "counted_allocator"
    sampler.sample(1)
    sampler.flush(1)
    assert records[-1]["peak_bytes_in_use"] == 900
    reset()  # the caller's own reset, after the run
    run(torch.ones(1))
    later = memory.MemorySampler(records.append, device="cuda:0")
    later.sample(2)
    later.flush(2)
    assert records[-1]["peak_bytes_in_use"] == 400 == state["peak"]


# -- a mesh: each rank counts its own work -------------------------------------

def test_dp2_rank_zero_counts_one_process_at_its_local_batch(tmp_path):
    import layout_common as common

    batch = common.stacked(1)
    np.savez(tmp_path / "batch.npz", **batch)
    case = common.case("cost_dp", "cost", tmp_path, "dp=2")
    case.update(params=None, batch=str(tmp_path / "batch.npz"))
    group = common.Group(tmp_path / "w2", 2, [case])
    # One process at rank 0's rows, counted in this one.
    cfg = BertConfig(**common.CONFIG)
    model = bert.BertForPreTraining(cfg, torch.float32, "dense", "none")
    schedule = schedules.warmup_poly_schedule(*common.SCHEDULE)
    opt = transforms.Lamb(transforms.param_groups(model, 0.01), schedule)
    step = pretrain.make_train_step(
        model, opt, schedule, next_sentence=True,
        max_pred_per_seq=common.P, generator=torch.Generator().manual_seed(0),
        stats_every=1)
    rows = common.B // 2
    local = {k: torch.from_numpy(np.ascontiguousarray(v[:, :rows])).long()
             for k, v in batch.items()}
    _, fields = memory.analyze_executable(step, (local,), {})
    ranks = [group.json("cost_dp", r) for r in range(2)]
    for records in ranks:
        cost, = [r for r in records if r["kind"] == "compile_cost"]
        assert cost["flops"] == fields["flops"] == train_flops(
            2, rows, common.S, 64, 128, 128, common.P, micro=common.A)
