"""The port's fleet over real port replicas, on the CPU.

(a) The port's :class:`Router` in front of two in-process port replicas
(``run_server.build_service`` + ``make_server``, a 2-layer config,
``--device cpu``): one replica's listener is shut mid-burst and no client
sees it, and the router's and replicas' sinks stitch into one trace tree
per request. (b) The port's ``chaos_serve.py`` as a subprocess with
``--device cpu``: ``--smoke``, ``--canary`` and ``--surge`` (whose
overload is pinned: ten closed-loop clients against a brownout depth of
6 shed on one replica of batch 2 and not on two, where a shed needs both
replicas to report 6 of the 10; its down cooldown of 30 s keeps the
fleet at two replicas until the recovery burst has run). (c) In a fresh
interpreter where torch, JAX and the JAX package cannot be imported,
every fleet module and tool loads by path and ``chaos_serve.py --help``
runs.
"""

from __future__ import annotations

import argparse
import http.client
import http.server
import json
import subprocess
import sys
import threading
import time
from pathlib import Path

import pytest

from bert_pytorch_tpu_torch import run_server
from bert_pytorch_tpu_torch.serve import (Router, make_router_server,
                                          make_server)
from bert_pytorch_tpu_torch.telemetry import schema
from bert_pytorch_tpu_torch.telemetry.collector import (FleetCollector,
                                                        JsonlTailer)
from bert_pytorch_tpu_torch.tools import make_synthetic_data as synth
from bert_pytorch_tpu_torch.utils.retry import RetryPolicy

REPO = Path(__file__).resolve().parents[1]
TOOLS = REPO / "bert_pytorch_tpu_torch" / "tools"
CHAOS = TOOLS / "chaos_serve.py"
PHRASES = ("paris is big", "the river runs through london",
           "william shakespeare wrote hamlet", "england is old")


def _config(root: Path) -> tuple:
    vocab = synth.write_trace_vocab(str(root / "vocab.txt"))
    config = root / "config.json"
    config.write_text(json.dumps({
        "vocab_size": 40, "hidden_size": 32, "num_hidden_layers": 2,
        "num_attention_heads": 2, "intermediate_size": 64,
        "max_position_embeddings": 64, "type_vocab_size": 2,
        "next_sentence": True, "hidden_dropout_prob": 0.0,
        "attention_probs_dropout_prob": 0.0}))
    return vocab, str(config)


class _Replica:
    def __init__(self, root: Path, index: int, vocab: str, config: str):
        self.out = root / f"replica_{index}"
        args = run_server.parse_arguments([
            "--model_config_file", config, "--vocab_file", vocab,
            "--device", "cpu", "--dtype", "float32", "--tasks", "classify",
            "--classify_labels", "neg,pos", "--buckets", "16",
            "--max_batch_size", "4", "--trace_sample_rate", "0",
            "--telemetry_window", "8", "--output_dir", str(self.out)])
        self.service = run_server.build_service(args)
        self.service.engine.warmup()
        self.service.start()
        self.server = make_server(self.service, port=0)
        self.url = "http://127.0.0.1:%d" % self.server.server_address[1]
        self.thread = threading.Thread(target=self.server.serve_forever,
                                       daemon=True)
        self.thread.start()
        self.closed = False

    def kill(self) -> None:
        """Shut the listener: new connections are refused, as after a
        SIGKILL, while requests already accepted finish."""
        if not self.closed:
            self.closed = True
            self.server.shutdown()
            self.server.server_close()

    def close(self) -> None:
        self.kill()
        self.service.stop()
        self.thread.join(timeout=30)
        run_server.close_planes(self.service)


def _post(url: str, payload: dict) -> tuple:
    host, port = url[len("http://"):].split(":")
    conn = http.client.HTTPConnection(host, int(port), timeout=30)
    try:
        conn.request("POST", "/v1/classify", body=json.dumps(payload),
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        body = json.loads(resp.read() or b"{}")
        return resp.status, resp.getheader("X-Bert-Trace-Id"), body
    finally:
        conn.close()


def test_router_hides_a_killed_port_replica(tmp_path):
    vocab, config = _config(tmp_path)
    replicas = [_Replica(tmp_path, i, vocab, config) for i in range(2)]
    router_jsonl = tmp_path / "fleet_telemetry.jsonl"
    lock = threading.Lock()
    sink = open(router_jsonl, "w", encoding="utf-8")

    def emit(rec):
        with lock:
            sink.write(json.dumps(dict(rec, schema=schema.SCHEMA_VERSION,
                                       ts=0.0)) + "\n")

    router = Router([r.url for r in replicas], emit=emit, window=8,
                    scrape_interval_s=0.2, deadline_s=20.0,
                    retry_policy=RetryPolicy(attempts=3, base_delay_s=0.01,
                                             max_delay_s=0.05,
                                             full_jitter=True),
                    hedge_pctl=0.95, hedge_min_samples=10**6,
                    trace_sample_rate=1.0)
    server = make_router_server(router, port=0)
    url = "http://127.0.0.1:%d" % server.server_address[1]
    threading.Thread(target=server.serve_forever, daemon=True).start()
    router.start()
    outcomes = []
    try:
        router.scrape_once()
        assert router.healthy_count() == 2

        def worker(w):
            for i in range(12):
                if w == 0 and i == 3:
                    replicas[0].kill()   # mid-burst
                outcomes.append(_post(url, {"text": PHRASES[i % 4]}))

        threads = [threading.Thread(target=worker, args=(w,))
                   for w in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
        snap = router.snapshot()
    finally:
        server.shutdown()
        server.server_close()
        router.stop()
        for r in replicas:
            r.close()
        with lock:
            sink.close()
    assert len(outcomes) == 48
    assert [o[0] for o in outcomes] == [200] * 48
    assert all(o[1] and o[1].startswith("rt-") for o in outcomes)
    assert all(o[2]["label"] in ("neg", "pos") and set(o[2]["scores"])
               == {"neg", "pos"} for o in outcomes)
    assert snap["errors"] == 0 and snap["failovers"] >= 1
    assert schema.validate_file(str(router_jsonl)) == []
    # One stitched tree per request, from the router's sink and both
    # replicas' serve telemetry.
    timeline = []
    tails = [JsonlTailer(str(router_jsonl), "fleet")] + [
        JsonlTailer(str(r.out / "serve_telemetry.jsonl"), f"replica-{i}")
        for i, r in enumerate(replicas)]
    coll = FleetCollector([], tails=tails, emit=timeline.append)
    coll.collect_once()
    coll.close()
    traces = {r["trace_id"] for r in timeline if r["kind"] == "router_trace"}
    stitches = [r for r in timeline if r["kind"] == "trace_stitch"]
    assert traces == {o[1] for o in outcomes}
    assert sorted(s["trace_id"] for s in stitches) == sorted(traces)
    assert not [s for s in stitches if s["orphan"]]
    assert all(s["consistent"] for s in stitches)
    failed_over = [s for s in stitches if s["winning_attempt"] >= 2]
    assert failed_over and all(s["winning_source"] == "replica-1"
                               for s in failed_over)
    for rec in timeline:
        assert schema.validate_record(rec) == [], rec


def _chaos(tmp_path, *args, timeout=600) -> dict:
    proc = subprocess.run(
        [sys.executable, str(CHAOS), *args, "--device", "cpu",
         "--workdir", str(tmp_path / "chaos")],
        capture_output=True, text=True, timeout=timeout, cwd=REPO)
    lines = proc.stdout.strip().splitlines()
    assert proc.returncode == 0 and lines, (
        f"rc {proc.returncode}\n{proc.stderr[-3000:]}\n"
        f"{proc.stdout[-3000:]}")
    verdict = json.loads(lines[-1])
    assert verdict["ok"] is True, verdict
    return verdict


class _HeldReplica(http.server.BaseHTTPRequestHandler):
    """A replica stand-in whose first ``/statsz`` after ``POST /profilez``
    answers only after the poll's 5 s timeout, as a card replica that
    holds its interpreter while it writes the trace."""

    def log_message(self, *args):
        pass

    def _reply(self, body: dict, trace_id: str = "") -> None:
        raw = json.dumps(body).encode()
        self.send_response(200)
        self.send_header("Content-Length", str(len(raw)))
        if trace_id:
            self.send_header("X-Bert-Trace-Id", trace_id)
        self.end_headers()
        self.wfile.write(raw)

    def do_POST(self):
        self.rfile.read(int(self.headers["Content-Length"]))
        if self.path == "/profilez":
            self.server.posted.set()
            self._reply({"status": "started"})
        else:
            self._reply({"label": "pos"}, trace_id="rt-held")

    def do_GET(self):
        held = self.server.posted.is_set()
        if held and not self.server.stalled.is_set():
            self.server.stalled.set()
            time.sleep(5.5)
        profile = {"captures": int(held), "last": {"trace_bytes": 1}}
        self._reply({"profile": profile, "forwards": 0,
                     "kernel_launches": {}})


def test_capture_poll_waits_out_a_held_replica():
    from bert_pytorch_tpu_torch.tools import chaos_serve

    server = http.server.ThreadingHTTPServer(("127.0.0.1", 0), _HeldReplica)
    server.daemon_threads = True
    server.posted, server.stalled = threading.Event(), threading.Event()
    threading.Thread(target=server.serve_forever, daemon=True).start()
    url = "http://127.0.0.1:%d" % server.server_address[1]
    args = argparse.Namespace(burst_workers=2, client_timeout_s=15.0,
                              profile_s=0.5)
    outcomes = []
    try:
        got = chaos_serve.profile_under_burst(args, url, url, 1, outcomes)
    finally:
        server.shutdown()
        server.server_close()
    assert server.stalled.is_set()
    assert got["polls_timed_out"] >= 1
    assert got["last"] == {"trace_bytes": 1} and got["requests"] > 0
    assert all(o["status"] == 200 for o in outcomes)


def test_chaos_serve_smoke_on_cpu_replicas(tmp_path):
    v = _chaos(tmp_path, "--smoke", "--profile_s", "2")
    for phase in ("phase_a", "phase_b", "phase_c", "phase_d"):
        assert v[phase]["failures"] == 0
    assert v["phase_a"]["admit_hold_observed"]
    assert v["wedged_kills"] == 1   # the planted wedge alone
    assert v["restart_compiles_cold"] == 0
    assert v["drain"]["rcs"]["0"] == 75
    assert v["phase_d"]["torn_serves"] == 0
    assert v["trace"]["orphans"] == 0
    assert v["trace"]["stitches"] == v["trace"]["router_traces"]
    assert v["report_gate"] == {"doctored_rc": 1, "clean_rc": 0}
    # CPU replicas run no CUDA library: nothing built, nothing launched.
    assert v["first_builds"] == {} and v["kernel_launches"] == {}
    assert v["profile"]["last"]["trace_bytes"] > 0
    assert v["profile"]["forwards"][1] > v["profile"]["forwards"][0]


def test_chaos_serve_canary_on_cpu_replicas(tmp_path):
    v = _chaos(tmp_path, "--canary")
    assert v["torn_serves"] == 0
    assert [w["action"] for w in v["happy_windows"]][-1] == "promote"
    assert v["degraded_window"]["action"] == "rollback"
    assert v["wedged_kills"] == 0
    assert v["report_gate"] == {"breach_rc": 1, "clean_rc": 0}


def test_chaos_serve_surge_on_cpu_replicas(tmp_path):
    # The down cooldown outlasts the elastic start, the seed's respawn
    # and the recovery burst on a loaded box (JAX's 6 s did not).
    v = _chaos(tmp_path, "--surge", "--surge_down_cooldown_s", "30")
    assert v["elastic_compiles_cold"] == 0
    assert v["phase_post"]["sheds"] == 0
    assert v["controller"]["thrash"] == 0
    assert v["report_gate"] == {"breach_rc": 1, "clean_rc": 0}


FLEET_FILES = (("serve", "supervisor.py"), ("serve", "router.py"),
               ("serve", "autoscaler.py"), ("serve", "registry.py"),
               ("serve", "rollout.py"), ("telemetry", "collector.py"),
               ("telemetry", "report.py"), ("telemetry", "ledger.py"),
               ("telemetry", "schema.py"), ("utils", "retry.py"))
TOOL_FILES = ("telemetry_report.py", "obs_collect.py", "model_registry.py",
              "chaos_serve.py")


def test_fleet_loads_with_torch_and_jax_unimportable():
    code = (
        "import contextlib, importlib.util, io, sys\n"
        "for name in ('torch', 'jax', 'jaxlib', 'flax', 'numpy',\n"
        "             'bert_pytorch_tpu', 'bert_pytorch_tpu_torch'):\n"
        "    sys.modules[name] = None\n"
        f"tools = {str(TOOLS)!r}\n"
        "sys.path.insert(0, tools)\n"
        "from _bootstrap import load_by_path\n"
        f"for i, rel in enumerate({FLEET_FILES!r}):\n"
        "    load_by_path(f'_torchcheck_{i}', *rel)\n"
        f"for name in {TOOL_FILES!r}:\n"
        "    mod = load_by_path('_torchcheck_' + name[:-3], 'tools', name)\n"
        "chaos = sys.modules['_torchcheck_chaos_serve']\n"
        "out = io.StringIO()\n"
        "with contextlib.redirect_stdout(out):\n"
        "    try:\n"
        "        chaos.main(['--help'])\n"
        "    except SystemExit as exc:\n"
        "        assert exc.code == 0, exc.code\n"
        "assert '--smoke' in out.getvalue() and '--device' in out.getvalue()\n"
        "bad = [k for k, v in sys.modules.items() if v is not None and\n"
        "       k.split('.')[0] in ('torch', 'numpy', 'jax')]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=str(REPO),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")
    help_run = subprocess.run([sys.executable, str(CHAOS), "--help"],
                              capture_output=True, text=True, timeout=120)
    assert help_run.returncode == 0 and "--profile_s" in help_run.stdout
