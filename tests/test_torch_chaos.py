"""The port's chaos harness (``bert_pytorch_tpu_torch/tools/chaos_run.py``)
as the tier-1 gate of its pretraining runner's recovery: three CPU
children of ``python -m bert_pytorch_tpu_torch.run_pretraining`` (a
reference, one SIGKILLed at step 5 after two injected shard-read errors,
a resume past a truncated checkpoint) whose resumed losses match the
reference's at 1e-6 (about 20 s on a free CPU). Its parent imports no
torch."""

import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOL = os.path.join(REPO, "bert_pytorch_tpu_torch", "tools", "chaos_run.py")


def test_chaos_smoke_resumes_exactly(tmp_path):
    # One intra-op thread a child: the tiny model gains nothing from more,
    # and the suite's other workers keep their cores.
    out = subprocess.run(
        [sys.executable, TOOL, "--smoke", "--device", "cpu", "--workdir",
         str(tmp_path)],
        cwd=REPO, capture_output=True, text=True, timeout=600,
        env=dict(os.environ, OMP_NUM_THREADS="1"))
    verdict = json.loads(out.stdout.strip().splitlines()[-1])
    assert out.returncode == 0 and verdict["ok"], (verdict, out.stderr[-2000:])
    assert verdict["device"] == "cpu"
    assert (verdict["steps"], verdict["die_at"], verdict["corrupted_step"],
            verdict["resume_step"], verdict["compared_steps"]) == (
        8, 5, 4, 2, 6)
    assert [s["step"] for s in verdict["skipped"]] == [4]
    records = [json.loads(line) for line in open(
        tmp_path / "chaos" / "pretraining_telemetry.jsonl")]
    faults = [r["fault"] for r in records if r.get("kind") == "fault"]
    assert faults.count("injected_shard_error") == 2
    assert faults.count("shard_read_retry") == 2
    assert faults.count("injected_die") == 1


def test_chaos_parent_imports_no_torch():
    code = ("import sys\n"
            "sys.modules['torch'] = None\n"
            f"sys.path.insert(0, {os.path.dirname(TOOL)!r})\n"
            "import chaos_run\n"
            "assert not any(m == 'torch' or m.startswith('torch.')\n"
            "               for m, v in sys.modules.items() if v)\n"
            "print('ok', chaos_run.MODEL_CONFIG['hidden_size'])\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["ok", "16"]
