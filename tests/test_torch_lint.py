"""torchlint, the port's static analyzer (bert_pytorch_tpu_torch/analysis/),
held to its own fixtures, to the JAX package's jaxlint, and to the port's
tree.

* Fixtures: one positive and one negative file per check ID under
  tests/fixtures/torchlint/, written in the port's idioms; each positive
  gives exactly its expected count of its ID, and that count is the one
  the JAX analyzer gives on its own tests/fixtures/jaxlint/ fixture (run
  here), so no family lost its reach in the restatement.
* Framework-neutral sources (suppression comments, the baseline and its
  line shifts, JL000/JL001, the lock discipline with a fixture registry,
  the telemetry kinds and argparse flags): both analyzers give the same
  (ID, line, col).
* The gate: the port's tree lints clean against its committed baseline,
  with no stale entries, fast; the CLI runs with torch and JAX poisoned
  and exits 0, and exits 1 naming the ID on a seeded violation.
* The mirrors: analysis/axes.py against parallel/mesh.py and the split
  table, the concurrency registry against the modules it names, the sync
  gates against the telemetry facade, the keyed builders against their
  modules — all by parsing.
"""

from __future__ import annotations

import ast
import os
import subprocess
import sys
import time

import pytest

from bert_pytorch_tpu.analysis import core as jax_core
from bert_pytorch_tpu.analysis import baseline as jax_baseline
from bert_pytorch_tpu.analysis.concurrency import Entry as JaxEntry
from bert_pytorch_tpu_torch.analysis import baseline as baseline_mod
from bert_pytorch_tpu_torch.analysis import (axes, check_all, cli,
                                             concurrency, core, host_sync,
                                             recompile)
from bert_pytorch_tpu_torch.analysis.concurrency import Entry

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGE = os.path.join(REPO_ROOT, "bert_pytorch_tpu_torch")
FIXTURES = os.path.join(REPO_ROOT, "tests", "fixtures", "torchlint")
JAX_FIXTURES = os.path.join(REPO_ROOT, "tests", "fixtures", "jaxlint")
BASELINE = os.path.join(PACKAGE, "torchlint_baseline.json")
TOOLS = os.path.join(PACKAGE, "tools")


def _fixture_registry(entry_cls):
    """The lock-discipline fixtures' entries (they are not part of either
    package), for either analyzer's Entry class."""
    return (
        entry_cls("lk501_pos.py", "count", kind="lock", cls="Gauges",
                  locks=("_lock",)),
        entry_cls("lk501_neg.py", "count", kind="lock", cls="Gauges",
                  locks=("_lock",)),
        entry_cls("lk502_pos.py", "sink", kind="frozen", cls="Emitter"),
        entry_cls("lk502_neg.py", "sink", kind="frozen", cls="Emitter"),
        entry_cls("lk503_pos.py", "_stats", kind="confined",
                  cls="Prefetcher", forbidden_in=("_worker",)),
        entry_cls("lk503_neg.py", "_stats", kind="confined",
                  cls="Prefetcher", forbidden_in=("_worker",)),
    )


FIXTURE_REGISTRY = _fixture_registry(Entry)
JAX_FIXTURE_REGISTRY = _fixture_registry(JaxEntry)


def run_fixture(name, root=FIXTURES):
    """The port's analyzer on one fixture, the fixture's mini telemetry
    schema parsed as program context (CT801 judges kinds against it)."""
    return core.run_files([os.path.join(root, name)], repo_root=REPO_ROOT,
                          registry=FIXTURE_REGISTRY,
                          context_paths=[os.path.join(root, "telemetry",
                                                      "schema.py")])


def run_jax_fixture(name, root=JAX_FIXTURES):
    return jax_core.run_files([os.path.join(root, name)],
                              repo_root=REPO_ROOT,
                              registry=JAX_FIXTURE_REGISTRY,
                              context_paths=[os.path.join(
                                  root, "telemetry", "schema.py")])


def _keys(findings):
    return [(f.check, f.line, f.col) for f in findings]


CHECK_IDS = sorted(set(core.ALL_CHECK_IDS) - {core.JL_BAD_ID, core.JL_PARSE})

# The count each positive torch fixture gives — the JAX fixture's count,
# checked against the JAX analyzer below.
POSITIVE = {
    "HS101": 4, "RC201": 2, "RC202": 3, "RC203": 1, "RN301": 2,
    "RN302": 2, "TL401": 2, "LK501": 1, "LK502": 1, "LK503": 1,
    "SD601": 2, "SD602": 2, "SD603": 5, "DN701": 2, "CT801": 2,
    "CT802": 2,
}


# -- the check-ID set and the fixtures -----------------------------------

def test_check_ids_equal_the_jax_packages():
    assert set(core.ALL_CHECK_IDS) == set(jax_core.ALL_CHECK_IDS)
    assert set(POSITIVE) == set(CHECK_IDS)


@pytest.mark.parametrize("check_id", CHECK_IDS)
def test_every_check_id_has_both_fixtures(check_id):
    for suffix in ("pos", "neg"):
        path = os.path.join(FIXTURES, f"{check_id.lower()}_{suffix}.py")
        assert os.path.exists(path), f"missing fixture {path}"


@pytest.mark.parametrize("check_id", CHECK_IDS)
def test_positive_fixture(check_id):
    name = f"{check_id.lower()}_pos.py"
    findings = run_fixture(name)
    assert [f.check for f in findings] == [check_id] * POSITIVE[check_id], (
        f"{name}: expected {POSITIVE[check_id]}x {check_id}, got:\n"
        + "\n".join(f.format() for f in findings))


@pytest.mark.parametrize("check_id", CHECK_IDS)
def test_negative_fixture(check_id):
    name = f"{check_id.lower()}_neg.py"
    findings = run_fixture(name)
    assert findings == [], f"{name}: expected clean, got:\n" + "\n".join(
        f.format() for f in findings)


@pytest.mark.parametrize("check_id", CHECK_IDS)
def test_positive_count_matches_the_jax_analyzer(check_id):
    """The JAX analyzer on its own positive fixture gives the count the
    port's positive fixture gives: the restated check reaches as many
    sites of its hazard."""
    jax_ids = [f.check for f in run_jax_fixture(f"{check_id.lower()}_pos.py")]
    assert jax_ids == [check_id] * POSITIVE[check_id], jax_ids


# Sources that are the same for both frameworks: both analyzers, each with
# its own fixture registry, give the same (ID, line, col).
NEUTRAL = ["lk501_pos.py", "lk501_neg.py", "lk502_pos.py", "lk502_neg.py",
           "lk503_pos.py", "lk503_neg.py", "ct801_pos.py", "ct801_neg.py",
           "ct802_pos.py", "ct802_neg.py"]


@pytest.mark.parametrize("name", NEUTRAL)
def test_neutral_fixture_matches_the_jax_analyzer(name):
    ours = _keys(run_fixture(name))
    theirs = _keys(jax_core.run_files(
        [os.path.join(FIXTURES, name)], repo_root=REPO_ROOT,
        registry=JAX_FIXTURE_REGISTRY,
        context_paths=[os.path.join(FIXTURES, "telemetry", "schema.py")]))
    assert ours == theirs
    # ... and on the JAX package's own copy of the fixture.
    assert _keys(run_fixture(name, JAX_FIXTURES)) == _keys(
        run_jax_fixture(name))


# -- suppression, JL000/JL001: the same answers as jaxlint ---------------

HOT_LOOP = """def train(tele, loader, step_fn, state):
    for batch in tele.timed(loader):
        state, m = step_fn(state, batch)
        x = float(m["loss"]){comment}
    return state, x
"""

SUPPRESSION_CASES = {
    "none": HOT_LOOP.format(comment=""),
    "same_line": HOT_LOOP.format(comment="  # {tool}: disable=HS101"),
    "line_above": HOT_LOOP.format(comment="").replace(
        "        x = float(", "        # {tool}: disable=HS101\n"
        "        x = float("),
    "in_docstring": ('"""Docs quoting # {tool}: disable=HS101 must not '
                     'suppress."""\n') + HOT_LOOP.format(comment=""),
    "unknown_id": HOT_LOOP.format(comment="  # {tool}: disable=HS999"),
    "other_id": HOT_LOOP.format(comment="  # {tool}: disable=LK501"),
    "parse_error": "def train(:\n",
}
SUPPRESSION_EXPECT = {
    "none": ["HS101"], "same_line": [], "line_above": [],
    "in_docstring": ["HS101"], "unknown_id": ["HS101", "JL000"],
    "other_id": ["HS101"], "parse_error": ["JL001"],
}


def _lint_both(tmp_path, template):
    ours_path = tmp_path / "ours" / "mod.py"
    theirs_path = tmp_path / "theirs" / "mod.py"
    for path, tool in ((ours_path, "torchlint"), (theirs_path, "jaxlint")):
        path.parent.mkdir()
        path.write_text(template.replace("{tool}", tool))
    ours = core.run_files([str(ours_path)], repo_root=str(ours_path.parent))
    theirs = jax_core.run_files([str(theirs_path)],
                                repo_root=str(theirs_path.parent))
    return ours, theirs


@pytest.mark.parametrize("case", sorted(SUPPRESSION_CASES))
def test_suppression_matches_the_jax_analyzer(tmp_path, case):
    ours, theirs = _lint_both(tmp_path, SUPPRESSION_CASES[case])
    assert sorted(f.check for f in ours) == SUPPRESSION_EXPECT[case]
    assert sorted(_keys(ours)) == sorted(_keys(theirs))
    if case == "unknown_id":
        jl = [f for f in ours if f.check == core.JL_BAD_ID][0]
        assert "HS999" in jl.message


def test_hot_marker_matches_the_jax_analyzer(tmp_path):
    source = ("import numpy as np\n\n\n# {tool}: hot\n"
              "def consume(outputs):\n    return np.asarray(outputs)\n")
    ours, theirs = _lint_both(tmp_path, source)
    assert _keys(ours) == _keys(theirs) == [("HS101", 6, 11)]


# -- the baseline ----------------------------------------------------------

def test_baseline_round_trip_matches_the_jax_analyzer(tmp_path):
    """Line-shift stability and fixed-line staleness, with both packages'
    baseline modules over both analyzers' findings of one source."""
    source = HOT_LOOP.format(comment="")
    path = tmp_path / "mod.py"
    path.write_text(source)
    analyzers = ((core, baseline_mod), (jax_core, jax_baseline))
    lint = {mod: (lambda m=mod: m.run_files([str(path)],
                                            repo_root=str(tmp_path)))
            for mod, _ in analyzers}
    entries = {}
    for mod, base in analyzers:
        bpath = str(tmp_path / f"{mod.__name__}.json")
        assert base.write_baseline(bpath, lint[mod]()) == 1
        entries[mod] = base.load_baseline(bpath)
    assert entries[core] == entries[jax_core]

    def counts():
        out = []
        for mod, base in analyzers:
            new, matched, stale = base.apply_baseline(lint[mod](),
                                                      entries[mod])
            out.append((len(new), len(matched), len(stale)))
        assert out[0] == out[1]
        return out[0]

    assert counts() == (0, 1, 0)
    path.write_text("# a new header comment\n" + source)
    assert counts() == (0, 1, 0)      # matched by source text, not line
    path.write_text(source.replace('float(m["loss"])', 'm["loss"]'))
    assert counts() == (0, 0, 1)      # the fixed line strands its entry


def test_write_baseline_subset_run_preserves_other_entries(tmp_path):
    path = tmp_path / "mod.py"
    path.write_text(HOT_LOOP.format(comment=""))
    findings = core.run_files([str(path)], repo_root=str(tmp_path))
    assert len(findings) == 1
    other = {"check": "LK501", "path": "other/module.py",
             "source": "self.count += 1",
             "justification": "hand-written: lock held by caller"}
    covered = {"check": findings[0].check, "path": findings[0].path,
               "source": findings[0].source,
               "justification": "hand-written: host-resident value"}
    gone = {"check": "HS101", "path": findings[0].path,
            "source": "float(old_line_since_fixed)",
            "justification": "stale"}
    merged = baseline_mod.merge_entries(
        [other, covered, gone], findings, linted_paths={findings[0].path})
    assert other in merged and covered in merged and gone not in merged
    assert len(merged) == 2


@pytest.mark.parametrize("text", ['{"version": 99}',
                                  '{"version": 1, "entries": '
                                  '[{"check": "HS101"}]}'])
def test_malformed_baseline_fails_loudly(tmp_path, text):
    bpath = tmp_path / "baseline.json"
    bpath.write_text(text)
    with pytest.raises(ValueError):
        baseline_mod.load_baseline(str(bpath))


def test_committed_baseline_loads_and_every_entry_is_justified():
    entries = baseline_mod.load_baseline(BASELINE)
    assert len(entries) <= 5
    for entry in entries:
        assert entry.get("justification"), (
            "every baseline entry needs a justification: " + repr(entry))


# -- the gate on the port's tree --------------------------------------------

def test_port_tree_lints_clean():
    """The port's package and chip_smoke.py lint clean against the
    committed baseline, with no stale entries, fast enough for tier-1
    (the bound is the JAX gate's)."""
    t0 = time.perf_counter()
    findings = core.run_paths(list(core.TORCHLINT_TARGETS),
                              repo_root=REPO_ROOT)
    elapsed = time.perf_counter() - t0
    entries = baseline_mod.load_baseline(BASELINE)
    new, matched, stale = baseline_mod.apply_baseline(findings, entries)
    assert not new, "unsuppressed torchlint findings:\n" + "\n".join(
        f.format() for f in new)
    assert not stale, ("stale baseline entries (the flagged lines no "
                       "longer exist): " + repr(stale))
    assert elapsed < 25.0, f"torchlint took {elapsed:.1f}s (budget 25s)"


def test_targets_are_the_ports_alone():
    assert core.TORCHLINT_TARGETS == ("bert_pytorch_tpu_torch",
                                      "chip_smoke.py")
    files = core.expand_paths(list(core.TORCHLINT_TARGETS), REPO_ROOT)
    rels = {os.path.relpath(f, REPO_ROOT).replace(os.sep, "/")
            for f in files}
    assert "chip_smoke.py" in rels
    assert all(r == "chip_smoke.py" or r.startswith("bert_pytorch_tpu_torch/")
               for r in rels)


POISON = ("import os, runpy, sys\n"
          "sys.modules['torch'] = None\n"
          "sys.modules['jax'] = None\n"
          "script = sys.argv[1]\n"
          "sys.path[0] = os.path.dirname(script)\n"
          "sys.argv = sys.argv[1:]\n"
          "runpy.run_path(script, run_name='__main__')\n")


def _run_poisoned(script, *args):
    """A wrapper run as a script, with torch and JAX unimportable."""
    return subprocess.run(
        [sys.executable, "-c", POISON, os.path.join(TOOLS, script), *args],
        cwd=REPO_ROOT, capture_output=True, text=True, timeout=120)


WINNERS = ('{"version": 1, "platform": "cpu", "interpret": true, '
           '"winners": {"infer:s128:bh32": {"block_q": 64, '
           '"block_k": 64, "bh_block": 1}}}\n')


def test_gate_runs_without_torch_or_jax(tmp_path):
    """``check_all`` (torchlint over the port, the schema and winners legs
    over named artifacts) with torch and JAX poisoned: the analyzer, the
    package ``__init__`` chain it rides in on and the by-path loaded
    schema and autotune modules are all stdlib-only, and the port lints
    clean (exit 0)."""
    jsonl = tmp_path / "run.jsonl"
    jsonl.write_text('{"tag": "t", "step": 1, "loss": 2.5}\n')
    winners = tmp_path / "winners.json"
    winners.write_text(WINNERS)
    proc = _run_poisoned("check_all.py", str(jsonl), str(winners))
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "torchlint: 0 findings" in proc.stdout
    assert f"{jsonl}: ok" in proc.stdout or "run.jsonl: ok" in proc.stdout
    assert "winners.json: ok" in proc.stdout


def test_module_mode_runs_from_the_repo_root():
    proc = subprocess.run(
        [sys.executable, "-m", "bert_pytorch_tpu_torch.tools.torchlint",
         "--list-checks"], cwd=REPO_ROOT, capture_output=True, text=True,
        timeout=60)
    assert proc.returncode == 0, proc.stderr
    for check_id in core.ALL_CHECK_IDS:
        assert check_id in proc.stdout


# One seeded violation per check family; one CLI run judges all six
# against the REAL program (ct801's kinds against the port's
# telemetry/schema.py, ct802's flags against the port's parsers).
SEEDED = ["hs101_pos.py", "sd601_pos.py", "sd602_pos.py", "dn701_pos.py",
          "ct801_pos.py", "ct802_pos.py"]


@pytest.fixture(scope="module")
def seeded_run():
    return _run_poisoned("torchlint.py", *[os.path.join(FIXTURES, f)
                                           for f in SEEDED],
                         "--no-baseline")


@pytest.mark.parametrize("fixture", SEEDED,
                         ids=[f.split("_")[0].upper() for f in SEEDED])
def test_cli_seeded_violation_exits_nonzero_naming_the_id(seeded_run,
                                                         fixture):
    check_id = fixture.split("_")[0].upper()
    assert seeded_run.returncode == 1, seeded_run.stdout + seeded_run.stderr
    lines = [ln for ln in seeded_run.stdout.splitlines()
             if ln.startswith(f"tests/fixtures/torchlint/{fixture}:")]
    assert any(f" {check_id} " in ln for ln in lines), seeded_run.stdout


def test_cli_list_checks(capsys):
    assert cli.main(["--list-checks"]) == 0
    out = capsys.readouterr().out
    for check_id in core.ALL_CHECK_IDS:
        assert check_id in out


# -- the schema and winners legs -------------------------------------------

def test_check_all_schema_leg(tmp_path, capsys):
    good = tmp_path / "good.jsonl"
    good.write_text('{"tag": "t", "step": 1, "loss": 2.5}\n')
    assert check_all.main(["--skip-torchlint", str(good)]) == 0
    bad = tmp_path / "bad.jsonl"
    bad.write_text("not json\n")
    assert check_all.main(["--skip-torchlint", str(bad)]) == 1
    assert check_all.main(["--skip-torchlint",
                           str(tmp_path / "missing.jsonl")]) == 1
    capsys.readouterr()


def test_check_all_winners_leg(tmp_path, capsys):
    good = tmp_path / "winners.json"
    good.write_text(WINNERS)
    assert check_all.main(["--skip-torchlint", str(good)]) == 0
    bad = tmp_path / "bad.json"
    bad.write_text('{"version": 1, "winners": {"infer:s128": {}}}\n')
    assert check_all.main(["--skip-torchlint", str(bad)]) == 1
    capsys.readouterr()


def test_check_all_names_no_artifact_by_default(capsys):
    assert check_all.main(["--skip-torchlint"]) == 0
    assert "no *.jsonl artifacts named" in capsys.readouterr().out


# -- the restated checks beyond the fixtures ----------------------------------

EXTRA_CASES = {
    # a blocking copy to the host and a bool() of a tensor in a step loop
    "hs101_copies": ("""
def train(tele, loader, step_fn):
    for batch in tele.timed(loader):
        m = step_fn(batch)
        a = m["loss"].cpu()
        b = m["loss"].to("cpu")
        c = m["loss"].to(device="cpu")
        d = bool(m["finite"])
    return a, b, c, d
""", ["HS101"] * 4),
    # a generator re-seeded from one constant in a loop: one stream
    "rn301_constant_reseed": ("""
import torch

def sample(shape, steps):
    out = []
    for _ in range(steps):
        gen = torch.Generator().manual_seed(0)
        out.append(torch.rand(shape, generator=gen))
    return out
""", ["RN301"]),
    # a pinned host buffer read before the non-blocking copy lands
    "dn701_pinned_copy": ("""
import torch

def fetch(loss):
    pinned = torch.empty(loss.shape, pin_memory=True)
    pinned.copy_(loss, non_blocking=True)
    return pinned.tolist()
""", ["DN701"]),
    # a callee of the timed loop storing its loss on a global
    "tl401_loop_callee": ("""
_last = None

def record(loss):
    global _last
    _last = loss

def train(tele, loader, step_fn):
    for batch in tele.timed(loader):
        record(step_fn(batch))
""", ["TL401"]),
    # the kernel library cache keyed by a list and by a number
    "rc_build_keys": ("""
from bert_pytorch_tpu_torch.ops.kernels import build

def load_all():
    return build.load(["layer_norm_fwd"]), build.load_host(7)
""", ["RC201", "RC203"]),
}


@pytest.mark.parametrize("case", sorted(EXTRA_CASES))
def test_restated_check(tmp_path, case):
    source, expected = EXTRA_CASES[case]
    path = tmp_path / "mod.py"
    path.write_text(source)
    context = [os.path.join(PACKAGE, "ops", "kernels", "build.py")] \
        if case == "rc_build_keys" else None
    findings = core.run_files([str(path)], repo_root=REPO_ROOT,
                              context_paths=context)
    assert sorted(f.check for f in findings) == expected, "\n".join(
        f.format() for f in findings)


# -- the mirrors, pinned by parsing -----------------------------------------

def _module_literals(path):
    """Module-level NAME = <literal> assignments of a file, evaluated over
    constants, tuples, lists, dicts and earlier such names."""
    with open(path, encoding="utf-8") as fh:
        tree = ast.parse(fh.read())
    env = {}

    def ev(node):
        if isinstance(node, ast.Constant):
            return node.value
        if isinstance(node, ast.Name):
            return env[node.id]
        if isinstance(node, (ast.Tuple, ast.List)):
            return tuple(ev(e) for e in node.elts)
        if isinstance(node, ast.Dict):
            return {ev(k): ev(v) for k, v in zip(node.keys, node.values)}
        raise KeyError(ast.dump(node))

    for stmt in tree.body:
        if isinstance(stmt, (ast.Assign, ast.AnnAssign)):
            target = stmt.targets[0] if isinstance(stmt, ast.Assign) \
                else stmt.target
            if isinstance(target, ast.Name) and stmt.value is not None:
                try:
                    env[target.id] = ev(stmt.value)
                except KeyError:
                    pass
    return env


def test_axes_registry_mirrors_mesh_py():
    """analysis/axes.py restates parallel/mesh.py's axis tables (the
    analysis package cannot import them); this pins the copies together
    by parsing mesh.py."""
    env = _module_literals(os.path.join(PACKAGE, "parallel", "mesh.py"))
    assert {k: env[k] for k in axes.AXIS_CONSTANTS} == axes.AXIS_CONSTANTS
    assert env["MESH_AXES"] == axes.MESH_AXES
    assert env["_STRATEGY_AXES"] == axes.STRATEGY_AXES
    assert env["GROUP_AXES"] == axes.GROUP_AXES
    for name, active in env["_STRATEGY_AXES"].items():
        assert axes.STRATEGY_RULES[name] == axes.derive_rules(active)


def test_split_table_names_model_rules():
    """Every logical axis of parallel/tensor_parallel.py's SPLITS has a
    rule under every strategy, and that rule is the model axis."""
    env = _module_literals(os.path.join(PACKAGE, "parallel",
                                        "tensor_parallel.py"))
    names = {entry[-1] for entry in env["SPLITS"]}
    assert names
    for name in names:
        assert axes.uncovered_strategies(name) == (), name
        assert axes.template_axis(name) == axes.AXIS_MODEL, name


def _defs_by_class(path):
    with open(path, encoding="utf-8") as fh:
        tree = ast.parse(fh.read())
    functions = {n.name for n in ast.walk(tree)
                 if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))}
    classes = {n.name: n for n in ast.walk(tree)
               if isinstance(n, ast.ClassDef)}
    return tree, functions, classes


@pytest.mark.parametrize("entry", concurrency.REGISTRY,
                         ids=[f"{e.module.rsplit('/', 1)[-1]}:{e.cls}."
                              f"{e.attr}" for e in concurrency.REGISTRY])
def test_registry_entry_names_what_exists(entry):
    """Each entry's module, class, attribute, locks and named functions
    exist in the port's tree, and the module is the port's."""
    assert entry.module.startswith("bert_pytorch_tpu_torch/")
    assert entry.kind in ("lock", "frozen", "confined")
    assert entry.why
    tree, functions, classes = _defs_by_class(
        os.path.join(REPO_ROOT, entry.module))
    scope = tree
    if entry.cls:
        assert entry.cls in classes, entry
        scope = classes[entry.cls]
        assert any(isinstance(n, ast.Attribute) and n.attr == entry.attr
                   and isinstance(n.value, ast.Name) and n.value.id == "self"
                   for n in ast.walk(scope)), entry
    else:
        assert any(isinstance(n, ast.Name) and n.id == entry.attr
                   for n in ast.walk(scope)), entry
    for fn in entry.allow + entry.forbidden_in:
        assert fn in functions, (entry, fn)
    names = {n.attr for n in ast.walk(tree) if isinstance(n, ast.Attribute)}
    names |= {n.id for n in ast.walk(tree) if isinstance(n, ast.Name)}
    for lock in entry.locks:
        assert lock in names, (entry, lock)


def _registered_modules():
    return {e.module for e in concurrency.REGISTRY}


@pytest.mark.parametrize("rel", [
    "utils/checkpoint.py", "data/loader.py", "data/dataset.py",
    "data/device_prefetch.py", "serve/service.py", "serve/router.py",
    "serve/supervisor.py", "serve/autoscaler.py", "telemetry/collector.py",
    "telemetry/sentinels.py", "telemetry/sampler.py",
    "telemetry/introspect.py", "ops/kernels/build.py",
    "telemetry/compile_events.py", "parallel/overlap.py",
    "ops/kernels/autotune.py"])
def test_registry_covers_the_ports_threads_and_locks(rel):
    """Every module that starts a thread, holds a module lock or is
    reached from autograd's thread has registered state."""
    assert f"bert_pytorch_tpu_torch/{rel}" in _registered_modules()


def test_registry_carries_every_jax_entry_over():
    from bert_pytorch_tpu.analysis.concurrency import REGISTRY as JAX

    ours = {(e.module, e.cls, e.attr, e.kind) for e in concurrency.REGISTRY}
    for e in JAX:
        module = e.module.replace("bert_pytorch_tpu/",
                                  "bert_pytorch_tpu_torch/").replace(
            "ops/pallas/", "ops/kernels/")
        assert (module, e.cls, e.attr, e.kind) in ours, e


def test_sync_gates_are_the_telemetry_facades():
    """HS101's cadence gates are names the port's telemetry facade
    defines: TrainTelemetry.last_step_synced, StepTimer.should_sync."""
    names = set()
    for rel in ("runner.py", "step_timer.py"):
        tree, functions, _ = _defs_by_class(
            os.path.join(PACKAGE, "telemetry", rel))
        names |= functions
        names |= {n.attr for n in ast.walk(tree)
                  if isinstance(n, ast.Attribute)}
    assert host_sync._SYNC_GATES <= names


@pytest.mark.parametrize("key", sorted(recompile.KEYED_BUILDERS))
def test_keyed_builders_exist(key):
    suffix, name = key
    _, functions, _ = _defs_by_class(os.path.join(PACKAGE, suffix))
    assert name in functions
    with open(os.path.join(PACKAGE, suffix), encoding="utf-8") as fh:
        tree = ast.parse(fh.read())
    fn = next(n for n in tree.body
              if isinstance(n, ast.FunctionDef) and n.name == name)
    params = [a.arg for a in fn.args.args]
    assert set(recompile.KEYED_BUILDERS[key]) <= set(params)
