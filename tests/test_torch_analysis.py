"""The port's discipline checker (``repro_torch.analysis``), from both
sides, and against the reference's analyzer (``repro.analysis``).

Positive side: every rule (TD001-TD006, TX101-TX103) fires on a minimal
seeded violation with its rule id at the right ``file:line``; the walker
rules on seeded-bad programs passed as callables. Negative side: the
port's tree is clean (Layer 1 with ``torch``, ``jax`` and ``repro``
unimportable; the full check on the CPU). Parity: the markers, the
report and two AST rules agree with the reference on identical inputs.
"""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import pytest
import torch

from repro.analysis import astlint as ref_astlint
from repro.analysis import config as ref_config
from repro.analysis import findings as ref_findings
from repro_torch import analysis
from repro_torch.analysis import astlint, walk_audit
from repro_torch.analysis import check as check_cli
from repro_torch.analysis.config import AnalysisConfig, line_markers
from repro_torch.analysis.findings import Finding, from_json_dict, load_json
from repro_torch.analysis.programs import simulator_program
from repro_torch.core import engine

torch.set_num_threads(1)

REPO_ROOT = analysis.find_repo_root()
HERE = "tests/test_torch_analysis.py"


# --------------------------------------------------------------------------
# Fixture scaffolding: a throwaway tree with one file
# --------------------------------------------------------------------------

def _mini_repo(tmp_path, rel, source):
    """A minimal scannable tree: pyproject + one file at ``rel``."""
    (tmp_path / "pyproject.toml").write_text(
        "[tool.repro.analysis]\nexclude = []\n")
    target = tmp_path / rel
    target.parent.mkdir(parents=True, exist_ok=True)
    target.write_text(textwrap.dedent(source))
    return AnalysisConfig(root=str(tmp_path), exclude=())


def _rules_at(findings, rule):
    return [(f.path, f.line) for f in findings if f.rule == rule]


def _line_of(text):
    """The line of this file holding ``text`` (once, besides the call
    that asks for it)."""
    lines = [i for i, ln in enumerate(
        open(__file__).read().splitlines(), start=1)
        if text in ln and "_line_of(" not in ln]
    assert len(lines) == 1, (text, lines)
    return lines[0]


BAD = "src/repro_torch/core/bad.py"


# --------------------------------------------------------------------------
# TD001 registry-frozen
# --------------------------------------------------------------------------

def test_td001_unfrozen_registered_class(tmp_path):
    cfg = _mini_repo(tmp_path, BAD, """\
        import dataclasses

        def register(name, item):
            pass

        @dataclasses.dataclass
        class MutablePolicy:
            alpha: float = 1.0

        register("mutable", MutablePolicy())
        """)
    findings = astlint.RegistryFrozenCheck().run(cfg)
    assert _rules_at(findings, "TD001") == [(BAD, 7)]


def test_td001_unhashable_field(tmp_path):
    cfg = _mini_repo(tmp_path, BAD, """\
        import dataclasses
        from typing import List

        def register(name, item):
            pass

        @dataclasses.dataclass(frozen=True)
        class ListPolicy:
            weights: List[float] = None

        register("listy", ListPolicy())
        """)
    findings = astlint.RegistryFrozenCheck().run(cfg)
    assert _rules_at(findings, "TD001") == [(BAD, 9)]
    assert "unhashable" in findings[0].message


def test_td001_loop_registration_idiom_resolved(tmp_path):
    cfg = _mini_repo(tmp_path, BAD, """\
        import dataclasses

        def register(name, item):
            pass

        @dataclasses.dataclass(frozen=True)
        class Outer:
            inner: object = None

        @dataclasses.dataclass
        class Inner:
            x: float = 0.0

        for _n, _x in [("outer", Outer(Inner()))]:
            register(_n, _x)
        """)
    findings = astlint.RegistryFrozenCheck().run(cfg)
    assert _rules_at(findings, "TD001") == [(BAD, 11)]


# --------------------------------------------------------------------------
# TD002 rng-discipline
# --------------------------------------------------------------------------

@pytest.mark.parametrize("call", [
    "np.random.default_rng(0).uniform()",
    "np.random.uniform()",
    "np.random.SeedSequence(0)",
    "torch.manual_seed(0)",
    "torch.Generator()",
    "torch.rand(3)",
    "torch.randint(0, 4, (3,))",
    "torch.zeros(3).uniform_()",
])
def test_td002_stray_draw(tmp_path, call):
    cfg = _mini_repo(tmp_path, BAD, f"""\
        import numpy as np
        import torch

        def make_noise():
            return {call}
        """)
    findings = astlint.RngDisciplineCheck().run(cfg)
    assert _rules_at(findings, "TD002") == [(BAD, 5)]


def test_td002_generator_and_sanctioned_modules_ok(tmp_path):
    src = """\
        import numpy as np
        import torch

        def draw(gen):
            return torch.rand(3, generator=gen), np.random.default_rng(0)
        """
    cfg = _mini_repo(tmp_path, "src/repro_torch/scenarios/base.py", src)
    assert astlint.RngDisciplineCheck().run(cfg) == []
    cfg = _mini_repo(tmp_path, BAD, src.replace(
        ", np.random.default_rng(0)", ""))
    assert astlint.RngDisciplineCheck().run(cfg) == []


_TD002_SRC = """\
    import numpy as np

    def make_noise():
        rng = np.random.default_rng(0)
        return rng.uniform()
    """


def test_marker_suppresses(tmp_path):
    src = _TD002_SRC.replace(
        "rng = np.random.default_rng(0)",
        "rng = np.random.default_rng(0)  "
        "# repro: allow-rng[test fixture reason]")
    cfg = _mini_repo(tmp_path, BAD, src)
    assert astlint.RngDisciplineCheck().run(cfg) == []


def test_marker_on_the_line_above_suppresses(tmp_path):
    src = _TD002_SRC.replace(
        "rng = np.random.default_rng(0)",
        "# repro: allow-rng[test fixture reason]\n"
        "        rng = np.random.default_rng(0)")
    cfg = _mini_repo(tmp_path, BAD, src)
    assert astlint.RngDisciplineCheck().run(cfg) == []


def test_marker_without_reason_is_a_finding(tmp_path):
    src = _TD002_SRC.replace(
        "rng = np.random.default_rng(0)",
        "rng = np.random.default_rng(0)  # repro: allow-rng")
    cfg = _mini_repo(tmp_path, BAD, src)
    findings = astlint.RngDisciplineCheck().run(cfg)
    assert _rules_at(findings, "TD002") == [(BAD, 4)]
    assert "without a [reason]" in findings[0].message


# --------------------------------------------------------------------------
# TD003 host-effects
# --------------------------------------------------------------------------

_TD003_CASES = {
    "stage": ("""\
        import time

        def _stage_admit(st, trace):
            t0 = time.perf_counter()
            return st, t0
        """, [4]),
    "protocol-method": ("""\
        import numpy as np

        class Obs:
            def on_event(self, stage, aux, st):
                print("event", stage)
                return aux, np.random.rand()
        """, [5, 6]),
    "outside-stage": ("""\
        import time

        def benchmark_harness(st):
            return time.perf_counter()
        """, []),
    "jit-body-marker": ("""\
        import datetime

        # repro: jit-body
        def helper_called_from_stage(st):
            return datetime.datetime.now()
        """, [5]),
}


@pytest.mark.parametrize("case", sorted(_TD003_CASES))
def test_td003_host_effects(tmp_path, case):
    src, lines = _TD003_CASES[case]
    cfg = _mini_repo(tmp_path, BAD, src)
    findings = astlint.HostEffectsCheck().run(cfg)
    assert sorted(_rules_at(findings, "TD003")) == [(BAD, n) for n in lines]


# --------------------------------------------------------------------------
# TD004 host-sync
# --------------------------------------------------------------------------

_TD004_CASES = {
    "item": ("""\
        def _stage_map(st, trace):
            n = st.qlen.sum().item()
            return st, n
        """, [2]),
    "tolist-numpy-cpu": ("""\
        def notify(stage, aux, new):
            a = new.status.tolist()
            b = new.queue.cpu().numpy()
            return a, b
        """, [2, 3, 3]),
    "bool-int-float": ("""\
        def _stage_start(st):
            flag = bool(st.halted)
            k = int(st.qlen[0])
            return flag, k, float(st.now.max())
        """, [2, 3, 4]),
    "if-on-tensor": ("""\
        import torch

        def _stage_finalize(st, trace):
            load = torch.sum(st.queue)
            if load > 3:
                st = st._replace(now=st.now + 1)
            return st
        """, [5]),
    "loop-body": ("""\
        import torch

        def run(trace):
            st = init(trace)
            while True:
                t = next_event(st, trace)
                active = torch.isfinite(t)
                if not active.any():
                    break
                st = step(st)
        """, [8]),
    "static-branches-legal": ("""\
        def _stage_dispatch(st, n_sites=1, halted=None):
            if n_sites == 1:
                return st
            if halted is not None:
                return st
            if st.queue.shape[0] > 4 and st.queue.size(1) > 2:
                return st
            return st
        """, []),
}


@pytest.mark.parametrize("case", sorted(_TD004_CASES))
def test_td004_host_sync(tmp_path, case):
    src, lines = _TD004_CASES[case]
    cfg = _mini_repo(tmp_path, BAD, src)
    findings = astlint.HostSyncCheck().run(cfg)
    assert sorted(_rules_at(findings, "TD004")) == [(BAD, n) for n in lines]


# --------------------------------------------------------------------------
# TD005 float32
# --------------------------------------------------------------------------

@pytest.mark.parametrize("expr", [
    "x.double()", "x.to(torch.float64)", "x.to(torch.double)",
    "np.float64(x)", "np.asarray(x).astype(float)",
])
def test_td005_float64(tmp_path, expr):
    cfg = _mini_repo(tmp_path, BAD, f"""\
        import numpy as np
        import torch

        def key(x):
            return {expr}
        """)
    findings = astlint.Float32Check().run(cfg)
    assert _rules_at(findings, "TD005") == [(BAD, 5)]


def test_td005_scope_is_core(tmp_path):
    cfg = _mini_repo(tmp_path, "src/repro_torch/scenarios/ok.py", """\
        import numpy as np

        def draw(x):
            return np.asarray(x, np.float64)
        """)
    assert astlint.Float32Check().run(cfg) == []


# --------------------------------------------------------------------------
# TD006 no-reference-import
# --------------------------------------------------------------------------

@pytest.mark.parametrize("rel,stmt", [
    ("src/repro_torch/models/bad.py", "import jax"),
    ("src/repro_torch/models/bad.py", "import jax.numpy as jnp"),
    ("src/repro_torch/kernels/bad.py", "from jaxlib import xla_client"),
    ("src/repro_torch/core/bad.py", "from repro.core import engine"),
    ("src/repro_torch/core/bad.py", "import repro.analysis"),
    ("chip_smoke.py", "from repro import scenarios"),
    ("examples/torch_bad.py", "import repro"),
])
def test_td006_reference_import(tmp_path, rel, stmt):
    cfg = _mini_repo(tmp_path, rel, f"""\
        import torch
        {stmt}
        """)
    findings = astlint.NoReferenceImportCheck().run(cfg)
    assert _rules_at(findings, "TD006") == [(rel, 2)]


def test_td006_port_imports_and_other_examples_ok(tmp_path):
    cfg = _mini_repo(tmp_path, "src/repro_torch/core/ok.py", """\
        import repro_torch
        from repro_torch.core import engine
        from . import registry
        """)
    (tmp_path / "examples").mkdir()
    (tmp_path / "examples" / "quickstart.py").write_text("import jax\n")
    assert astlint.NoReferenceImportCheck().run(cfg) == []


# --------------------------------------------------------------------------
# Layer 2: the walker audit, on seeded-bad programs
# --------------------------------------------------------------------------

def _looped(body, iterations=4):
    """A seeded program: ``body(k, x)`` for ``iterations`` loop
    iterations, each counted as the engine counts them."""
    def program():
        def fn(x):
            for k in range(iterations):
                x = body(k, x)
                engine.COUNTS["loop_iterations"] += 1
            return x
        return fn, (torch.zeros(3),)
    return program


def _phase1_args():
    return (torch.zeros(1, 2), torch.ones(1, 3, 2), torch.full((1, 3), 5.0),
            torch.ones(2), torch.ones(1, 3, dtype=torch.bool),
            torch.ones(1, 2, dtype=torch.bool))


def test_tx101_site_count_leaks_into_program(monkeypatch):
    def with_sites(F):
        def body(k, x):
            for _ in range(F):
                x = x + 1
            return x
        return _looped(body)

    monkeypatch.setattr(walk_audit, "FLATNESS_GROUPS", (
        (("F=1", with_sites(1)), ("F=2", with_sites(2))),
        (("G=1", with_sites(1)), ("G=1 again", with_sites(1)))))
    findings = walk_audit.FlatnessCheck().run(analysis.load_config(REPO_ROOT, "cpu"))
    assert [(f.rule, f.path, f.line) for f in findings] == [
        ("TX101", "walk:F=2", 0)]
    assert "iteration 1's op multiset differs at aten.add" in \
        findings[0].message


def test_tx102_float64_in_the_loop(monkeypatch):
    def body(k, x):
        y = x.double() * 2  # the float64 fixture
        return x + y.float()

    monkeypatch.setattr(walk_audit, "DEFAULT_PROGRAMS",
                        (("f64-fixture", _looped(body)),))
    findings = walk_audit.DtypeCheck().run(analysis.load_config(REPO_ROOT, "cpu"))
    line = _line_of("y = x.double() * 2  # the float64 fixture")
    assert [(f.rule, f.path, f.line) for f in findings] == [
        ("TX102", HERE, line)]
    assert "_to_copy x3, mul x3" in findings[0].message


def test_tx102_marker_suppresses_and_wants_a_reason(monkeypatch):
    def marked(k, x):
        # repro: allow-f64[a seeded fixture]
        return x + x.double().float()

    def unexplained(k, x):
        return x + x.double().float()  # repro: allow-f64

    cfg = analysis.load_config(REPO_ROOT, "cpu")
    monkeypatch.setattr(walk_audit, "DEFAULT_PROGRAMS",
                        (("marked", _looped(marked)),))
    assert walk_audit.DtypeCheck().run(cfg) == []
    monkeypatch.setattr(walk_audit, "DEFAULT_PROGRAMS",
                        (("unexplained", _looped(unexplained)),))
    findings = walk_audit.DtypeCheck().run(cfg)
    line = _line_of("return x + x.double().float()  # repro: allow-f64")
    assert [(f.rule, f.path, f.line) for f in findings] == [
        ("TX102", HERE, line)]
    assert "without a [reason]" in findings[0].message


def test_tx102_set_up_and_tail_not_flagged(monkeypatch):
    def program():
        def fn(x):
            x = x.double().float()          # set-up: bucket 0
            for _ in range(3):
                x = x + 1
                engine.COUNTS["loop_iterations"] += 1
            return x.double()               # the tail
        return fn, (torch.zeros(3),)

    monkeypatch.setattr(walk_audit, "DEFAULT_PROGRAMS",
                        (("ends", program),))
    assert walk_audit.DtypeCheck().run(
        analysis.load_config(REPO_ROOT, "cpu")) == []


def test_tx103_host_read_in_the_loop(monkeypatch):
    def body(k, x):
        if x.sum() > 100:  # the host-read fixture
            x = x - 1
        return x + 1

    monkeypatch.setattr(walk_audit, "DEFAULT_PROGRAMS",
                        (("sync-fixture", _looped(body)),))
    findings = walk_audit.HostSyncAuditCheck().run(
        analysis.load_config(REPO_ROOT, "cpu"))
    line = _line_of("if x.sum() > 100:  # the host-read fixture")
    assert [(f.rule, f.path, f.line) for f in findings] == [
        ("TX103", HERE, line)]
    assert "_local_scalar_dense x3" in findings[0].message


def test_tx103_kernel_scopes_differ_between_iterations(monkeypatch):
    from repro_torch.kernels.phase1_map.ops import phase1_map

    def body(k, x):
        if k % 2:
            phase1_map(*_phase1_args())
        return x + 1

    monkeypatch.setattr(walk_audit, "DEFAULT_PROGRAMS",
                        (("kernel-fixture", _looped(body, 5)),))
    findings = walk_audit.HostSyncAuditCheck().run(
        analysis.load_config(REPO_ROOT, "cpu"))
    assert [(f.rule, f.path, f.line) for f in findings] == [
        ("TX103", "walk:kernel-fixture", 0)]
    assert "iteration 2's kernel scopes {} differ" in findings[0].message


def test_layer2_without_torch_is_one_finding(monkeypatch):
    monkeypatch.setitem(sys.modules, "torch", None)
    findings = walk_audit.DtypeCheck().run(analysis.load_config(REPO_ROOT, "cpu"))
    assert [(f.rule, f.path) for f in findings] == [
        ("TX102", "walk:walk-dtype")]


# --------------------------------------------------------------------------
# Layer 2 on the port's programs
# --------------------------------------------------------------------------

def test_walks_read_back_only_at_the_marked_lines():
    """Every default program: 64 iterations, the host reads only the
    periodic check (three times) and the set-up's admission bound, and
    the fused program's kernels once per iteration."""
    src = open(os.path.join(REPO_ROOT, "src/repro_torch/core/engine.py")
               ).read().splitlines()
    check = 1 + next(i for i, ln in enumerate(src)
                     if "not bool(active.any())" in ln)
    bound = 1 + next(i for i, ln in enumerate(src)
                     if "torch.bincount(group.flatten()" in ln)
    eng = "src/repro_torch/core/engine.py"
    for name, params in walk_audit.DEFAULT_PROGRAMS:
        d = walk_audit.describe(walk_audit.walk_program(params, "cpu"))
        assert d["iterations"] == 64, name
        assert d["host_reads"] == {f"{eng}:{bound}": 1,
                                   f"{eng}:{check}": 3}, name
        assert d["syncs"] == {} and d["launches"] == {}, name
        kernels = ({"map_decide": 1, "evict_stats": 1, "balance_scan": 1}
                   if params.get("fused") else {})
        assert d["kernels_per_iteration"] == kernels, name


def test_full_iterations_do_not_depend_on_the_batch():
    """The flat path's loop at B = 1 and B = 4: the same op multiset in
    every full iteration."""
    flat = dict(fleet="paper", heuristic="FELARE", fused=True)
    walks = [(f"B={b}", walk_audit.walk_program(dict(flat, reps=b), "cpu"))
             for b in (1, 4)]
    assert all(w.iterations > 2 for _, w in walks)
    assert walk_audit.compare_full_iterations(
        walk_audit.FlatnessCheck(), walks) == []


def test_flatness_pairs_cover_the_reference_groups():
    groups = walk_audit.FLATNESS_GROUPS
    assert [[name for name, _ in g] for g in groups] == [
        ["paper_x2/FELARE", "paper_x32/FELARE"],
        ["tiered_x4/FELARE+net", "tiered_x16/FELARE+net"],
        ["paper_x2/FELARE+fused", "paper_x32/FELARE+fused"]]


# --------------------------------------------------------------------------
# The tree is clean; the CLI
# --------------------------------------------------------------------------

_BLOCKED = ("import sys\n"
            "for name in ('torch', 'jax', 'jaxlib', 'repro'):\n"
            "    sys.modules[name] = None\n")


def _run_blocked(code):
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO_ROOT, "src"))
    return subprocess.run([sys.executable, "-c", _BLOCKED + code],
                          capture_output=True, text=True, timeout=120,
                          cwd=REPO_ROOT, env=env)


def test_layer1_clean_without_torch_jax_or_reference():
    out = _run_blocked(
        "from repro_torch.analysis import check\n"
        "rc = check.main(['--layer', '1'])\n"
        "assert not any(m == 'torch' or m.startswith('torch.')\n"
        "               for m in sys.modules if sys.modules[m] is not None)\n"
        "sys.exit(rc)\n")
    assert out.returncode == 0, out.stdout + out.stderr
    assert "6 check(s) -> clean" in out.stdout


def test_package_imports_without_torch_and_resolves_lazily():
    out = _run_blocked(
        "import repro_torch\n"
        "try:\n"
        "    repro_torch.resolve_device\n"
        "except ImportError:\n"
        "    print('lazy')\n")
    assert out.returncode == 0 and out.stdout.strip() == "lazy", out.stderr
    from repro_torch import resolve_device
    from repro_torch.core.device import resolve_device as direct
    assert resolve_device is direct
    assert resolve_device("cpu") == torch.device("cpu")
    import repro_torch
    with pytest.raises(AttributeError):
        repro_torch.no_such_name


def test_full_check_clean_on_the_tree(capsys):
    assert check_cli.main(["--root", REPO_ROOT, "--device", "cpu"]) == 0
    assert "9 check(s) -> clean" in capsys.readouterr().out


def test_layer2_wants_the_card_unless_asked_for_the_cpu(monkeypatch,
                                                        capsys):
    """Layer 2 runs on the CUDA device by default, as every entry point
    of the port: without a card its checks crash and fail the gate, and
    the walk functions raise; Layer 1 needs no device."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert check_cli.main(["--root", REPO_ROOT, "--layer", "2"]) == 1
    captured = capsys.readouterr()
    assert "3 crashed check(s)" in captured.out
    assert captured.err.count("RuntimeError: no CUDA device") == 3
    assert check_cli.main(["--root", REPO_ROOT, "--layer", "1"]) == 0
    params = walk_audit.DEFAULT_PROGRAMS[0][1]
    for call in (lambda: walk_audit.walk_program(params),
                 lambda: walk_audit.sync_sites(params),
                 lambda: walk_audit.summary(),
                 lambda: simulator_program()):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert walk_audit.sync_sites(params, "cpu") == ()


def test_cli_list_checks(capsys):
    assert check_cli.main(["--list-checks"]) == 0
    out = capsys.readouterr().out
    for rule, layer in (("TD001", 1), ("TD002", 1), ("TD003", 1),
                        ("TD004", 1), ("TD005", 1), ("TD006", 1),
                        ("TX101", 2), ("TX102", 2), ("TX103", 2)):
        assert f"{rule}  L{layer}" in out, rule


def test_cli_json_round_trip(tmp_path, capsys):
    """Findings survive the --json report, and a dirty tree exits 1 with
    rule ids in the report."""
    bad = tmp_path / "src" / "repro_torch" / "core"
    bad.mkdir(parents=True)
    (tmp_path / "pyproject.toml").write_text("")
    (bad / "bad.py").write_text(textwrap.dedent("""\
        import numpy as np

        def _stage_admit(st):
            noise = np.random.default_rng(0)
            print("admitting")
            return st.qlen.item(), noise
        """))
    out_json = tmp_path / "analysis.json"
    rc = check_cli.main([
        "--layer", "1", "--root", str(tmp_path), "--json", str(out_json),
        "--checks", "rng-discipline,host-effects,host-sync"])
    assert rc == 1
    report = json.loads(out_json.read_text())
    assert report["ok"] is False
    assert report["findings_by_rule"] == {"TD002": 1, "TD003": 2,
                                          "TD004": 1}
    loaded = load_json(out_json)
    assert loaded == sorted(from_json_dict(d) for d in report["findings"])
    assert all(isinstance(f, Finding) and f.line for f in loaded)
    assert "4 finding(s)" in capsys.readouterr().out


def test_cli_crashed_check_fails_gate(tmp_path):
    @dataclasses.dataclass(frozen=True)
    class Exploding:
        name: str = "exploding"
        rule: str = "TD999"
        layer: int = 1

        def run(self, cfg):
            raise RuntimeError("boom")

    analysis.register("exploding", Exploding())
    try:
        out_json = tmp_path / "r.json"
        rc = check_cli.main(["--checks", "exploding", "--root", REPO_ROOT,
                             "--json", str(out_json)])
        assert rc == 1
        report = json.loads(out_json.read_text())
        assert report["ok"] is False and report["errors"] == [
            "exploding: RuntimeError: boom"]
    finally:
        analysis.CHECKS.unregister("exploding")


# --------------------------------------------------------------------------
# Parity with the reference's analyzer on identical inputs
# --------------------------------------------------------------------------

_MARKER_SOURCE = """\
x = 1  # repro: allow-prng[seeded on purpose]
y = 2  # repro: allow-host
# repro: jit-body
def f():  # repro: allow-a[one]  # repro: allow-b[ two ]
    pass  #repro:allow-c[]
z = "repro: nothing here"
"""


def test_line_markers_match_the_reference():
    assert line_markers(_MARKER_SOURCE) == ref_config.line_markers(
        _MARKER_SOURCE)
    allows, jit = line_markers(_MARKER_SOURCE)
    assert allows[4] == {"a": "one", "b": "two"} and jit == [3]


def test_report_and_format_match_the_reference():
    rows = [("src/b.py", 3, "TD004", "host-sync", "m1"),
            ("src/a.py", 9, "TD002", "rng-discipline", "m2"),
            ("walk:p", 0, "TX101", "walk-flatness", "m3"),
            ("src/a.py", 2, "TD002", "rng-discipline", "m4")]
    port = [Finding(*r) for r in rows]
    ref = [ref_findings.Finding(*r) for r in rows]
    assert analysis.format_findings(port) == ref_findings.format_findings(
        ref)
    for errors in ((), ("x: RuntimeError: boom",)):
        assert analysis.report_dict(
            port, checks=["a", "b"], root="/r", errors=errors) == \
            ref_findings.report_dict(ref, checks=["a", "b"], root="/r",
                                     errors=errors)
    assert analysis.report_dict([], checks=[])["ok"] is True


_PARITY_FIXTURES = {
    "unfrozen": """\
        import dataclasses

        def register(name, item):
            pass

        @dataclasses.dataclass
        class A:
            x: float = 1.0

        @dataclasses.dataclass(frozen=True)
        class B:
            w: dict = None
            ok: int = 0

        X = B()
        register("a", A())
        for _n, _x in [("b", X), ("c", A())]:
            register(_n, _x)
        """,
    "host": """\
        import time
        import datetime
        import numpy as np
        import random

        def _stage_admit(st, trace):
            t0 = time.perf_counter()
            print("admit")  # repro: allow-host[parity]
            return st, t0

        class Pol:
            def select(self, view):
                return np.random.rand(), random.random()

            def helper(self):
                return time.time()

        # repro: jit-body
        def marked(st):
            return datetime.datetime.now(), open("f")

        def notify(stage):
            input()  # repro: allow-host
        """,
}


@pytest.mark.parametrize("fixture", sorted(_PARITY_FIXTURES))
def test_td001_td003_match_jd001_jd003(tmp_path, fixture):
    """The same sources through the reference's JD001 and JD003 and the
    port's TD001 and TD003, ``dirs`` at the fixture: the same (line,
    rule) pairs."""
    rel = "pkg/mod.py"
    _mini_repo(tmp_path, rel, _PARITY_FIXTURES[fixture])
    port_cfg = AnalysisConfig(root=str(tmp_path))
    ref_cfg = ref_config.AnalysisConfig(root=str(tmp_path))
    pairs = ((ref_astlint.RegistryFrozenCheck(dirs=("pkg",)),
              astlint.RegistryFrozenCheck(dirs=("pkg",))),
             (ref_astlint.HostEffectsCheck(dirs=("pkg",)),
              astlint.HostEffectsCheck(dirs=("pkg",))))
    seen = 0
    for ref_check, port_check in pairs:
        ref = sorted((f.line, f.rule[2:]) for f in ref_check.run(ref_cfg))
        port = sorted((f.line, f.rule[2:]) for f in port_check.run(port_cfg))
        assert port == ref, (ref_check.rule, port, ref)
        seen += len(port)
    assert seen


def test_catalog_names_every_rule_and_its_counterpart():
    doc = analysis.__doc__
    for name in analysis.names():
        check = analysis.get(name)
        assert f"{check.rule} {name}" in doc, name
    for ref_rule in ("JD001", "JD002", "JD003", "JD004", "JD005", "JX101",
                     "JX102", "JX103", "JX104"):
        assert ref_rule in doc
    doc = " ".join(doc.split())
    assert "PyTorch has no weak types" in doc
    assert "an eager port traces nothing" in doc
