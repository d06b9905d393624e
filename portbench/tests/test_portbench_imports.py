"""Nothing under ``portbench/`` imports JAX or the JAX package ``repro``
(top-level names compared whole: ``repro_torch`` is not ``repro``), and
the plain reference imports nothing of the port either."""
import ast
import pathlib

import portbench_common  # noqa: F401
from portbench import harness

PB = pathlib.Path(__file__).resolve().parents[1]
BANNED = {"jax", "jaxlib", "flax", "repro"}


def top_level_imports(path: pathlib.Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.partition(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.partition(".")[0])
    return names


def test_no_jax_anywhere():
    files = sorted(PB.rglob("*.py"))
    assert len(files) > 20
    for f in files:
        assert not top_level_imports(f) & BANNED, f


def test_reference_is_plain():
    for f in sorted((PB / "reference").rglob("*.py")):
        found = top_level_imports(f)
        assert found <= {"__future__", "math", "numpy"}, (f, found)


def test_whole_word_comparison(monkeypatch):
    import sys
    import types

    monkeypatch.setitem(sys.modules, "repro_torchlike", types.ModuleType("x"))
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "repro.core", types.ModuleType("y"))
    assert harness.forbidden_modules() == ["repro"]


def test_the_ast_check_sees_a_banned_import(tmp_path):
    f = tmp_path / "bad.py"
    f.write_text("import jax.numpy as jnp\nfrom repro.core import api\n"
                 "import repro_torch\n")
    assert top_level_imports(f) & BANNED == {"jax", "repro"}
