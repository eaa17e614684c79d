"""Nothing of the benchmark imports JAX or the JAX package (top-level
module names compared whole: ``repro_torch`` is not ``repro``), and the
reference imports nothing of the port."""

import ast
from pathlib import Path

BENCH = Path(__file__).resolve().parent
BANNED = {"jax", "jaxlib", "flax", "repro"}


def imported(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) \
                in ("import_module", "__import__") and node.args \
                and isinstance(node.args[0], ast.Constant):
            yield str(node.args[0].value).split(".")[0]


def test_no_module_imports_jax_or_the_jax_package():
    files = sorted(BENCH.rglob("*.py"))
    assert len(files) > 10
    for f in files:
        assert not set(imported(f)) & BANNED, f


def test_the_reference_imports_nothing_of_the_port():
    for f in sorted((BENCH / "reference").rglob("*.py")):
        mods = set(imported(f))
        assert "repro_torch" not in mods and not mods & BANNED, f
        assert mods <= {"__future__", "math", "torch", "bench", "typing"}, \
            (f, mods)


def test_the_check_reads_the_reference_only():
    assert "repro_torch" not in set(imported(BENCH / "check.py"))
    assert "repro_torch" not in set(imported(BENCH / "work.py"))


def test_the_scan_sees_a_banned_import(tmp_path):
    f = tmp_path / "m.py"
    f.write_text("import repro.kernels\nfrom jax import numpy\n")
    assert set(imported(f)) == {"repro", "jax"}
    f.write_text("import repro_torch\n")
    assert not set(imported(f)) & BANNED
