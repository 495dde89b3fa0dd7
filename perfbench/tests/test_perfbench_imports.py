"""No module of the benchmark imports JAX, jaxlib, flax or the JAX package
``repro``: top-level names compared whole, so ``repro_torch`` passes."""
import ast

from conftest import BENCH

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_no_module_of_the_benchmark_imports_jax_or_the_jax_package():
    files = sorted(BENCH.rglob("*.py"))
    assert len(files) > 10
    bad = [(p.relative_to(BENCH).as_posix(), name) for p in files
           for name in _imports(p) if name.split(".")[0] in FORBIDDEN]
    assert bad == []


def test_the_guard_compares_whole_top_level_names():
    import run
    assert "repro_torch" not in run.FORBIDDEN
    assert {"jax", "jaxlib", "flax", "repro"} == set(run.FORBIDDEN)
    assert run.forbidden_modules() == []
