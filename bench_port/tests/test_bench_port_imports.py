"""Nothing the benchmark runs imports JAX or the JAX package, compared by
whole top-level module names (``dodt_tpu_torch`` is not ``dodt_tpu``),
and the reference imports nothing of the program."""
import ast
import os

from conftest import BENCH

FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "dodt_tpu"}


def top_level_imports(path):
    tree = ast.parse(open(path).read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def sources(sub=""):
    for d, _, files in os.walk(os.path.join(BENCH, sub)):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_no_jax_anywhere_in_the_benchmark():
    found = {p: top_level_imports(p) & FORBIDDEN for p in sources()}
    assert not {p: n for p, n in found.items() if n}


def test_reference_imports_nothing_of_the_program():
    found = {p: top_level_imports(p) & (FORBIDDEN | {"dodt_tpu_torch",
                                                     "harness"})
             for p in sources("reference")}
    assert not {p: n for p, n in found.items() if n}
    assert len(found) >= 10


def test_whole_names_are_compared():
    assert "dodt_tpu_torch" not in FORBIDDEN
    assert "dodt_tpu_torch".split(".")[0] != "dodt_tpu"


def test_a_run_loads_no_jax(tiny_root):
    import subprocess
    import sys
    code = ("import sys; sys.path.insert(0, %r); import run; "
            "sys.path.insert(0, %r); from conftest import run_cell; "
            "run_cell(%r, 'cars_dt.stream'); "
            "print(run.forbidden_modules())" % (
                os.path.join(tiny_root, "bench_port"),
                os.path.dirname(os.path.abspath(__file__)), tiny_root))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=tiny_root)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
