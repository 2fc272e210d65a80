"""What a run loads: no module whose top-level name is `jax`, `jaxlib`,
`flax` or `sail_tpu` (compared whole), and a reference that imports
nothing of the program."""
import ast
import os
import subprocess
import sys

from perfbench.conftest import CELLS, ROOT
from perfbench import harness


def _python(code: str) -> str:
    env = dict(os.environ, PYTHONPATH=ROOT)
    return subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, check=True, env=env,
                          cwd=ROOT).stdout.strip().splitlines()[-1]


def test_forbidden_names_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "sail_tpu_torch_x", sys)
    monkeypatch.setitem(sys.modules, "jaxtyping", sys)
    assert "sail_tpu_torch_x" not in harness.forbidden_modules()
    assert "jaxtyping" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "sail_tpu.render", sys)
    assert harness.forbidden_modules() == ["sail_tpu.render"]


def test_a_run_of_every_cell_loads_no_forbidden_module():
    code = f"""
import sys, time, torch
from perfbench.conftest import tiny_cell
from perfbench import harness
for name in {CELLS!r}:
    harness.run_cell(tiny_cell(name), 5, 0.01, True, time.perf_counter(),
                     device="cpu", log=open("/dev/null", "w"))
print(harness.forbidden_modules(), "sail_tpu_torch" in sys.modules)
"""
    assert _python(code) == "[] True"


def test_reference_imports_nothing_of_the_program():
    code = """
import sys, torch
from perfbench.reference import compare
from perfbench import opcount
p, s = compare.packed({"scene": {"camera": [[0, 0, -2.5], [0, 0, 0]],
    "items": [{"class": "Sphere", "args": [[0, 0, 0], 0.5]}]}}, "cpu")
compare.mean_image(p, s, 4, 4, 1, 0, 2)
print(sorted(m for m in sys.modules if m.split(".")[0] in
             ("sail_tpu_torch", "sail_tpu", "jax")))
"""
    assert _python(code) == "[]"


def test_reference_sources_name_no_program_module():
    top = os.path.join(ROOT, "perfbench", "reference")
    for d, _, files in os.walk(top):
        for f in files:
            if not f.endswith(".py"):
                continue
            tree = ast.parse(open(os.path.join(d, f)).read())
            for node in ast.walk(tree):
                names = ([a.name for a in node.names]
                         if isinstance(node, ast.Import) else
                         [node.module or ""]
                         if isinstance(node, ast.ImportFrom) else [])
                for n in names:
                    assert n.split(".")[0] not in (
                        "sail_tpu_torch", "sail_tpu", "jax"), (f, n)
