"""What a run loads: no module whose top-level name is jax, jaxlib, flax
or the JAX package (compared whole: fountain_tpu_torch is not
fountain_tpu), and a reference that imports nothing of the program."""
import ast
import json
import subprocess
import sys

from harness import cells, runner


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "fountain_tpu_torch_like", sys)
    assert runner.forbidden_modules() == []
    for name in ("fountain_tpu", "fountain_tpu.geometry", "jax", "jaxlib",
                 "flax.linen"):
        monkeypatch.setitem(sys.modules, name, sys)
        assert name.split(".")[0] in runner.forbidden_modules()
        monkeypatch.delitem(sys.modules, name)


_RUN = """
import json, sys, time, torch
sys.path[:0] = [{bench!r}, {root!r}]
torch.set_num_threads(1)
from harness import runner
res = runner.run("logo_cube_flagship.step", 5, 0.0, True,
                 torch.device("cpu"), time.perf_counter(),
                 traffic_override={{"lanes": 4, "film": [4, 4]}})
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def test_a_run_loads_no_jax_and_no_jax_package():
    code = _RUN.format(bench=str(cells.BENCH_DIR), root=str(cells.ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=cells.ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    loaded = set(json.loads(out.stdout.splitlines()[-1]))
    assert "fountain_tpu_torch" in loaded and "refpt" in loaded
    assert not loaded & set(runner.FORBIDDEN)


def test_reference_imports_nothing_of_the_program():
    ref = cells.BENCH_DIR / "refpt"
    for path in ref.rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = [a.name for a in node.names] \
                if isinstance(node, ast.Import) else \
                [node.module or ""] if isinstance(node, ast.ImportFrom) \
                else []
            for n in names:
                assert n.split(".")[0] not in (
                    "fountain_tpu_torch", "fountain_tpu", "jax", "harness"), \
                    f"{path}: imports {n}"
    code = ("import sys, pkgutil, importlib; sys.path.insert(0, {!r}); "
            "import refpt; [importlib.import_module(m.name) for m in "
            "pkgutil.walk_packages(refpt.__path__, 'refpt.')]; "
            "print(sorted({{m.split('.')[0] for m in sys.modules}}))"
            ).format(str(cells.BENCH_DIR))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    loaded = set(eval(out.stdout.splitlines()[-1]))   # noqa: S307
    assert not loaded & {"fountain_tpu_torch", "fountain_tpu", "jax"}


def test_run_py_refuses_without_a_card():
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "rounded_cube_env.render_regen", "--seed", "1", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, timeout=300,
        cwd=cells.ROOT, env={"CUDA_VISIBLE_DEVICES": "",
                             "PATH": "/usr/bin:/bin"})
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA card" in out.stderr
