"""Nothing the benchmark runs imports JAX or the JAX package (whole
top-level names: the port's begins with the JAX package's), the reference
imports nothing of the port, and a run without a card prints no result."""
import ast
import glob
import os
import shutil
import subprocess
import sys

from portbench import harness

FORBIDDEN = {"jax", "jaxlib", "flax", "m6anet_tpu"}


def imported(path):
    with open(path) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def sources(*parts):
    return glob.glob(os.path.join(harness.HERE, *parts, "**", "*.py"), recursive=True)


def test_no_module_imports_jax_or_the_jax_package():
    for path in sources():
        assert not set(imported(path)) & FORBIDDEN, path


def test_the_reference_imports_nothing_of_the_port():
    for path in sources("reference"):
        assert harness.PROGRAM not in set(imported(path)), path
        assert set(imported(path)) <= {"__future__", "typing", "numpy", "torch"}, path


def test_a_cpu_run_leaves_no_jax_module_loaded():
    harness.run("m6anet_signal.step.exact", 3, 0.05, False, "cpu", mix_override={"batches": 1, "reads": 16384,
                                                                                    "sites": 128})
    assert harness.forbidden_modules() == []


def test_without_a_card_the_run_fails_and_prints_no_result():
    env = {k: v for k, v in os.environ.items() if k != "CUDA_VISIBLE_DEVICES"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    out = subprocess.run([sys.executable, "-m", "portbench", "--workload", "m6anet.step.exact", "--seed", "5",
                          "--seconds", "1", "--trace", "0"], cwd=harness.ROOT, env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_without_the_port_the_run_fails(tmp_path):
    shutil.copy(os.path.join(harness.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(harness.HERE, tmp_path / "portbench", ignore=shutil.ignore_patterns("__pycache__"))
    code = ("import sys; from portbench import harness; "
            "print(harness.run('m6anet.step.exact', 1, 0.1, False, 'cpu'))")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
