"""The port stands alone: m6anet_tpu_torch and chip_smoke.py import neither
JAX nor the JAX package (m6anet_tpu), whose name the port's starts with, nor
scikit-learn, which the card's machine lacks (the JAX package's training
metrics use it).  tests/test_torch_train.py runs the train CLI with all
three hidden, and this file the dataprep CLI."""
import os
import re
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "m6anet_tpu_torch")

_PROBE = r"""
import sys
import numpy as np
import torch
import m6anet_tpu_torch
from m6anet_tpu_torch.cli import main  # noqa: F401
from m6anet_tpu_torch.inference import engine
from m6anet_tpu_torch.models import load_model
from m6anet_tpu_torch.constants import DEFAULT_MODEL_CONFIG, DEFAULT_MODEL_WEIGHTS
from m6anet_tpu_torch.ops import fused_infer_kernel as fik
from m6anet_tpu_torch.scripts import train  # noqa: F401
from m6anet_tpu_torch.train import builder, checkpoint, loop, losses, metrics  # noqa: F401
from m6anet_tpu_torch.data import columnar  # noqa: F401
from m6anet_tpu_torch.data.dataset import ConcatSiteDataset  # noqa: F401
from m6anet_tpu_torch.parallel import group, mesh  # noqa: F401
from m6anet_tpu_torch import dataprep, deprecated  # noqa: F401
from m6anet_tpu_torch.dataprep import combine, indexer, runner, windowing  # noqa: F401
from m6anet_tpu_torch.deprecated import compute_norm_factors, inference, train as train_shim  # noqa: F401
from m6anet_tpu_torch.deprecated import dataprep as dataprep_shim  # noqa: F401
from m6anet_tpu_torch.scripts import compute_norm_factors, convert, dataprep as dataprep_script  # noqa: F401
from m6anet_tpu_torch.utils import profiling  # noqa: F401
import tomllib

with open(DEFAULT_MODEL_CONFIG, "rb") as f:
    model = load_model(tomllib.load(f), DEFAULT_MODEL_WEIGHTS)
rng = np.random.default_rng(0)
X = torch.from_numpy(rng.normal(size=(256, 9)).astype(np.float32))
K = torch.from_numpy(rng.integers(0, 66, size=(256, 3)).astype(np.int8))
offsets = torch.tensor([0, 100, 0, 0], dtype=torch.int32)
counts = torch.tensor([100, 120, 0, 0], dtype=torch.int32)
p, site_p, mod_ratio = fik.fused_inference_t(
    fik.prepare_fused_params_t(model), X, K, None, offsets, counts, 0.5
)
assert p.shape == (256,) and site_p.shape == (4,) and bool(torch.isfinite(site_p).all())
bad = sorted(
    name for name in sys.modules
    if name == "jax" or name.startswith(("jax.", "jaxlib"))
    or name == "m6anet_tpu" or name.startswith("m6anet_tpu.")
    or name == "sklearn" or name.startswith("sklearn.")
)
print("LOADED:" + ",".join(bad))
"""


def test_import_and_cpu_forward_load_no_jax():
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, "-c", _PROBE], cwd=REPO, env=env, capture_output=True, text=True, timeout=120
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "LOADED:\n" in proc.stdout, proc.stdout


def test_dataprep_cli_runs_with_jax_the_jax_package_and_sklearn_hidden(tmp_path):
    code = (
        "import sys; sys.modules['sklearn'] = None; sys.modules['jax'] = None; sys.modules['m6anet_tpu'] = None; "
        "from m6anet_tpu_torch.cli import main; main(sys.argv[1:])"
    )
    argv = ["dataprep", "--eventalign", os.path.join(REPO, "tests", "data", "eventalign.txt"),
            "--out_dir", str(tmp_path), "--min_segment_count", "1", "--format", "both", "--n_processes", "2"]
    proc = subprocess.run([sys.executable, "-c", code, *argv], cwd=REPO, capture_output=True, text=True,
                          timeout=120, env=dict(os.environ, PYTHONPATH=REPO))
    assert proc.returncode == 0, proc.stderr[-2000:]
    with open(tmp_path / "data.info") as f:
        assert len(f.readlines()) == 249  # the header and the demo's 248 sites
    assert os.path.exists(tmp_path / "columnar" / "meta.json")
    with open(tmp_path / "data.log") as f:
        assert f.readlines()[-1] == "--- SUCCESSFULLY FINISHED ---\n"


def _sources():
    for root, _, files in os.walk(PORT):
        for name in files:
            if name.endswith(".py"):
                yield os.path.join(root, name)
    yield os.path.join(REPO, "chip_smoke.py")


def test_sources_never_name_jax_or_the_jax_package():
    pattern = re.compile(r"\bimport jax\b|\bfrom jax\b|\bm6anet_tpu(?!_torch)|\b(import|from) sklearn\b")
    offenders = []
    for path in _sources():
        with open(path, encoding="utf-8") as f:
            for lineno, line in enumerate(f, 1):
                if pattern.search(line):
                    offenders.append(f"{os.path.relpath(path, REPO)}:{lineno}: {line.strip()}")
    assert not offenders, "\n".join(offenders)
