"""Build the port's native libraries from the sources in the checkout.

Every library is compiled at first use into ``build/m6anet_tpu_torch/`` at the
root of the checkout (``build/`` is in ``.gitignore``).  A library's file name
carries a hash of its source and compile command, so an edited source
rebuilds, and a finished build is reused by later processes.  Each compiler
writes to a private temporary name that is renamed into place, so processes
that build at the same time never load a half-written file.

CUDA sources (``ops/csrc/*.cu``) are compiled with ``nvcc`` for ``sm_90a``
into shared libraries with a plain C interface, loaded with ctypes; the
compiler's register and shared-memory report (``-Xptxas -v``) is kept beside
each library as ``<library>.log``.
"""
from __future__ import annotations

import glob
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from typing import Dict, List, Sequence, Tuple

_OPS_DIR = os.path.dirname(os.path.abspath(__file__))
_PKG_DIR = os.path.dirname(_OPS_DIR)
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "m6anet_tpu_torch")
CSRC_DIR = os.path.join(_OPS_DIR, "csrc")

# no --use_fast_math: expf and the f32 division must stay IEEE-exact enough
# for the 1e-6 per-read parity tolerance
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]
GXX_FLAGS = ["-O3", "-march=native", "-shared", "-fPIC", "-std=c++17", "-pthread"]


class BuildError(RuntimeError):
    pass


def _target(source: str, command: Sequence[str], out_dir: str) -> str:
    with open(source, "rb") as f:
        digest = hashlib.sha256(f.read() + "\0".join(command).encode()).hexdigest()[:16]
    stem = os.path.splitext(os.path.basename(source))[0]
    return os.path.join(out_dir, f"lib{stem}_{digest}.so")


def build_shared_libraries(
    jobs: Sequence[Tuple[str, Sequence[str]]], out_dir: str = BUILD_DIR
) -> List[str]:
    """Compile each ``(source, command)`` job into a shared library in
    ``out_dir``, all compilers running at once; return the library paths in
    job order.

    ``command`` is the compiler and its flags; the source and ``-o`` target
    are appended.  Libraries already built are reused, and jobs that give
    the same library (the same source bytes and command) share one
    compiler."""
    outs, running = [], []
    for source, command in jobs:
        out = _target(source, command, out_dir)
        started = out in outs
        outs.append(out)
        if started or os.path.exists(out):
            continue
        os.makedirs(out_dir, exist_ok=True)
        tmp = f"{out}.{os.getpid()}.{threading.get_ident()}.tmp"
        proc = subprocess.Popen(
            [*command, source, "-o", tmp],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        running.append((proc, source, out, tmp))
    failures = []
    for proc, source, out, tmp in running:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"{os.path.basename(source)}:\n{log}")
            continue
        with open(out + ".log", "w") as f:
            f.write(log)
        os.replace(tmp, out)
    if failures:
        raise BuildError("native build failed\n" + "\n".join(failures))
    return outs


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc`` as PyTorch resolves it, or
    ``nvcc`` on PATH."""
    from torch.utils.cpp_extension import CUDA_HOME

    candidates = [os.path.join(CUDA_HOME, "bin", "nvcc")] if CUDA_HOME else []
    candidates.append(shutil.which("nvcc") or "")
    for path in candidates:
        if path and os.path.exists(path):
            return path
    raise BuildError(
        "nvcc not found: the CUDA kernels of m6anet_tpu_torch need the CUDA "
        "toolkit (set CUDA_HOME or put nvcc on PATH)"
    )


_cuda_lock = threading.Lock()
_cuda_libs: Dict[str, str] = {}


def cuda_sources() -> List[str]:
    return sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu")))


def build_cuda(names: Sequence[str] = ()) -> Dict[str, Tuple[str, float]]:
    """Build the named ``csrc/<name>.cu`` kernels (all of them when ``names``
    is empty) with one nvcc each, started together.  Returns
    ``{name: (library path, seconds)}``; the seconds are those of this call."""
    sources = [
        s for s in cuda_sources()
        if not names or os.path.splitext(os.path.basename(s))[0] in names
    ]
    command = [nvcc_path(), *NVCC_FLAGS]
    start = time.perf_counter()
    with _cuda_lock:
        paths = build_shared_libraries([(s, command) for s in sources])
    seconds = time.perf_counter() - start
    result = {}
    for source, path in zip(sources, paths):
        name = os.path.splitext(os.path.basename(source))[0]
        _cuda_libs[name] = path
        result[name] = (path, seconds)
    return result


def cuda_library(name: str) -> str:
    """Path of the built ``csrc/<name>.cu`` library, building it if needed."""
    path = _cuda_libs.get(name)
    if path is None:
        path = build_cuda([name])[name][0]
    return path


def ptxas_usage(library: str, kernel: str) -> Dict[str, int]:
    """Registers, spill bytes and static shared memory that ptxas reported
    for the entry point whose (mangled) name contains ``kernel``, from the
    ``<library>.log`` kept beside a library built here."""
    with open(library + ".log") as f:
        log = f.read()
    usage: Dict[str, int] = {}
    current = None
    for line in log.splitlines():
        entry = re.search(r"Compiling entry function '([^']+)'", line)
        if entry:
            current = entry.group(1)
            continue
        if current is None or kernel not in current:
            continue
        for key, pattern in (
            ("registers", r"Used (\d+) registers"),
            ("smem_bytes", r"(\d+) bytes smem"),
            ("spill_store_bytes", r"(\d+) bytes spill stores"),
            ("spill_load_bytes", r"(\d+) bytes spill loads"),
        ):
            found = re.search(pattern, line)
            if found:
                usage[key] = int(found.group(1))
    if "registers" not in usage:
        raise BuildError(f"no ptxas report for an entry point named like {kernel!r} in {library}.log")
    return usage
