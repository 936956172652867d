"""Build the port's native libraries from the sources in the checkout.

Every library is compiled at first use into ``build/m6anet_tpu_torch/`` at the
root of the checkout (``build/`` is in ``.gitignore``).  A library's file name
carries a hash of its source and compile command, so an edited source
rebuilds, and a finished build is reused by later processes.  Each compiler
writes to a private temporary name that is renamed into place, so processes
that build at the same time never load a half-written file.

CUDA sources (``ops/csrc/*.cu``, which may include the headers
``ops/csrc/*.cuh``: they hash into every CUDA library's name) are compiled
with ``nvcc`` for ``sm_90a`` into shared libraries with a plain C
interface, loaded with ctypes; the compiler's register and shared-memory
report (``-Xptxas -v``) is kept beside each library as ``<library>.log``.  A source may be built more than once
with ``-D`` defines (the model's widths, the MC kernel's draws per
iteration): each set of defines is part of the command, so it hashes into a
library of its own, built at first use.  Without defines a source builds at
the production model's widths, its macros' defaults.
"""
from __future__ import annotations

import ast
import glob
import hashlib
import operator
import os
import re
import shutil
import subprocess
import threading
import time
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

_OPS_DIR = os.path.dirname(os.path.abspath(__file__))
_PKG_DIR = os.path.dirname(_OPS_DIR)
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "m6anet_tpu_torch")
CSRC_DIR = os.path.join(_OPS_DIR, "csrc")

# no --use_fast_math: expf and the f32 division must stay IEEE-exact enough
# for the 1e-6 per-read parity tolerance; -I csrc/ for the headers the
# kernels share (wide_tile.cuh), also from a copy of a source elsewhere
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-I", CSRC_DIR,
]
GXX_FLAGS = ["-O3", "-march=native", "-shared", "-fPIC", "-std=c++17", "-pthread"]


class BuildError(RuntimeError):
    pass


def _target(source: str, command: Sequence[str], out_dir: str) -> str:
    with open(source, "rb") as f:
        text = f.read()
    if source.endswith(".cu"):  # and the headers a kernel may include from csrc/
        for header in sorted(glob.glob(os.path.join(CSRC_DIR, "*.cuh"))):
            with open(header, "rb") as f:
                text += f.read()
    digest = hashlib.sha256(text + "\0".join(command).encode()).hexdigest()[:16]
    stem = os.path.splitext(os.path.basename(source))[0]
    return os.path.join(out_dir, f"lib{stem}_{digest}.so")


def build_shared_libraries(
    jobs: Sequence[Tuple[str, Sequence[str]]], out_dir: str = BUILD_DIR, failed: Optional[Dict[str, str]] = None
) -> List[str]:
    """Compile each ``(source, command)`` job into a shared library in
    ``out_dir``, all compilers running at once; return the library paths in
    job order.

    ``command`` is the compiler and its flags; the source and ``-o`` target
    are appended.  Libraries already built are reused, and jobs that give
    the same library (the same source bytes and command) share one
    compiler.  A job that does not build raises ``BuildError``, or, given a
    ``failed`` dict, is entered there (its library path: the compiler's
    log) and the others are returned."""
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
            if failed is not None:
                failed[out] = log
            else:
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


def cuda_sources() -> List[str]:
    return sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu")))


def _defines_key(defines: Optional[Mapping[str, int]]) -> Tuple[Tuple[str, int], ...]:
    return tuple(sorted((defines or {}).items()))


def build_cuda(
    names: Sequence[str] = (), variants: Sequence[Tuple[str, Mapping[str, int]]] = ()
) -> Dict:
    """Build the named ``csrc/<name>.cu`` kernels at their defaults (all of
    them when neither ``names`` nor ``variants`` is given) and each
    ``(name, defines)`` of ``variants``, with one nvcc each, started
    together.  Returns ``{name: (library path, seconds)}`` for the defaults
    and ``{(name, sorted defines): (library path, seconds)}`` for the
    variants; the seconds are those of this call."""
    by_name = {os.path.splitext(os.path.basename(s))[0]: s for s in cuda_sources()}
    if not names and not variants:
        names = list(by_name)
    jobs = [(name, {}) for name in names] + [(name, dict(d)) for name, d in variants]
    for name, _ in jobs:
        if name not in by_name:
            raise BuildError(f"no CUDA source csrc/{name}.cu")
    base = [nvcc_path(), *NVCC_FLAGS]
    commands = [base + [f"-D{k}={v}" for k, v in _defines_key(d)] for _, d in jobs]
    start = time.perf_counter()
    with _cuda_lock:
        paths = build_shared_libraries([(by_name[name], cmd) for (name, _), cmd in zip(jobs, commands)])
    seconds = time.perf_counter() - start
    result = {}
    for i, ((name, defines), path) in enumerate(zip(jobs, paths)):
        result[name if i < len(names) else (name, _defines_key(defines))] = (path, seconds)
    return result


def cuda_library(name: str, defines: Optional[Mapping[str, int]] = None) -> str:
    """Path of the ``csrc/<name>.cu`` library built with ``defines``,
    building it if needed (``_native.library`` loads each once)."""
    return build_cuda(variants=[(name, defines or {})])[(name, _defines_key(defines))][0]


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


_OPS = {ast.Add: operator.add, ast.Sub: operator.sub, ast.Mult: operator.mul, ast.Div: operator.floordiv,
        ast.BitOr: operator.or_}


def cu_constants(name: str, defines: Optional[Mapping[str, int]] = None) -> Dict[str, int]:
    """The ``constexpr int`` constants of ``csrc/<name>.cu`` whose values are
    integer arithmetic (``+ - * / |`` of numbers, earlier constants and the
    ``M6A_*`` macros), evaluated as a build with ``defines`` sees them; a
    macro not in ``defines`` takes its ``#define`` default.  The CPU tests
    hold the Python side's layouts against them."""
    with open(os.path.join(CSRC_DIR, f"{name}.cu")) as f:
        text = f.read()
    macros = dict(re.findall(r"^#define (M6A_\w+) (\w+)$", text, re.M))
    macros.update({k: str(v) for k, v in (defines or {}).items()})
    values: Dict[str, int] = {}

    def value(node):
        if isinstance(node, ast.Constant) and isinstance(node.value, int):
            return node.value
        if isinstance(node, ast.Name):
            if node.id in values:
                return values[node.id]
            return value(ast.parse(macros[node.id], mode="eval").body)
        return _OPS[type(node.op)](value(node.left), value(node.right))

    for const, expr in re.findall(r"^constexpr int (\w+) = ([^;]+);", text, re.M):
        try:
            values[const] = value(ast.parse(expr.strip(), mode="eval").body)
        except (KeyError, SyntaxError, AttributeError, TypeError):
            continue  # not integer arithmetic (a ternary, a cast)
    return values
