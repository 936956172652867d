"""The one table of the CUDA sources' C interfaces, the one cache of their
loaded libraries and the one launch path (``m6anet_tpu_torch/ops/_native.py``).

On the CPU: every entry of ``_native.ENTRIES`` against its ``extern "C"``
definition in ``ops/csrc/<source>.cu``; the loader and the launch path with
stubs in place of nvcc's libraries.  tests/test_torch_cuda.py checks on the
card that no step asks a loaded library for its plan again.
"""
import collections
import contextlib
import ctypes
import os
import re
import types

import pytest
import torch

from m6anet_tpu_torch.ops import _build, _native, encoder_kernel
from m6anet_tpu_torch.ops import fused_infer_kernel as fik
from m6anet_tpu_torch.ops import mc_kernel

_SCALARS = {"int64_t": ctypes.c_int64, "int": ctypes.c_int, "float": ctypes.c_float}
_RESTYPES = {"int": ctypes.c_int, "const char*": ctypes.c_char_p}


def _extern_c(source):
    """``{name: (restype text, [parameter texts])}`` of the functions that
    ``csrc/<source>.cu`` defines inside its ``extern "C"`` block."""
    with open(os.path.join(_build.CSRC_DIR, f"{source}.cu")) as f:
        text = f.read()
    block = text[text.index('extern "C" {'):text.index('}  // extern "C"')]
    found = re.findall(r"^(const char\*|int) (\w+)\(([^)]*)\)", block, re.M)
    return {name: (restype, [] if params.strip() == "void" else [" ".join(p.split()) for p in params.split(",")])
            for restype, name, params in found}


def test_the_table_lists_every_extern_c_entry():
    """Each source's table holds exactly the entries its extern "C" block
    defines: 7 of fused_infer.cu, 3 of read_prob_tc.cu, 3 of mc.cu."""
    assert set(_native.ENTRIES) == {"fused_infer", "read_prob_tc", "mc"}
    for source, entries in _native.ENTRIES.items():
        assert set(entries) == set(_extern_c(source)), source
    assert [len(e) for e in _native.ENTRIES.values()] == [7, 3, 3]


@pytest.mark.parametrize("source, entry", [(s, e) for s, entries in _native.ENTRIES.items() for e in entries])
def test_declared_interface_matches_the_kernel_source(source, entry):
    """The table's restype and argtypes of ``entry`` against its definition
    in ``csrc/<source>.cu``: a pointer is c_void_p, the scalars by type.
    The MC launches keep the parameters the wrapper passes by position where
    the source has them: n_sites, n_reads and n_iters after the five
    arrays; the list of long sites, the scratch and the tickets after the
    inputs, the list's length and long_from last."""
    restype, params = _extern_c(source)[entry]
    want = [ctypes.c_void_p if "*" in param else _SCALARS[param.split()[0]] for param in params]
    assert _native.ENTRIES[source][entry] == (_RESTYPES[restype], want)
    names = [param.split()[-1].lstrip("*") for param in params]
    if entry == "mc_site_launch":
        assert names[5:8] == ["n_sites", "n_reads", "n_iters"]
    if entry == "mc_long_site_launch":
        assert names[4:8] == ["long_sites", "e_all", "tickets", "site_p"]
        assert names[-3:] == ["n_long", "long_from", "stream_ptr"]


class _StubFn:
    """A stand-in for a ctypes function of a stub library: counts its
    calls, fills a tensor-core config array, returns ``value``."""

    def __init__(self, name, value, calls):
        self.name, self.value, self.calls = name, value, calls

    def __call__(self, *args):
        self.calls[self.name] += 1
        if self.name == "read_prob_tc_config":
            mode, out = args
            for i in range(len(_native.TC_CONFIG_KEYS)):
                out[i] = 10 * mode + i
        return self.value


_PLAN = {"read_prob_tile_reads": 512, "read_prob_wide": 0, "read_prob_lane_group": 2, "mc_error_string": b"stub"}


@pytest.fixture
def stub_libraries(monkeypatch):
    """nvcc's builds and ctypes.CDLL replaced by stubs, the loader's cache
    empty: yields the builds asked for, the stub libraries by path and the
    calls of their entries."""
    builds, loaded, calls = [], {}, collections.Counter()

    def cuda_library(source, defines=None):
        builds.append((source, dict(defines or {})))
        return f"{source}|{len(builds)}"

    def cdll(path):
        source = path.split("|")[0]
        lib = types.SimpleNamespace(**{name: _StubFn(name, _PLAN.get(name, 0), calls)
                                       for name in _native.ENTRIES[source]})
        loaded[path] = lib
        return lib

    monkeypatch.setattr(_build, "cuda_library", cuda_library)
    monkeypatch.setattr(ctypes, "CDLL", cdll)
    monkeypatch.setattr(_native, "_libraries", {})
    yield builds, loaded, calls


def test_library_loads_each_build_once_and_reads_its_plan_once(stub_libraries, monkeypatch):
    """One load per (source, defines) whatever the defines' order, the
    table declared at load, and each plan query called once however often
    the handle and the wrappers that read it are asked (the launch counters
    moving from the handle's plan)."""
    builds, loaded, calls = stub_libraries
    monkeypatch.setattr(fik, "grouped_launch_count", 0)
    monkeypatch.setattr(fik, "wide_launch_counts", {"f32": 0, "f32x3": 0, "bf16": 0})
    w = fik.Widths(1, 2, 150, 32)
    first = _native.library("fused_infer", {"M6A_POS": 1, "M6A_H1": 150})
    assert _native.library("fused_infer", {"M6A_H1": 150, "M6A_POS": 1}) is first
    assert builds == [("fused_infer", {"M6A_POS": 1, "M6A_H1": 150})]
    for _ in range(3):
        assert fik.kernel_lib(w) is fik.kernel_lib(w, 1, "f32")
        assert fik.phase_a_wide("f32", w) is False and fik.read_tile_reads("f32", w) == 512
        assert fik.phase_a_kernel("f32x3", w) == "read_prob_tc_wide_kernelILi1E"
        assert fik.read_tile_reads("bf16", w) == 23  # the stub's config: 10 * mode + the key's index
        fik.count_grouped(fik.kernel_lib(w), 1)
        fik.count_wide(fik.kernel_lib(w, precision="bf16"), "bf16", 1)
        encoder_kernel.tail_lib(encoder_kernel.TailWidths(9, 150, 32))
        mc_kernel.kernel_lib(7)
    assert [source for source, _ in builds] == ["fused_infer", "fused_infer", "read_prob_tc", "fused_infer", "mc"]
    assert len(loaded) == len(builds) == len(_native._libraries)
    assert fik.kernel_lib(w, precision="f32x3").plan == {
        m: {k: 10 * c + i for i, k in enumerate(_native.TC_CONFIG_KEYS)} for m, c in _native.TC_MODES.items()}
    assert fik.kernel_lib(w).plan == {"f32": {"tile_reads": 512, "wide": 0}} and fik.kernel_lib(w).lane_group == 2
    assert fik.grouped_launch_count == 3 and fik.wide_launch_counts == {"f32": 0, "f32x3": 0, "bf16": 3}
    assert calls == {"read_prob_tile_reads": 3, "read_prob_wide": 3, "read_prob_lane_group": 3,
                     "read_prob_tc_config": 2}
    for path, lib in loaded.items():
        for name, (restype, argtypes) in _native.ENTRIES[path.split("|")[0]].items():
            fn = getattr(lib, name)
            assert (fn.restype, fn.argtypes) == (restype, argtypes), name


def test_launch_passes_the_stream_and_raises_the_sources_error(stub_libraries, monkeypatch):
    """``_native.launch`` calls the entry with the arguments and the
    device's current stream last, inside the device guard, and raises the
    source's own error string in the wrapper's words."""
    _, loaded, calls = stub_libraries
    guarded = []

    @contextlib.contextmanager
    def device(d):
        guarded.append(d)
        yield

    monkeypatch.setattr(torch.cuda, "device", device)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda d: types.SimpleNamespace(cuda_stream=1234))
    lib = mc_kernel.kernel_lib()
    seen = []
    lib.cdll.mc_site_launch = lambda *args: seen.append(args) or 0
    _native.launch(lib, "mc_site_launch", "ops.launch.mc_site", "card", 1, 2, 3)
    assert seen == [(1, 2, 3, 1234)] and guarded == ["card"]
    lib.cdll.mc_site_launch = lambda *args: 700
    with pytest.raises(RuntimeError, match="^mc kernel launch failed: stub$"):
        _native.launch(lib, "mc_site_launch", "ops.launch.mc_site", "card")
    assert calls["mc_error_string"] == 1
