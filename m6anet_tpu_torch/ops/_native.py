"""The C interfaces of the CUDA sources, their loaded libraries, and the
one launch path of the op wrappers.

``ENTRIES`` lists every ``extern "C"`` entry of ``csrc/<source>.cu``, which
:func:`declare` binds (entries an older build lacks are skipped).
:func:`library` loads a source built with a set of ``-D`` defines once per
process and reads then what it reports of its plan (:class:`Library`).
:func:`launch` calls a launch entry on a device's current stream.
"""
from __future__ import annotations

import ctypes
import threading
from typing import Dict, Mapping, NamedTuple, Optional, Tuple, Union

import torch

from ..utils.profiling import span
from . import _build

_P, _I64, _I, _F, _STR = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_float, ctypes.c_char_p

# every extern "C" entry by source: name -> (restype, argtypes); a launch
# takes the stream last
ENTRIES: Dict[str, Dict[str, Tuple[type, list]]] = {
    "fused_infer": {
        # features, kmer_ids, offsets, counts, weights, p, site_p, mod_ratio, n_reads, n_sites, threshold, n_samples
        "fused_infer_launch": (_I, [_P] * 8 + [_I64, _I64, _F, _I, _P]),
        # p, offsets, counts, site_p, mod_ratio, n_reads, n_sites, threshold, n_samples
        "site_reduce_launch": (_I, [_P] * 5 + [_I64, _I64, _F, _I, _P]),
        "read_prob_launch": (_I, [_P] * 4 + [_I64, _P]),  # features, kmer_ids, weights, p, n_reads
        "read_prob_tile_reads": (_I, []),
        "read_prob_wide": (_I, []),
        "read_prob_lane_group": (_I, []),
        "fused_infer_error_string": (_STR, [_I]),
    },
    "read_prob_tc": {
        "read_prob_tc_launch": (_I, [_P] * 4 + [_I64, _I, _P]),  # features, kmer_ids, image, p, n_reads, mode
        "read_prob_tc_config": (_I, [_I, _P]),  # mode, int32 out[len(TC_CONFIG_KEYS)]
        "read_prob_tc_error_string": (_STR, [_I]),
    },
    "mc": {
        # p, offsets, counts, u, site_p, n_sites, n_reads, n_iters, n_samples, max_count
        "mc_site_launch": (_I, [_P] * 5 + [_I64, _I64, _I, _I, _I, _P]),
        # p, offsets, counts, u, long_sites, e_all, tickets, site_p, n_sites, n_reads, n_iters, n_samples,
        # n_long, long_from
        "mc_long_site_launch": (_I, [_P] * 8 + [_I64, _I64, _I, _I, _I, _I, _P]),
        "mc_error_string": (_STR, [_I]),
    },
}
# the tensor-core kernel's mode argument (kModeF32x3, kModeBf16 in the .cu)
TC_MODES = {"f32x3": 1, "bf16": 2}
# what read_prob_tc_config reports of the tensor-core kernel's launch
TC_CONFIG_KEYS = ("threads", "consumer_warpgroups", "stages", "tile_reads", "dynamic_smem_bytes", "wide")


class Library(NamedTuple):
    """A loaded ``csrc/<source>.cu`` and the plan it reported at load: phase
    A's by precision (``"f32"``: its ``tile_reads`` and ``wide``; each
    tensor-core mode: its launch by ``TC_CONFIG_KEYS``), none for mc.cu, and
    the lanes of the f32 phase A that share a read's h1."""

    cdll: ctypes.CDLL
    source: str
    plan: Mapping[str, Mapping[str, int]] = {}
    lane_group: int = 1


def declare(lib: Union[str, ctypes.CDLL], source: str) -> ctypes.CDLL:
    """``lib`` (a ``ctypes.CDLL`` or the path of one) with every entry of
    ``ENTRIES[source]`` that it has declared."""
    lib = ctypes.CDLL(lib) if isinstance(lib, str) else lib
    for name, (restype, argtypes) in ENTRIES[source].items():
        fn = getattr(lib, name, None)
        if fn is not None:
            fn.restype, fn.argtypes = restype, argtypes
    return lib


def open_library(lib: Union[str, ctypes.CDLL], source: str) -> Library:
    """``lib`` declared, and its plan read: each query asked once."""
    lib = declare(lib, source)
    if source == "fused_infer":
        plan = {"tile_reads": lib.read_prob_tile_reads(), "wide": lib.read_prob_wide()}
        return Library(lib, source, {"f32": plan}, lib.read_prob_lane_group())
    plan = {}
    if source == "read_prob_tc":
        for mode, code in TC_MODES.items():
            out = (ctypes.c_int32 * len(TC_CONFIG_KEYS))()
            if lib.read_prob_tc_config(code, out) != 0:
                raise RuntimeError(f"read_prob_tc has no launch for precision {mode!r}")
            plan[mode] = dict(zip(TC_CONFIG_KEYS, out))
    return Library(lib, source, plan)


_lock = threading.Lock()
_libraries: Dict[Tuple[str, Tuple[Tuple[str, int], ...]], Library] = {}  # by (source, sorted defines)


def library(source: str, defines: Optional[Mapping[str, int]] = None) -> Library:
    """``csrc/<source>.cu`` built with ``defines`` (``_build.cuda_library``),
    loaded and its plan read once per process."""
    key = (source, tuple(sorted((defines or {}).items())))
    lib = _libraries.get(key)
    if lib is None:
        with _lock:
            lib = _libraries.get(key)
            if lib is None:
                lib = _libraries[key] = open_library(_build.cuda_library(source, defines), source)
    return lib


def launch(lib: Library, entry: str, span_name: str, device: torch.device, *args) -> None:
    """``lib``'s launch ``entry`` on ``args`` and the current stream of
    ``device``, inside that device's guard, the call alone inside the span
    ``span_name``; raises ``RuntimeError`` with the source's error string."""
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        with span(span_name):
            err = getattr(lib.cdll, entry)(*args, stream)
    if err != 0:
        error = getattr(lib.cdll, f"{lib.source}_error_string")(err).decode()
        raise RuntimeError(f"{lib.source} kernel launch failed: {error}")
