"""Run one cell of ``BENCHMARK.json`` on the card and print its result.

    python3 -m portbench --workload <name> --seed <n> --seconds <s> --trace <0|1>

A cell names a configuration (``configs/<config>.json``: the model, its
weights, its read threshold; its plain reference ``reference/<config>.py``)
and a traffic mix (``traffic/<traffic>.json``, read by ``traffic.py``).
Per-layer metrics are readers of their own, ``metrics/<name>.py``, and the
comparison's limits ``limits/<workload>.json``: a cell, a configuration, a
mix or a metric is added by adding files and entries.

Set-up builds the port's model from the configuration, resolves its
backend and precision as ``run_inference`` does, builds the engine's step
(``inference/engine.py::make_infer_step``) at the mix's capacities, stages
the mix's batches on the card with the host arrays ``run_inference``'s
pack thread makes (``host_sites``, ``checked_kmer_ids``), and warms the one
shape they share.  The timed window then calls the step on the staged
batches in turn, round and round, with no host sync, until ``--seconds``
have passed, and closes with ``torch.cuda.synchronize()``; each batch's
outputs from its last call stay in its slot, and ``check.py`` judges those
slots once the window has closed.  A train mix (``"kind": "train"``) sets
up a train cell instead (``train_cell.py``: the train step, judged by
``check_train.py``).  ``--trace 1`` adds, after the window, a burst of
step calls timed one by one and two profiled sub-windows, for the
per-layer readers.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import math
import os
import statistics
import sys
import time
from types import SimpleNamespace
from typing import Callable, Dict, List, Optional, Tuple

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
PROGRAM = "m6anet_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "m6anet_tpu")
PROFILE_S = 0.5  # steps the profiled sub-window covers, in seconds of the timed window's pace
LABEL_S = 0.1  # steps the second sub-window covers, whose host ops name the idle gaps
BURST = 32  # step calls timed one by one, far fewer launches than the launch queue holds
WARM_PASSES = 2


def set_cache_dirs() -> None:
    """Keep every kernel cache inside the checkout, at fixed paths (the
    port builds its own libraries into ``build/m6anet_tpu_torch/``)."""
    caches = os.path.join(ROOT, "build", "portbench")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(caches, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(caches, "triton")


def load_json(*parts: str) -> Dict:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def load_spec() -> Dict:
    return load_json(ROOT, "BENCHMARK.json")


def find(entries: List[Dict], name: str, what: str) -> Dict:
    for entry in entries:
        if entry["name"] == name:
            return entry
    raise SystemExit(f"no {what} named {name!r} in BENCHMARK.json")


def cell_metrics(spec: Dict, section: str, workload: str) -> List[Dict]:
    return [m for m in spec[section] if workload in m.get("workloads", [workload])]


def base_name(name: str, known) -> str:
    """``name``, or its longest dotted prefix in ``known``: a metric split
    by a suffix for the cells that report another end-to-end metric
    (``device.idle_pct.mc``) is read as its base (``device.idle_pct``)."""
    while name not in known and "." in name:
        name = name.rsplit(".", 1)[0]
    return name


def load_reader(name: str):
    """The per-layer metric ``name``'s reader, ``metrics/<base>.py``
    (:func:`base_name`)."""
    readers = {f[:-3] for f in os.listdir(os.path.join(HERE, "metrics")) if f.endswith(".py")}
    name = base_name(name, readers)
    path = os.path.join(HERE, "metrics", name + ".py")
    module_spec = importlib.util.spec_from_file_location("portbench_metric_" + name.replace(".", "_"), path)
    module = importlib.util.module_from_spec(module_spec)
    module_spec.loader.exec_module(module)
    return module


def forbidden_modules() -> List[str]:
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


def make_weights(config: Dict, seed: int, device) -> Dict:
    """The configuration's weights as numpy arrays in the JAX tree layout:
    its file, or drawn on ``device`` from the seed in one call."""
    import numpy as np
    import torch

    spec = config["weights"]
    if "file" in spec:
        with np.load(os.path.join(HERE, "configs", spec["file"])) as data:
            return {k: data[k] for k in data.files}
    leaves = spec["seeded"]
    sizes = [math.prod(leaf["shape"]) for leaf in leaves]
    generator = torch.Generator(device=device)
    generator.manual_seed(seed % (1 << 64))
    draws = torch.rand(sum(sizes), generator=generator, device=device).double().cpu().numpy()
    out, at = {}, 0
    for leaf, size in zip(leaves, sizes):
        u = draws[at : at + size].reshape(leaf["shape"])
        out[leaf["leaf"]] = (leaf["low"] + (leaf["high"] - leaf["low"]) * u).astype(np.float32)
        at += size
    return out


class Cell:
    """One cell set up for one seed: the port's step, the staged batches
    and a slot of outputs a batch.  The keyword arguments serve the tests,
    which drive a cell on the CPU at a small size: ``mix_override``
    replaces the mix's sizes, ``resolved`` is the (backend, precision) the
    card would resolve (its wrappers then run their plain versions), and
    ``wrap_step`` breaks the step underneath."""

    def __init__(self, workload: str, seed: int, device_name: str = "cuda", mix_override: Optional[Dict] = None,
                 resolved: Optional[Tuple[str, str]] = None, wrap_step: Optional[Callable] = None, log=None):
        mark = self._open(workload, seed, device_name, mix_override, log)
        import torch

        from . import traffic
        from m6anet_tpu_torch.inference import engine
        from m6anet_tpu_torch.models.convert import params_from_jax
        from m6anet_tpu_torch.models.mil import MILModel
        from m6anet_tpu_torch.ops import encoder_kernel, fused_infer_kernel, mc_kernel
        from m6anet_tpu_torch.utils.treeio import unflatten_tree

        self.program = SimpleNamespace(engine=engine, encoder_kernel=encoder_kernel,
                                       fused_infer_kernel=fused_infer_kernel, mc_kernel=mc_kernel)
        mark = self._stage("import", mark)

        # the program: the model from the configuration's weights, as the CLI loads one
        self.weights = make_weights(self.config, seed, self.device)
        model = MILModel(self.config["model"])
        model.load_state_dict(params_from_jax(unflatten_tree(dict(self.weights))))
        model.to(self.device).eval()
        self.backend, self.precision = resolved or engine.resolve_backend(model, "auto", "auto", self.device)
        mix = self.mix
        self.method, self.n_samples = mix["site_method"], mix["n_samples"]
        self.n_iters = mix.get("num_iterations", 1000)
        self.threshold = self.config["read_proba_threshold"]
        step = engine.make_infer_step(model, mix["sites"], self.threshold, self.n_samples, self.method,
                                      self.backend, n_iterations=self.n_iters, seed=seed, precision=self.precision)
        self.step = step if wrap_step is None else wrap_step(step)
        self.model = model
        vocab = (fused_infer_kernel.model_widths(model).vocab if self.backend in engine.CUDA_BACKENDS
                 else fused_infer_kernel.VOCAB)
        mark = self._stage("model", mark)

        # the traffic: batches staged on the card, with the pack thread's host arrays
        self.staged, self.calls = [], []
        for batch in traffic.make_batches(mix, seed):
            arrays = tuple(torch.from_numpy(a).to(self.device) for a in batch)
            host = dict(host_sites=(batch.offsets, batch.counts),
                        host_kmer_ids=fused_infer_kernel.checked_kmer_ids(batch.kmer_ids, vocab))
            self.staged.append(arrays)
            self.calls.append((arrays, host, int((batch.counts > 0).sum()), int(batch.counts.sum())))
        self.slots: List = [None] * len(self.calls)
        self.sync()
        mark = self._stage("batches", mark)

        for _ in range(WARM_PASSES):
            for b in range(len(self.calls)):
                self.call(b)
        self.sync()
        self._stage("warm-up", mark)

    def _open(self, workload: str, seed: int, device_name: str, mix_override: Optional[Dict], log) -> float:
        """What every kind of cell does before it sets up its program: read
        the cell's entries and files, import torch and the port from this
        checkout, and resolve the device.  Returns the clock's mark at its
        start, which the "import" stage counts from."""
        self.log = log or (lambda msg: print(msg, file=sys.stderr, flush=True))
        self.spec = load_spec()
        self.workload, self.seed = workload, seed
        self.cell = find(self.spec["workloads"], workload, "workload")
        self.config = load_json(HERE, "configs", self.cell["config"] + ".json")
        self.mix = dict(load_json(HERE, "traffic", self.cell["traffic"] + ".json"), **(mix_override or {}))
        self.limits = load_json(HERE, "limits", workload + ".json")
        self.stages: Dict[str, float] = {}
        mark = time.perf_counter()

        import torch

        if ROOT not in sys.path:
            sys.path.insert(0, ROOT)
        import m6anet_tpu_torch
        from m6anet_tpu_torch.inference.engine import resolve_device

        if os.path.dirname(os.path.dirname(os.path.abspath(m6anet_tpu_torch.__file__))) != ROOT:
            raise SystemExit(f"{PROGRAM} was imported from {m6anet_tpu_torch.__file__}, not from this checkout")
        self.torch = torch
        self.device = resolve_device(device_name)
        self.on_card = self.device.type == "cuda"
        self.kind = torch.cuda.get_device_name(self.device) if self.on_card else "cpu"
        return mark

    def _stage(self, name: str, mark: float) -> float:
        now = time.perf_counter()
        self.stages[name] = now - mark
        return now

    def sync(self) -> None:
        if self.on_card:
            self.torch.cuda.synchronize(self.device)

    def call(self, b: int) -> None:
        arrays, host, _, _ = self.calls[b]
        with self.torch.no_grad():
            self.slots[b] = self.step(*arrays, **host)

    def window(self, seconds: float) -> Dict[str, float]:
        """The timed window: calls in turn until ``seconds`` have passed (and
        one pass at least), closed by a sync."""
        steps = sites = reads = 0
        self.sync()
        start = time.perf_counter()
        while True:
            b = steps % len(self.calls)
            self.call(b)
            steps += 1
            sites += self.calls[b][2]
            reads += self.calls[b][3]
            if steps >= len(self.calls) and time.perf_counter() - start >= seconds:
                break
        self.sync()
        return {"steps": steps, "sites": sites, "reads": reads, "seconds": time.perf_counter() - start}

    def burst(self) -> List[float]:
        """Host seconds of each of ``BURST`` step calls made after a sync,
        while the launch queue has room: the host's own cost of a step."""
        self.sync()
        spans = []
        for i in range(BURST):
            start = time.perf_counter()
            self.call(i % len(self.calls))
            spans.append(time.perf_counter() - start)
        self.sync()
        return spans

    def profile(self, seconds: float, steps_per_s: float, host_ops: bool):
        """torch.profiler over whole passes of the staged batches covering
        about ``seconds`` of steps, from a sync to a sync; the card's
        activity alone, or with the host's ops (which slow the host)."""
        from torch.profiler import ProfilerActivity, profile

        from .trace import reduce

        passes = max(1, math.ceil(seconds * steps_per_s / len(self.calls)))
        self.profiled_steps = passes * len(self.calls)
        activities = ([ProfilerActivity.CUDA] if self.on_card else []) + ([ProfilerActivity.CPU] if host_ops else [])
        self.sync()
        with profile(activities=activities or [ProfilerActivity.CPU]) as prof:
            start = time.perf_counter()
            for _ in range(passes):
                for b in range(len(self.calls)):
                    self.call(b)
            self.sync()
            window_s = time.perf_counter() - start
        return reduce(prof.events(), window_s)

    @property
    def names(self):
        from .check import NAMES

        return NAMES

    def reader_context(self, counts) -> SimpleNamespace:
        """What the per-layer readers read of the cell; ``run`` adds the
        window's and the trace's readings."""
        return SimpleNamespace(
            program=self.program, counts=counts, kind=self.kind, backend=self.backend, precision=self.precision,
            method=self.method, n_samples=self.n_samples, n_iters=self.n_iters, mix=self.mix, state={},
            widths=counts.model_widths(self.config["model"]),
            real_reads=statistics.fmean(c[3] for c in self.calls),
            real_sites=statistics.fmean(c[2] for c in self.calls))

    def judge(self, control: bool = False) -> List[Dict[str, float]]:
        """Each batch's numbers (``check.py``), once the program's own state
        is freed; with ``control`` the reference in TF32 takes the
        program's place."""
        from . import check
        from .reference.threefry import shared_draws

        self.step = self.model = None
        if self.on_card:
            self.torch.cuda.empty_cache()
        u_host = shared_draws(self.seed, self.n_iters, self.n_samples) if self.method == "mc" else None
        return check.judge(self.cell["config"], self.weights, self.staged, self.slots, self.threshold,
                           self.method, self.n_samples, u_host, self.device, control)


def make_cell(workload: str, seed: int, device_name: str = "cuda", **cell_options):
    """The cell ``workload`` set up for ``seed``: a :class:`Cell`, or a
    ``train_cell.TrainCell`` where its mix is a train mix."""
    traffic_name = find(load_spec()["workloads"], workload, "workload")["traffic"]
    if load_json(HERE, "traffic", traffic_name + ".json").get("kind") == "train":
        from .train_cell import TrainCell

        return TrainCell(workload, seed, device_name, **cell_options)
    return Cell(workload, seed, device_name, **cell_options)


def run(workload: str, seed: int, seconds: float, trace: bool, device_name: str = "cuda",
        t0: Optional[float] = None, **cell_options) -> Dict:
    """One run of the cell ``workload``: the result's dict (``cell_options``:
    the tests' keywords of :class:`Cell` or ``TrainCell``)."""
    from . import check, counts

    t0 = time.perf_counter() if t0 is None else t0
    cell = make_cell(workload, seed, device_name, **cell_options)
    setup_s = time.perf_counter() - t0
    cell.log("set-up: " + ", ".join(f"{k} {v:.3f} s" for k, v in cell.stages.items()) + f"; total {setup_s:.3f} s")
    torch, spec = cell.torch, cell.spec

    metrics_spec = cell_metrics(spec, "per_layer" if trace else "end_to_end", workload)
    readers = {m["name"]: load_reader(m["name"]) for m in metrics_spec} if trace else {}
    ctx = cell.reader_context(counts)
    for reader in readers.values():
        if hasattr(reader, "start"):
            reader.start(ctx)
    done = cell.window(seconds)
    for reader in readers.values():
        if hasattr(reader, "stop"):
            reader.stop(ctx)
    memory_peak = torch.cuda.max_memory_allocated(cell.device) if cell.on_card else 0
    ctx.steps, ctx.window_s, ctx.window_reads = done["steps"], done["seconds"], done["reads"]

    if trace:
        ctx.step_host_s = cell.burst()
        ctx.trace = cell.profile(PROFILE_S, done["steps"] / done["seconds"], host_ops=False)
        ctx.trace_steps = cell.profiled_steps
        labelled = cell.profile(LABEL_S, done["steps"] / done["seconds"], host_ops=True)
        metrics = {}
        for m in metrics_spec:
            value = readers[m["name"]].read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        e2e = {"sites_per_s": done["sites"] / done["seconds"], "setup_s": setup_s}
        metrics = {m["name"]: {"value": e2e[base_name(m["name"], e2e)], "unit": m["unit"]} for m in metrics_spec}

    start = time.perf_counter()
    per_batch = cell.judge()
    cell.log(f"comparison with the reference: {time.perf_counter() - start:.3f} s")
    names = cell.names
    worst = check.worst(per_batch, names)
    limits = cell.limits
    result = {
        "correct": all(worst[name] <= limits[name] for name in names),
        "attempted": done["steps"],
        "failed": sum(any(n[name] > limits[name] for name in names) for n in per_batch),
        "metrics": metrics,
        "device": {"platform": "gpu" if cell.on_card else "cpu", "kind": cell.kind, "count": cell.cell["chips"],
                   "memory_peak_bytes": memory_peak},
    }
    if trace:
        result["device"].update(busy_s=ctx.trace.busy_s, window_s=ctx.trace.window_s)
        result["breakdown"] = {"device_ops": ctx.trace.breakdown()["device_ops"],
                               "idle_gaps": labelled.breakdown()["idle_gaps"]}
    result["checks"] = {name: {"value": worst[name], "limit": limits[name]} for name in names}
    leaked = forbidden_modules()
    if leaked:
        raise SystemExit(f"the run loaded {', '.join(leaked)}: nothing it runs may import JAX or the JAX package")
    for name in names:
        cell.log(f"check {name}: {worst[name]!r} (limit {limits[name]!r})")
    return result


def main(argv=None, t0: Optional[float] = None) -> int:
    t0 = time.perf_counter() if t0 is None else t0
    parser = argparse.ArgumentParser(prog="python3 -m portbench", description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    if args.seed < 0:
        parser.error("--seed must be a whole number >= 0")
    set_cache_dirs()
    import torch

    print(f"torch imported {time.perf_counter() - t0:.3f} s after start", file=sys.stderr, flush=True)
    chips = find(load_spec()["workloads"], args.workload, "workload")["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: the cell needs {chips} CUDA card(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    result = run(args.workload, args.seed, args.seconds, bool(args.trace), "cuda", t0)
    print(json.dumps(result), flush=True)
    return 0
