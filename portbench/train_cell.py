"""A train cell: the port's train step (``train/loop.py::make_train_step``)
over training batches staged on the card.

Set-up builds the model from the configuration's weights, the optimizer
(``make_optimizer``) and the loss (``losses.LOSS_REGISTRY``) from the
mix's parameters, and the step from them, as the ``train`` CLI does; it
stages the mix's batches with the all-ones mask the CLI's epoch loop gives
a full batch.  Its first three steps, through the window's own call,
are recorded for the reference (``check_train.py``), and the warm-up runs
on to the end of the second pass over the batches.  The timed window then
calls the step on the batches in turn with no host sync; before each step
it copies the whole training state (parameters, running statistics,
Adam's moments and step counts) into the buffers of that step's place in
the pass, made in set-up, with one ``torch._foreach_copy_`` a device, and
it ends with the pass in which ``--seconds`` have passed, closed by a
sync.  Nothing is restored: training runs on as a user's run would.  The
state the window ended with is copied once the clock has stopped, so the
traced run's later steps do not touch what ``check_train.py`` judges: the
last pass's 16 steps, each from the state the program had before it.
"""
from __future__ import annotations

import time
from types import SimpleNamespace
from typing import Callable, Dict, Optional

from .harness import Cell, make_weights


class TrainCell(Cell):
    """One train cell set up for one seed.  The keyword arguments serve the
    tests: ``mix_override`` replaces the mix's sizes, and ``wrap_step(step,
    program)`` breaks the step underneath (``program``: the model and the
    optimizer it trains)."""

    def __init__(self, workload: str, seed: int, device_name: str = "cuda", mix_override: Optional[Dict] = None,
                 wrap_step: Optional[Callable] = None, log=None):
        mark = self._open(workload, seed, device_name, mix_override, log)
        mix = self.mix
        import torch

        from . import traffic
        from m6anet_tpu_torch.models.convert import params_from_jax, params_to_jax
        from m6anet_tpu_torch.models.mil import MILModel
        from m6anet_tpu_torch.train import loop, losses
        from m6anet_tpu_torch.utils.treeio import flatten_tree, unflatten_tree

        self._tree = lambda named: flatten_tree(params_to_jax(named))
        mark = self._stage("import", mark)

        # the program: the model from the configuration's weights, the optimizer and loss of the train CLI
        self.weights = make_weights(self.config, seed, self.device)
        model = MILModel(self.config["model"])
        model.load_state_dict(params_from_jax(unflatten_tree(dict(self.weights))))
        model.to(self.device)
        self.lr, self.weight_decay = mix["optimizer"]["lr"], mix["optimizer"]["weight_decay"]
        if mix["optimizer"]["name"] != "adam":
            raise ValueError(f"unknown optimizer {mix['optimizer']['name']!r}")
        optimizer = loop.make_optimizer(model, self.lr, self.weight_decay)
        step = loop.make_train_step(model, losses.LOSS_REGISTRY[mix["loss"]], optimizer, mix["clip_grad"])
        self.step = step if wrap_step is None else wrap_step(step, SimpleNamespace(model=model, optimizer=optimizer))
        self.model, self.optimizer = model, optimizer
        self.generator = torch.Generator(device=self.device)  # dropout's draws, as the CLI passes them
        self.generator.manual_seed(seed % (1 << 63))
        self.precision = "f32"  # TF32 off (resolve_device), as the train CLI runs
        mark = self._stage("model", mark)

        # the traffic: training batches staged on the card
        self.staged = [{k: torch.from_numpy(getattr(batch, k)).to(self.device) for k in batch._fields}
                       for batch in traffic.make_train_batches(mix, seed)]
        self.calls = self.staged
        self.sites_a_step = mix["sites"]
        self.reads_a_step = mix["sites"] * mix["reads_per_site"]
        self.slots = [None] * len(self.staged)
        self.sync()
        mark = self._stage("batches", mark)

        # the first steps, recorded for the reference, then the warm-up to the end of the second pass
        params = dict(model.named_parameters())
        loss, pred = self.call(0)
        first_m = self._tree({n: optimizer.state.get(p, {}).get("exp_avg", torch.zeros_like(p))
                              for n, p in params.items()})
        outputs = [(loss, pred)] + [self.call(b) for b in (1, 2)]
        self.start = {"losses": [float(out[0]) for out in outputs], "preds": [out[1].clone() for out in outputs],
                      "first_m": first_m, "after": self._tree(self._trained_and_stats())}
        for b in range(3, 2 * len(self.staged)):
            self.call(b % len(self.staged))

        # what the window copies before each step: live tensors, grouped a device
        live = {("param", n): p for n, p in params.items()}
        live.update({("stat", n): t for n, t in self._trained_and_stats().items() if n not in params})
        for n, p in params.items():
            state = optimizer.state.get(p, {})
            live[("m", n)] = state.get("exp_avg", torch.zeros_like(p))
            live[("v", n)] = state.get("exp_avg_sq", torch.zeros_like(p))
            live[("step", n)] = state.get("step", torch.zeros(()))
        groups: Dict = {}
        for k, t in live.items():
            groups.setdefault(t.device, ([], []))
            groups[t.device][0].append(k)
            groups[t.device][1].append(t)
        self.copies = list(groups.values())  # (keys, live tensors) a device
        # one set of buffers before each step of a pass, and one for the state the window ends with
        self.states = [[[t.detach().clone() for t in tensors] for _, tensors in self.copies]
                       for _ in range(len(self.staged) + 1)]
        self.sync()
        self._stage("warm-up", mark)

    def _trained_and_stats(self) -> Dict:
        """The model's trained leaves and running statistics, by name
        (``num_batches_tracked`` counts nothing the step reads)."""
        return {n: t for n, t in self.model.state_dict(keep_vars=True).items() if not n.endswith("num_batches_tracked")}

    def snapshot(self, buffers) -> None:
        """Copy the live training state into ``buffers`` (a list of tensors
        a device, as ``copies``), one fused copy a device."""
        with self.torch.no_grad():
            for (_, tensors), targets in zip(self.copies, buffers):
                self.torch._foreach_copy_(targets, tensors)

    def call(self, b: int):
        self.slots[b] = self.step(self.staged[b], self.generator)
        return self.slots[b]

    def window(self, seconds: float) -> Dict[str, float]:
        """The timed window: whole passes over the batches, the state copied
        before each step, until ``seconds`` have passed, closed by a sync."""
        n = len(self.staged)
        steps = 0
        self.sync()
        start = time.perf_counter()
        while True:
            b = steps % n
            self.snapshot(self.states[b])
            self.call(b)
            steps += 1
            if b == n - 1 and time.perf_counter() - start >= seconds:
                break
        self.sync()
        elapsed = time.perf_counter() - start
        self.snapshot(self.states[n])
        self.last_pass = {"losses": [float(out[0]) for out in self.slots], "preds": [out[1] for out in self.slots]}
        return {"steps": steps, "sites": steps * self.sites_a_step, "reads": steps * self.reads_a_step,
                "seconds": elapsed}

    def _record(self, buffers) -> Dict:
        """A copied state in the configuration's weight layout."""
        kinds: Dict[str, Dict] = {}
        for (keys, _), targets in zip(self.copies, buffers):
            for (kind, name), t in zip(keys, targets):
                kinds.setdefault(kind, {})[name] = t
        return {"params": self._tree(kinds["param"]), "stats": self._tree(kinds["stat"]),
                "m": self._tree(kinds["m"]), "v": self._tree(kinds["v"]),
                "step": max(int(t) for t in kinds["step"].values())}

    @property
    def names(self):
        from .check_train import NAMES

        return NAMES

    def reader_context(self, counts) -> SimpleNamespace:
        return SimpleNamespace(counts=counts, kind=self.kind, precision=self.precision, mix=self.mix, state={},
                               widths=counts.model_widths(self.config["model"]))

    def judge(self, control: bool = False):
        """Each compared step's numbers (``check_train.py``), once the
        program's own state is freed; with ``control`` the reference in TF32
        takes the program's place."""
        from . import check_train

        last_pass = dict(self.last_pass, states=[self._record(buffers) for buffers in self.states])
        self.step = self.model = self.optimizer = self.copies = self.slots = None
        if self.on_card:
            self.torch.cuda.empty_cache()
        return check_train.judge(self.cell["config"], self.weights, self.staged, self.start, last_pass, self.lr,
                                 self.weight_decay, self.device, control, self.log)
