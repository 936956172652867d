"""``torch.distributed`` jobs: one process per card, from a launcher's
environment.

The JAX package runs several devices from one process (an in-process mesh)
and several hosts through ``jax.distributed``.  The port runs one process
per rank, started by a launcher (``torchrun``, or anything that sets the
``env://`` variables), each bound to ``cuda:LOCAL_RANK`` (modulo the cards
it sees, so ranks may share one card):

* inference (``--distributed``) needs no tensor collective, only a word
  from every rank before rank 0 merges the CSV shards, and rank 0's word
  after it.  Those words go through the job's key-value store, whose waits
  last up to :data:`STORE_TIMEOUT`: ranks may finish hours apart (the
  last rank of a data.json run parses every site before its slice), and
  the process group's collectives give up after their own timeout
  (gloo's default is 30 minutes).  The job is gloo, for the final
  barrier, which the ranks reach together;
* data-parallel training (``train --use_mesh on``) all-reduces BatchNorm
  sums and gradients: nccl when every rank has a card of its own, gloo
  otherwise (nccl refuses two ranks on one card).  Under gloo a CUDA
  tensor goes through host memory for each collective.

A job is never made up: without the launcher's variables
:func:`start_job` raises and names the ones missing.
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from datetime import timedelta
from typing import List, Sequence

import torch
import torch.distributed as dist

LAUNCHER_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")
# How long a wait on the job's store lasts: longer than any scoring run.  A
# rank that dies never publishes, and then the launcher (torchrun) ends the
# job's other processes.
STORE_TIMEOUT = timedelta(days=7)


@dataclass
class Job:
    """This process's place in a started ``torch.distributed`` job."""

    rank: int
    world_size: int
    local_rank: int
    backend: str
    device: torch.device
    store: dist.Store

    def publish(self, key: str, value: str) -> None:
        """Set ``key`` to ``value`` in the job's store, for every rank."""
        self.store.set(f"m6anet_tpu_torch/{key}", value)

    def wait_for(self, keys: Sequence[str]) -> List[str]:
        """The values of ``keys`` in the job's store, once all are set;
        waits up to :data:`STORE_TIMEOUT`, whatever the process group's
        timeout."""
        full = [f"m6anet_tpu_torch/{key}" for key in keys]
        self.store.wait(full, STORE_TIMEOUT)
        return [self.store.get(key).decode() for key in full]

    def barrier(self) -> None:
        if self.backend == "nccl":
            dist.barrier(device_ids=[self.device.index])
        else:
            dist.barrier()

    def all_reduce_(self, tensor: torch.Tensor) -> torch.Tensor:
        """Sum ``tensor`` over the ranks, in place; every rank gets the same
        bits."""
        if self.backend == "gloo" and tensor.is_cuda:
            host = tensor.cpu()
            dist.all_reduce(host)
            tensor.copy_(host)
        else:
            dist.all_reduce(tensor)
        return tensor

    def all_gather(self, tensor: torch.Tensor) -> List[torch.Tensor]:
        """Every rank's ``tensor`` (one shape on every rank), by rank."""
        staged = tensor.cpu() if self.backend == "gloo" and tensor.is_cuda else tensor.contiguous()
        parts = [torch.empty_like(staged) for _ in range(self.world_size)]
        dist.all_gather(parts, staged)
        return [p.to(tensor.device) for p in parts]

    def close(self) -> None:
        dist.destroy_process_group()


def start_job(device: torch.device, device_collectives: bool, log) -> Job:
    """Join the job the launcher started and bind this process to its card.

    ``device`` is the requested device type; on ``cuda`` the process takes
    ``cuda:LOCAL_RANK % device_count``.  ``device_collectives`` asks for
    collectives on device tensors (training): nccl when every local rank
    has its own card, else gloo.  Logs the backend and why."""
    missing = [name for name in LAUNCHER_ENV if not os.environ.get(name)]
    if missing:
        raise RuntimeError(
            "a multi-process run needs a launcher's environment (torchrun, or "
            f"{', '.join(LAUNCHER_ENV)} set for every process); missing: {', '.join(missing)}"
        )
    rank, world_size = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    local_rank = int(os.environ["LOCAL_RANK"])
    if not 0 <= rank < world_size:
        raise ValueError(f"RANK {rank} is outside WORLD_SIZE {world_size}")
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world_size))
    own_card = False
    if device.type == "cuda":
        n_cards = torch.cuda.device_count()
        device = torch.device("cuda", local_rank % n_cards)
        torch.cuda.set_device(device)
        own_card = local_world <= n_cards
    if device_collectives and own_card:
        backend, why = "nccl", f"{local_world} local ranks on {torch.cuda.device_count()} cards, one card each"
    elif device_collectives:
        backend = "gloo"
        why = ("the CPU" if device.type == "cpu"
               else f"{local_world} local ranks share {torch.cuda.device_count()} card(s); nccl needs one each")
    else:
        backend, why = "gloo", "this run needs a barrier only, no tensor collective"
    # the env:// rendezvous that init_process_group(init_method="env://")
    # makes, kept here so that the job can wait on its store (Job.wait_for)
    store, _, _ = next(dist.rendezvous("env://", rank=rank, world_size=world_size))
    dist.init_process_group(backend, store=store, rank=rank, world_size=world_size)
    log.info("process group: rank %d of %d (local rank %d) on %s, backend %s (%s)",
             rank, world_size, local_rank, device, backend, why)
    return Job(rank, world_size, local_rank, backend, device, store)


def note_one_card(device: torch.device, log, how: str) -> None:
    """Log that this run uses one card when more are visible and the
    process is not one rank of a launcher's job: unlike the JAX package's
    in-process mesh, the port takes several cards only through a launcher
    (``how`` names its flag)."""
    if device.type != "cuda" or any(os.environ.get(name) for name in ("RANK", "WORLD_SIZE")):
        return
    n_cards = torch.cuda.device_count()
    if n_cards > 1:
        log.info("this run uses one card of the %d visible; for all of them start it as "
                 "torchrun --nproc_per_node %d -m m6anet_tpu_torch ... %s", n_cards, n_cards, how)


class _AllReduceSum(torch.autograd.Function):
    """Sum over ranks whose backward sums the gradients over ranks: each
    rank's gradient of a global statistic holds only its own rows' share."""

    @staticmethod
    def forward(ctx, tensor, job):
        ctx.job = job
        return job.all_reduce_(tensor.clone())

    @staticmethod
    def backward(ctx, grad):
        return ctx.job.all_reduce_(grad.clone()), None


class DataParallel:
    """The JAX package's data-parallel train step over the ranks of a job.

    The JAX mesh step computes exactly the one-device step on the global
    batch; so does this.  Every rank holds the whole (padded) global batch
    and runs the model on its own rows (:meth:`shard`); the port's
    train-mode ``Linear`` takes its BatchNorm statistics over the global
    batch (:meth:`all_reduce_sum`) and its dropout mask as this rank's rows
    of one global draw (:meth:`draw_rows`); the loss is computed on the
    gathered predictions (:meth:`gather`), the same value on every rank;
    the gradients are summed over ranks (:meth:`sum_grads_`) before the
    clip and the Adam step, which every rank then takes alike."""

    def __init__(self, job: Job):
        self.job = job
        self.rank, self.world_size = job.rank, job.world_size

    def shard(self, tensor: torch.Tensor) -> torch.Tensor:
        """This rank's contiguous rows of a global tensor."""
        n = tensor.shape[0]
        if n % self.world_size:
            raise ValueError(
                f"a global batch of {n} rows does not split over {self.world_size} ranks; "
                "pad it to a multiple (TrainLoader's pad_to_multiple)"
            )
        rows = n // self.world_size
        return tensor[self.rank * rows : (self.rank + 1) * rows]

    def all_reduce_sum(self, tensor: torch.Tensor) -> torch.Tensor:
        return _AllReduceSum.apply(tensor, self.job)

    def gather(self, local: torch.Tensor) -> torch.Tensor:
        """Every rank's rows in rank order; this rank's keep their graph,
        the others' arrive detached, so a loss on the result gives this
        rank exactly its own rows' gradient."""
        parts = self.job.all_gather(local.detach())
        parts[self.rank] = local
        return torch.cat(parts)

    def draw_rows(self, shape: Sequence[int], generator: torch.Generator, device) -> torch.Tensor:
        """This rank's rows of ``torch.rand`` over the global batch's
        shape: every rank draws the whole, from one generator state."""
        full = torch.rand((shape[0] * self.world_size, *shape[1:]), generator=generator, device=device)
        return self.shard(full)

    def sum_grads_(self, grads: Sequence[torch.Tensor]) -> None:
        """Sum the gradients over ranks in place, in one collective."""
        flat = torch.cat([g.reshape(-1) for g in grads])
        self.job.all_reduce_(flat)
        pos = 0
        for g in grads:
            g.copy_(flat[pos : pos + g.numel()].view_as(g))
            pos += g.numel()

    def barrier(self) -> None:
        self.job.barrier()
