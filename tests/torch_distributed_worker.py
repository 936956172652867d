"""One rank of a job of the PyTorch port on the CPU (gloo), for
tests/test_torch_distributed.py and tests/test_torch_norm_cli.py.  Imports
no JAX.

    RANK=r WORLD_SIZE=n LOCAL_RANK=r MASTER_ADDR=localhost MASTER_PORT=p \\
        python torch_distributed_worker.py <inputs.pt> <out_prefix>

``inputs.pt`` holds the production model's starting ``state``, the global
``batches`` (numpy dicts of X, kmer, y and mask, each padded to a multiple
of n) and ``lr``, ``wd``, ``clip``.  The rank joins the job
(``parallel.group.start_job``), takes ``train.loop.make_train_step``'s
data-parallel step over every batch in turn, then runs a dropout
``Linear`` on its rows of ``dropout_x``; it writes
``<out_prefix>.rank<r>.pt``: each step's loss, gathered predictions and
resulting state, and the dropout output.

    ... python torch_distributed_worker.py late <timeout_s> <late_rank> <delay_s> <CLI argv>

runs ``m6anet_tpu_torch <CLI argv>`` with the process group's timeout cut
to ``timeout_s`` seconds, rank ``late_rank`` starting its scoring
``delay_s`` seconds late (``inference --distributed``).
"""
import os
import sys

import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))


def late(timeout_s, late_rank, delay_s, argv):
    import time
    from datetime import timedelta

    import torch.distributed as dist

    from m6anet_tpu_torch.cli import main as cli_main
    from m6anet_tpu_torch.scripts import inference

    init = dist.init_process_group

    def short_init(*args, **kwargs):
        return init(*args, **{**kwargs, "timeout": timedelta(seconds=float(timeout_s))})

    score = inference._score

    def late_score(args, device, host_shard):
        if host_shard[0] == int(late_rank):
            print(f"rank {late_rank} starts scoring {delay_s} s late", file=sys.stderr, flush=True)
            time.sleep(float(delay_s))
        return score(args, device, host_shard)

    dist.init_process_group = short_init
    inference._score = late_score
    cli_main(argv)


def main():
    if sys.argv[1] == "late":
        late(*sys.argv[2:5], sys.argv[5:])
        return
    inputs_path, out_prefix = sys.argv[1:3]
    from m6anet_tpu_torch.constants import DEFAULT_MODEL_CONFIG
    from m6anet_tpu_torch.models.blocks import Linear
    from m6anet_tpu_torch.models.mil import MILModel
    from m6anet_tpu_torch.parallel.group import DataParallel, start_job
    from m6anet_tpu_torch.train import loop, losses
    from m6anet_tpu_torch.utils.config import load_toml
    from m6anet_tpu_torch.utils.logging import get_logger

    inputs = torch.load(inputs_path, weights_only=False)
    job = start_job(torch.device("cpu"), device_collectives=True, log=get_logger("worker"))
    dp = DataParallel(job)

    model = MILModel(load_toml(DEFAULT_MODEL_CONFIG))
    model.load_state_dict(inputs["state"])
    optimizer = loop.make_optimizer(model, inputs["lr"], inputs["wd"])
    step = loop.make_train_step(model, losses.binary_cross_entropy_loss, optimizer, inputs["clip"], dp)
    step_losses, preds, states = [], [], []
    for batch in inputs["batches"]:
        loss, pred = step({k: torch.from_numpy(v) for k, v in batch.items()})
        step_losses.append(loss)
        preds.append(pred)
        states.append({k: v.clone() for k, v in model.state_dict().items()})

    block = Linear(9, 16, activation="relu", batch_norm=True, dropout=0.25)
    block.load_state_dict(inputs["dropout_state"])
    block.data_parallel = dp
    with torch.no_grad():
        dropped = block(dp.shard(inputs["dropout_x"]), train=True, generator=torch.Generator().manual_seed(1))

    torch.save({"losses": torch.stack(step_losses), "preds": preds, "states": states,
                "dropout": dropped, "dropout_running_mean": block.bn.running_mean.clone(),
                "backend": job.backend},
               f"{out_prefix}.rank{job.rank}.pt")
    job.barrier()
    job.close()


if __name__ == "__main__":
    main()
