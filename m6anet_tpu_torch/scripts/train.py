"""`m6anet_tpu_torch train` — train an m6A MIL model from TOML configs.

The flags of the JAX package's ``train`` command (reference:
m6anet/scripts/train.py, plus ``--clip_grad``, ``--resume_epoch``,
``--resume_from``, ``--reseed_on_stall`` and ``--init_probability_bias``),
with ``--device {cuda,cpu}`` (default cuda).  ``--use_mesh on`` (and
``auto`` when the launcher's ``WORLD_SIZE`` is above 1) trains data-parallel
over the ranks of a ``torch.distributed`` job, one process per card
(``torchrun --nproc_per_node N -m m6anet_tpu_torch train ...``): the JAX
package's mesh step, the one-process step on each global batch padded to a
multiple of the ranks (``train.loop.make_train_step``).  Every rank loads
every batch with one loader thread (so that every rank draws the same
reads); rank 0 alone prints and writes.  ``off``, and ``auto`` outside a
job, train on one device.

``--seed`` seeds numpy, as the JAX script does, so the samplers, shuffles
and read subsampling draw as there; the initial parameters come from a
``torch.Generator`` seeded with it, from the JAX package's laws but not its
values.  To start from a JAX run's parameters, pass them as
``--resume_from <npz>``.

Outputs, in the JAX package's layout (so both packages' ``inference
--model_state_dict`` read the ``.npz`` files): train_info.toml,
train_results.json, val_results.json, model_states/<epoch>/,
{avg_loss,roc_auc,pr_auc}.npz and test_results_<criterion>.json.
"""
from __future__ import annotations

import json
import os
from argparse import ArgumentDefaultsHelpFormatter, ArgumentParser

from ..constants import DEFAULT_MODEL_CONFIG, TRAIN_CONFIG_TEMPLATE


def argparser():
    parser = ArgumentParser(formatter_class=ArgumentDefaultsHelpFormatter, add_help=False)
    parser.add_argument("--model_config", default=DEFAULT_MODEL_CONFIG, help="path to model config file.")
    parser.add_argument("--train_config", required=True,
                        help="path to training config file (ready-to-edit "
                             f"template packaged at {TRAIN_CONFIG_TEMPLATE}).")
    parser.add_argument("--save_dir", required=True, help="directory to output training results.")
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                        help="device to train on; 'cuda' fails when no card is "
                             "usable instead of falling back to the CPU.")
    parser.add_argument("--lr", default=4e-4, type=float, help="training learning rate.")
    parser.add_argument("--seed", default=25, type=int,
                        help="random seed for training (numpy's draws, and the "
                             "torch generators of the init and dropout).")
    parser.add_argument("--epochs", default=50, type=int, help="number of training epochs.")
    parser.add_argument("--n_processes", default=25, type=int,
                        help="number of loader threads.")
    parser.add_argument("--save_per_epoch", default=10, type=int,
                        help="number of epoch multiple to save training checkpoint.")
    parser.add_argument("--weight_decay", default=0, type=float,
                        help="weight decay (classic L2, torch-Adam semantics).")
    parser.add_argument("--num_iterations", default=5, type=int,
                        help="number of passes during evaluation step.")
    parser.add_argument("--clip_grad", default=None, type=float,
                        help="optional global-norm gradient clipping.")
    parser.add_argument("--resume_epoch", default=0, type=int,
                        help="epoch offset when resuming from a checkpoint.")
    parser.add_argument("--resume_from", default=None,
                        help="checkpoint to resume from: a params .npz, a "
                             "checkpoint directory (written by either package), "
                             "or 'auto' to pick the latest under save_dir.")
    parser.add_argument("--use_mesh", default="auto", choices=["auto", "on", "off"],
                        help="data-parallel training over the ranks of a "
                             "torch.distributed job (one process per card, "
                             "started by torchrun); auto = on when WORLD_SIZE > 1.")
    parser.add_argument("--reseed_on_stall", default=False, action="store_true",
                        help="detect the saturated noisy-OR plateau (loss ~6.9, "
                             "ROC ~0.5 — a known fixed point of this model "
                             "family) and auto-restart with a derived seed.")
    parser.add_argument("--stall_patience", default=20, type=int,
                        help="consecutive plateau epochs before a restart "
                             "(with --reseed_on_stall).")
    parser.add_argument("--max_restarts", default=3, type=int,
                        help="restart budget for --reseed_on_stall.")
    parser.add_argument("--init_probability_bias", default=None, type=float,
                        help="saturation-aware init: set the probability "
                             "layer's bias to this value (e.g. -4) so a fresh "
                             "init starts outside the saturated noisy-OR "
                             "region.  Changes the init distribution vs the "
                             "reference; off by default.")
    return parser


def main(args):
    import numpy as np
    import torch

    from ..inference.engine import resolve_device
    from ..models.convert import params_from_jax
    from ..models.mil import MILModel
    from ..parallel.group import DataParallel, note_one_card, start_job
    from ..train.builder import build_dataloader, build_loss_function
    from ..train.loop import make_eval_step, make_optimizer, saturation_aware_init, train, validate
    from ..utils.config import dump_toml, load_toml
    from ..utils.logging import get_logger
    from ..utils.treeio import load_tree, save_tree

    device = resolve_device(args.device)  # fails here, before any work, without a card
    np.random.seed(args.seed)

    model_config = load_toml(args.model_config)
    train_config = load_toml(args.train_config)

    log = get_logger("m6anet_tpu_torch.train")
    data_parallel, n_processes = None, args.n_processes
    if args.use_mesh == "on" or (args.use_mesh == "auto" and int(os.environ.get("WORLD_SIZE", "1")) > 1):
        job = start_job(device, device_collectives=True, log=log)
        device, data_parallel = job.device, DataParallel(job)
        for section in train_config["dataloader"].values():
            section["pad_to_multiple"] = job.world_size
        if job.world_size > 1:
            n_processes = 1  # one loader thread: every rank draws the same reads
    else:
        note_one_card(device, log, "--use_mesh on")
    main_rank = data_parallel is None or data_parallel.rank == 0
    if data_parallel is not None and main_rank:
        print(f"Data-parallel training over {data_parallel.world_size} ranks")

    save_dir = args.save_dir
    if main_rank:
        print(f"Saving training information to {save_dir}")
    os.makedirs(save_dir, exist_ok=True)

    train_info = {
        "model_config": model_config,
        "train_config": {
            **train_config,
            "learning_rate": args.lr,
            "epochs": args.epochs,
            "save_per_epoch": args.save_per_epoch,
            "weight_decay": args.weight_decay,
            "number_of_validation_iterations": args.num_iterations,
            "seed": args.seed,
        },
    }
    if main_rank:
        dump_toml(train_info, os.path.join(save_dir, "train_info.toml"))

    model = MILModel(model_config).to(device)
    optimizer = make_optimizer(model, args.lr, args.weight_decay)

    def init_fn(seed):
        model.init(torch.Generator().manual_seed(seed))
        if args.init_probability_bias is not None:
            saturation_aware_init(model, bias=args.init_probability_bias)

    if args.resume_from:
        from ..train.checkpoint import latest_checkpoint, restore_checkpoint

        target = args.resume_from
        if target == "auto":
            target = latest_checkpoint(save_dir)
            if target is None:
                raise ValueError(f"no checkpoint found under {save_dir}")
        if os.path.isdir(target):
            epoch = restore_checkpoint(target, model, optimizer)
            if not args.resume_epoch:
                args.resume_epoch = epoch
        else:
            model.load_state_dict(params_from_jax(load_tree(target)))
    else:
        init_fn(args.seed)

    train_dl, val_dl, test_dl = build_dataloader(train_config, n_processes, verbose=main_rank)

    loss_fn = build_loss_function(dict(train_config["loss_function"]))

    train_results, val_results = train(
        model,
        train_dl,
        val_dl,
        optimizer,
        args.epochs,
        loss_fn,
        save_dir=save_dir,
        clip_grad=args.clip_grad,
        save_per_epoch=args.save_per_epoch,
        epoch_increment=args.resume_epoch,
        n_iterations=args.num_iterations,
        seed=args.seed,
        init_fn=init_fn,
        reseed_on_stall=args.reseed_on_stall,
        stall_patience=args.stall_patience,
        max_restarts=args.max_restarts,
        data_parallel=data_parallel,
    )

    def _dump_results(results, path):
        clean = {
            k: [v.tolist() if hasattr(v, "tolist") else v for v in vals]
            for k, vals in results.items()
            if k not in ("y_pred", "y_true")
        }
        with open(path, "w", encoding="utf-8") as f:
            json.dump(clean, f, indent=2)

    if main_rank:
        _dump_results(train_results, os.path.join(save_dir, "train_results.json"))
        _dump_results(val_results, os.path.join(save_dir, "val_results.json"))

    # Best-model selection per criterion over saved checkpoints + test eval
    # (reference: m6anet/scripts/train.py:107-131).  Every rank reads the
    # checkpoints rank 0 wrote and evaluates its rows of the test batches.
    eval_step = make_eval_step(model, loss_fn, data_parallel)
    for criterion in ("avg_loss", "roc_auc", "pr_auc"):
        series = [
            val_results[criterion][i]
            for i in range(0, len(val_results[criterion]), args.save_per_epoch)
        ]
        if criterion == "avg_loss":
            best_epoch = (int(np.argmin(series)) + 1) * args.save_per_epoch
        else:
            best_epoch = (int(np.argmax(series)) + 1) * args.save_per_epoch
        # checkpoints are saved under GLOBAL epoch numbers (epoch + resume
        # offset), so a resumed run must select with the same offset
        best_epoch += args.resume_epoch
        best_params = load_tree(os.path.join(save_dir, "model_states", str(best_epoch), "model_states.npz"))
        if main_rank:
            save_tree(os.path.join(save_dir, f"{criterion}.npz"), best_params)
        model.load_state_dict(params_from_jax(best_params))

        test_results = validate(eval_step, test_dl, loss_fn, device, args.num_iterations)
        if not main_rank:
            continue
        print(f"Criteria: {criterion} \tCompute time: {test_results['compute_time']:.3f}")
        print(
            f"Test Loss: {test_results['avg_loss']:.3f} \t"
            f"Test ROC AUC: {test_results['roc_auc']:.3f} \t "
            f"Test PR AUC: {test_results['pr_auc']:.3f}"
        )
        print("=====================================")
        _dump_results(
            {k: [v] for k, v in test_results.items() if k not in ("y_pred", "y_true")},
            os.path.join(save_dir, f"test_results_{criterion}.json"),
        )
    if data_parallel is not None:
        data_parallel.barrier()
        data_parallel.job.close()
