"""Builders: TOML train config -> datasets / loaders / loss function
(reference: m6anet/utils/builder.py), the port of the JAX package's
``train/builder.py``."""
from __future__ import annotations

from typing import Dict, Tuple

from ..data.dataset import build_dataset
from ..data.loader import TrainLoader
from ..data.samplers import SAMPLER_REGISTRY
from .losses import build_loss_function  # noqa: F401  — re-exported for script use


def build_mode_dataset(config: Dict, mode: str):
    """[dataset] table -> dataset.  ``format = "columnar"`` (the JAX
    package's extension of the reference's TOML surface) trains off the
    memory-mapped columnar store of a single ``root_dir`` instead of
    data.json; everything else matches the reference's builder."""
    kwargs = {k: v for k, v in config.items() if k not in ("root_dir", "format")}
    if config.get("format") == "columnar":
        from ..data.columnar import ColumnarSiteDataset

        root = config["root_dir"]
        if not isinstance(root, str):
            raise ValueError("format='columnar' training supports a single root_dir")
        kwargs.pop("n_processes", None)  # json-path norm computation knob
        return ColumnarSiteDataset(root, **kwargs, mode=mode)
    return build_dataset(config["root_dir"], **kwargs, mode=mode)


def build_dataloader(train_config: Dict, num_workers: int, verbose: bool = True) -> Tuple[TrainLoader, TrainLoader, TrainLoader]:
    """Three loaders over the Train/Val/Test splits
    (reference: m6anet/utils/builder.py:52-90)."""
    ds_config = train_config["dataset"]
    train_ds = build_mode_dataset(ds_config, "Train")
    val_ds = build_mode_dataset(ds_config, "Val")
    test_ds = build_mode_dataset(ds_config, "Test")

    if verbose:
        print(f"There are {len(train_ds)} train sites")
        print(f"There are {len(val_ds)} val sites")
        print(f"There are {len(test_ds)} test sites")

    dl_config = {k: dict(v) for k, v in train_config["dataloader"].items()}
    sampler = None
    if "sampler" in dl_config["train"]:
        sampler = SAMPLER_REGISTRY[dl_config["train"].pop("sampler")](train_ds)

    train_dl = TrainLoader(train_ds, num_workers=num_workers, sampler=sampler, **dl_config["train"])
    val_dl = TrainLoader(val_ds, num_workers=num_workers, **dl_config["val"])
    test_dl = TrainLoader(test_ds, num_workers=num_workers, **dl_config["test"])
    return train_dl, val_dl, test_dl
