"""The benchmark of ``m6anet_tpu_torch``, the port to PyTorch and CUDA: the
engine's per-batch device step over batches staged on the card.  Run one
cell with ``python3 -m portbench --workload <name> --seed <n> --seconds <s>
--trace <0|1>`` (``harness.py``)."""
