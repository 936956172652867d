"""The plain reference the benchmark judges the port's outputs by.

Plain PyTorch, written from the published model (m6anet's TOML configs and
its inference utilities), and nothing else: it imports neither ``jax``, nor
the JAX package, nor anything of ``m6anet_tpu_torch``, and it takes no
array the program made.  It is given the weights and the staged batches
that the benchmark made, and it works out again whatever the program
derives from them (the MC draws included, ``threefry.py``).

Each configuration has its forward pass in a module named after it
(``<config>.py``, with ``per_read_p``); ``sites.py`` holds the site
statistics both share.  Every function computes in one of two modes:
``"f64"``, the reference, and ``"tf32"``, the control: float32 with the
operands of every matrix product rounded to TF32 (10 bits of mantissa),
the step below the float32 that the configurations state.
"""
