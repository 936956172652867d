"""m6anet_tpu_torch: the PyTorch / CUDA port of the m6A calling engine.

A second package beside the JAX one, slice by slice (ROADMAP.md): plain
tensor code in PyTorch, and every TPU kernel of a ported path rewritten by
hand for NVIDIA Hopper (``ops/csrc/``).  It imports neither JAX nor the JAX
package.  Entry points run on the card unless the caller asks for the CPU.
"""

__version__ = "0.1.0"


def main():
    from .cli import main as cli_main

    cli_main()
