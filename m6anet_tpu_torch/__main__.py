"""`python -m m6anet_tpu_torch` entry point."""
from .cli import main

if __name__ == "__main__":
    main()
