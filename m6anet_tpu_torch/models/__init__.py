from .mil import BLOCK_REGISTRY, MILModel, build_block, load_model  # noqa: F401
