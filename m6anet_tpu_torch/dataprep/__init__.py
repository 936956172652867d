"""eventalign.txt -> the site store (data.json, data.info, data.log and the
columnar store): the port's copy of the JAX package's ``dataprep``."""
from .runner import is_successful, read_last_line, run_dataprep  # noqa: F401
