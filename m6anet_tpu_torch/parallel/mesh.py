"""Site-index sharding across processes, the port's copy of the JAX
package's ``parallel/mesh.py::host_shard_bounds``.

Each process of a multi-process inference run scores its contiguous slice
of the global site index and writes its own CSV shards; the shards are
merged on the host afterwards (``inference.engine.merge_host_shards``), so
the reference's append-only CSV contract holds.  The JAX package's
in-process device mesh has no counterpart here: the port runs one process
per card (``parallel.group``).
"""
from __future__ import annotations


def host_shard_bounds(n_items: int, n_hosts: int, host_id: int):
    """Contiguous [start, end) slice of a global site index for this host."""
    per = -(-n_items // n_hosts)
    start = min(host_id * per, n_items)
    return start, min(start + per, n_items)
