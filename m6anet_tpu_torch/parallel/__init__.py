"""Runs over several processes: the site index split across processes
(``mesh.host_shard_bounds``) and ``torch.distributed`` jobs, one process per
card (``group``)."""
