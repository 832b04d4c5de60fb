"""Parallel runs (port of `gorder_tpu/parallel/`): the frames of each batch
split over the devices of one process (`mesh.py`, `context.py`), and the
partial states of a run sharded over processes on disk (`shard.py`). One
process per GPU runs a shard, and a merge joins them
(`engine/drivers.py`)."""
