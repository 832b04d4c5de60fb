"""Runs spread over several processes (port of `gorder_tpu/parallel/`):
the partial states of a sharded run on disk (`shard.py`). One process per
GPU runs a shard, and a merge joins them (`engine/drivers.py`)."""
