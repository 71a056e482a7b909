"""
Multi-device / multi-host execution backends.

The reference scales via spatial data-parallelism over overlapping tiles
with thread / subprocess / Fargate workers (reference: pyshepseg/tiling.py
CONC_* managers). This package adds the device-mesh axis:

- :mod:`.pipeline` — the fully-fused on-device segmentation pipeline (one
  XLA program from cluster assignment through elimination and relabel)
- :mod:`.mesh` — SPMD tile batches over a ``jax.sharding.Mesh`` with
  ``shard_map`` (one tile per card per step, no host round-trips between
  stages), registered as the CONC_MESH concurrency backend
- :mod:`.dcn` — multi-host execution via multi-controller JAX: control
  plane over the distributed coordination service, per-host tile shards
  on local cards, stitch on process 0 (tested with local CPU processes;
  not yet run on several GPU hosts)
"""

from .mesh import SegMeshMgr  # noqa: F401  (registers CONC_MESH subclass)
