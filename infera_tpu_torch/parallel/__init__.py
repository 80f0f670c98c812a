"""Distributed execution: the device mesh, its collectives, the distributed
shuffle, the data-parallel query step and the multi-process control plane.

Counterpart of ``infera_tpu/parallel`` (the ``dp`` forms; ROADMAP P13a)."""

from .mesh import Mesh, make_mesh, replicate, shard_rows  # noqa: F401
