"""Distributed execution: the device mesh, its collectives, the distributed
shuffle, the data-parallel query step, the tensor-, pipeline- and
expert-parallel inference forms, ring attention and the multi-process
control plane.

Counterpart of ``infera_tpu/parallel`` (ROADMAP P13a and P13b)."""

from .mesh import Mesh, make_mesh, replicate, shard_rows  # noqa: F401
