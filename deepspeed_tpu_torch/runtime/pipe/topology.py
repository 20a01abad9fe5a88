"""Cartesian process topology for hybrid parallelism.

The port's own copy of ``deepspeed_tpu/runtime/pipe/topology.py`` (pure
Python; the port imports nothing of the JAX package): ``ProcessTopology``,
an axes/dims grid with rank <-> coordinate mapping and filtered queries,
and ``PipeModelDataParallelTopology`` / ``PipeDataParallelTopology``. The
live grid of ranks is ``parallel/topology.MeshTopology``; this class is the
rank-arithmetic view the pipe module partitioner and the tests use.
"""

from __future__ import annotations

from collections import namedtuple
from itertools import product
from typing import Dict, List


class ProcessTopology:
    """Maps n-dimensional axis coordinates ↔ linear ranks. Axes are ordered
    outer-to-inner (first axis varies slowest), matching the reference."""

    def __init__(self, axes: List[str], dims: List[int]):
        if len(axes) != len(dims):
            raise ValueError("axes and dims must have equal length")
        self.axes = list(axes)
        self.dims = list(dims)
        self.ProcessCoord = namedtuple("ProcessCoord", axes)
        self.mapping = {}
        for coord in product(*(range(d) for d in dims)):
            key = self.ProcessCoord(*coord)
            self.mapping[key] = len(self.mapping)

    def get_rank(self, **coord_kwargs) -> int:
        if sorted(coord_kwargs) != sorted(self.axes):
            raise ValueError(f"expected axes {self.axes}, got {sorted(coord_kwargs)}")
        return self.mapping[self.ProcessCoord(**coord_kwargs)]

    def get_axis_names(self) -> List[str]:
        return list(self.axes)

    def get_rank_repr(self, rank: int, omit_axes=("data",), inner_sep="_",
                      outer_sep="-") -> str:
        omit = set(omit_axes)
        coord = self.get_coord(rank)
        parts = [f"{a}{inner_sep}{getattr(coord, a):02d}"
                 for a in self.axes if a not in omit]
        return outer_sep.join(parts)

    def get_dim(self, axis: str) -> int:
        return self.dims[self.axes.index(axis)] if axis in self.axes else 0

    def get_coord(self, rank: int):
        for coord, r in self.mapping.items():
            if r == rank:
                return coord
        raise ValueError(f"rank {rank} not in topology")

    def get_axis_comm_lists(self, axis: str) -> List[List[int]]:
        """Groups of ranks that vary only along ``axis`` (the reference's
        process-group construction input)."""
        if axis not in self.axes:
            return []
        other_axes = [a for a in self.axes if a != axis]
        lists = []
        for other_coord in product(*(range(self.get_dim(a)) for a in other_axes)):
            fixed = dict(zip(other_axes, other_coord))
            ranks = [self.get_rank(**{axis: i, **fixed})
                     for i in range(self.get_dim(axis))]
            lists.append(ranks)
        return lists

    def filter_match(self, **filter_kwargs) -> List[int]:
        return sorted(r for coord, r in self.mapping.items()
                      if all(getattr(coord, k) == v for k, v in filter_kwargs.items()))

    def get_axis_list(self, axis: str, idx: int) -> List[int]:
        return self.filter_match(**{axis: idx})

    def world_size(self) -> int:
        return len(self.mapping)

    def __str__(self):
        return str(self.mapping)


class PipeModelDataParallelTopology(ProcessTopology):
    """3D pipe×model(tensor)×data grid (reference pipe/topology.py:244)."""

    def __init__(self, num_pp: int, num_mp: int, num_dp: int):
        super().__init__(axes=["pipe", "data", "model"],
                         dims=[num_pp, num_dp, num_mp])


class PipeDataParallelTopology(ProcessTopology):
    def __init__(self, num_pp: int, num_dp: int):
        super().__init__(axes=["pipe", "data"], dims=[num_pp, num_dp])
