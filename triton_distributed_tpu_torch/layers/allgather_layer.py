"""The persistent-workspace AllGather layer, double-buffered (counterpart of
``triton_distributed_tpu/layers/allgather_layer.py``).

The JAX layer (``_build_ws_all_gather``, the B10 AllGather bodies in a
Pallas call that writes one of two parity-slot workspaces in place) keeps
two things of the reference's low-latency layer: the steady state allocates
nothing, and a consumer may keep reading call k's result while call k + 1
runs.  Here the two workspaces are rank-stacked tensors made once, and each
call is one K9 launch (``comm/allgather.py``, ``csrc/collectives.cu``
``tdt_all_gather``, the method resolved once) whose output is the current
parity's workspace: call k's result stays intact until call k + 2.  CPU
tensors take K9's plain version into the same slot.
"""

from __future__ import annotations

import dataclasses

import torch

from ..comm.allgather import AllGatherMethod, _all_gather, resolve_method
from ..core.mesh import TP_AXIS, Mesh


@dataclasses.dataclass
class AllGatherLayer:
    """``layer(x)`` gathers dim 0 of the rank-stacked ``x``
    ``(*mesh.sizes, local_rows, *trailing)`` over ``axis`` into the current
    parity's workspace ``(*mesh.sizes, n local_rows, *trailing)`` and
    returns it; the previous call's result stays intact until the call
    after next."""

    mesh: Mesh
    local_rows: int
    trailing: tuple[int, ...]
    dtype: torch.dtype = torch.bfloat16
    axis: str = TP_AXIS
    method: AllGatherMethod = AllGatherMethod.AUTO

    def __post_init__(self):
        n = self.mesh.shape[self.axis]
        self.trailing = tuple(self.trailing)
        self.method = resolve_method(self.method, (self.local_rows, *self.trailing),
                                     self.dtype, n)
        shape = (*self.mesh.sizes, n * self.local_rows, *self.trailing)
        self._ws = [torch.zeros(shape, dtype=self.dtype, device=self.mesh.device)
                    for _ in range(2)]
        self._calls = 0

    @property
    def workspaces(self) -> tuple[torch.Tensor, torch.Tensor]:
        return self._ws[0], self._ws[1]

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        want = (*self.mesh.sizes, self.local_rows, *self.trailing)
        if tuple(x.shape) != want or x.dtype != self.dtype:
            raise ValueError(f"x {tuple(x.shape)} {x.dtype}: the layer gathers {want} "
                             f"{self.dtype}")
        out = self._ws[self._calls % 2]
        if self.mesh.shape[self.axis] == 1:
            out.copy_(x)
        else:
            _all_gather(x, self.mesh, self.axis, self.method, -1, out=out)
        self._calls += 1
        return out
