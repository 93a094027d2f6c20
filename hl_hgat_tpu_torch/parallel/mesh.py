"""The device mesh (``hl_hgat_tpu/parallel/mesh.py``).

One mesh, two axes: ``data`` (batch data parallelism: gradients, the loss
and BatchNorm statistics are averaged over it) and ``graph`` (row shards of
one large complex, halo exchange between them).  Each axis carries its own
process group (``mesh.get_group("data")``, ``mesh.get_group("graph")``),
over the ranks that ``distributed.init_distributed`` set up; ranks are laid
out data-major, so the ranks of one graph group are consecutive.
"""

from __future__ import annotations

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


def make_mesh(data: int | None = None, graph: int = 1, *,
              device_type: str = "cuda") -> DeviceMesh:
    """A ('data', 'graph') mesh over every rank; ``data=None`` takes
    ``world // graph``.  ``device_type`` is ``"cuda"`` unless the caller
    asks for ``"cpu"``.  Needs an initialized process group."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: call "
                           "parallel.distributed.init_distributed first")
    world = dist.get_world_size()
    if data is None:
        data = world // graph
    if data * graph != world:
        raise ValueError(f"mesh {data}x{graph} needs {data * graph} ranks, have {world}")
    return init_device_mesh(device_type, (data, graph), mesh_dim_names=("data", "graph"))
