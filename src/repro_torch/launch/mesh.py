"""Device meshes (the port of ``repro/launch/mesh.py``): functions, not
module-level constants, so that importing the module touches no device
and no process group.

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` with named dims,
the reference's axis names: ``("data", "model")``, or ``("pod", "data",
"model")`` across pods.
"""

from __future__ import annotations

__all__ = ["make_host_mesh", "make_production_mesh"]


def make_production_mesh(*, multi_pod: bool = False):
    """The (16, 16) mesh of cards over ``("data", "model")``, or (2, 16,
    16) over ``("pod", "data", "model")``: under a launcher with as many
    ranks, in an initialised process group."""
    from torch.distributed.device_mesh import init_device_mesh

    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return init_device_mesh("cuda", shape, mesh_dim_names=axes)


def make_host_mesh(device="cuda"):
    """A (1, 1) mesh over ``("data", "model")`` on ``device``'s type, for
    one-device paths.  Starts a one-rank process group (NCCL on the card,
    gloo on the CPU, an in-process store) when none exists."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.kernels.ops import resolve_device

    kind = resolve_device(device).type
    if not dist.is_initialized():
        dist.init_process_group("nccl" if kind == "cuda" else "gloo",
                                store=dist.HashStore(), rank=0, world_size=1)
    return init_device_mesh(kind, (1, 1), mesh_dim_names=("data", "model"))
