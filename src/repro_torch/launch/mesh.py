"""Mesh construction, as in `repro.launch.mesh`.

Defined as FUNCTIONS, so importing this module touches no distributed
state.  `make_production_mesh` is the only place that starts a fake
world (256 or 512 ranks on PyTorch's fake process group, whose
collectives move nothing): the dry run's counterpart of the
reference's 512 forced host devices.  `make_local_mesh` builds the mesh
over the world that exists, or starts a world of one rank.
"""

from __future__ import annotations

__all__ = ["make_production_mesh", "make_local_mesh"]


def make_production_mesh(*, multi_pod: bool = False, device: str = "cuda"):
    """Single pod: 16 x 16 = 256 ranks ("data", "model").
    Multi-pod: 2 x 16 x 16 = 512 ranks ("pod", "data", "model").

    Starts the fake world of that size as this process's default group
    (this process is rank 0 of it); raises if another world exists.
    Tensors on this mesh are meant to be fake (`FakeTensorMode`)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    # PyTorch's fake process group lives in its testing package; there
    # is no other in-process world of hundreds of ranks
    from torch.testing._internal.distributed.fake_pg import FakeStore

    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = 1
    for s in shape:
        n *= s
    if dist.is_initialized():
        raise RuntimeError("make_production_mesh starts its own fake world "
                           "of %d ranks; a process group already exists" % n)
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)
    return init_device_mesh(device, shape, mesh_dim_names=axes)


def make_local_mesh(model_parallel: int = 1, device=None):
    """("data", "model") mesh over the world that exists: world size /
    model_parallel by model_parallel.  With no world, starts one of a
    single rank: NCCL on the card, gloo when ``device="cpu"``."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from .. import resolve_device

    dev = resolve_device(device)
    if not dist.is_initialized():
        import socket
        with socket.socket() as sock:       # a free port on this host
            sock.bind(("localhost", 0))
            port = sock.getsockname()[1]
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                                init_method=f"tcp://localhost:{port}",
                                rank=0, world_size=1)
    n = dist.get_world_size()
    if n % model_parallel:
        raise ValueError(f"world of {n} ranks, model_parallel "
                         f"{model_parallel}")
    return init_device_mesh(dev.type, (n // model_parallel, model_parallel),
                            mesh_dim_names=("data", "model"))
