"""Device meshes over ``torch.distributed`` (port of ``repro/launch/mesh.py``
and ``serve.py``'s ``make_serve_mesh``).

One process a device. Under ``torchrun`` the default group comes from its
environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
``MASTER_PORT``) and a CUDA mesh binds the process to ``cuda:LOCAL_RANK``;
without that environment the only mesh is 1x1, over a world-size-1 group at a
free ``localhost`` port. NCCL runs a CUDA mesh, gloo a CPU one. A mesh whose
size is not the world's raises, and so does a CUDA mesh with no card: no mesh
quietly covers fewer ranks or falls back to the CPU.

  torchrun --nproc-per-node 2 -m repro_torch.launch.serve --mesh 1x2 ...

``make_sweep_mesh`` (the 2-D (trial, model) sweep) and
``make_production_mesh`` wait for ROADMAP Queue 1 item 14b-2.
"""
from __future__ import annotations

import os
import socket

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

_TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK")


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def init_world(device_type: str = "cuda") -> int:
    """Initialise the default process group once (NCCL for ``cuda``, gloo
    for ``cpu``) and return the world size."""
    if device_type not in ("cuda", "cpu"):
        raise ValueError(f"mesh device type {device_type!r}; expected "
                         f"'cuda' or 'cpu'")
    if device_type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("a CUDA mesh needs a card; torch.cuda is not "
                               "available (pass device_type='cpu')")
        local = int(os.environ.get("LOCAL_RANK", 0))
        if local >= torch.cuda.device_count():
            raise RuntimeError(f"LOCAL_RANK {local} but "
                               f"{torch.cuda.device_count()} card(s)")
        torch.cuda.set_device(local)
    if dist.is_initialized():
        return dist.get_world_size()
    backend = "nccl" if device_type == "cuda" else "gloo"
    if all(k in os.environ for k in _TORCHRUN_ENV):
        dist.init_process_group(backend, init_method="env://",
                                rank=int(os.environ["RANK"]),
                                world_size=int(os.environ["WORLD_SIZE"]))
    else:
        dist.init_process_group(
            backend, init_method=f"tcp://localhost:{_free_port()}",
            rank=0, world_size=1)
    return dist.get_world_size()


def destroy_world() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()


def _mesh(shape, names, device_type: str):
    world = init_world(device_type)
    size = 1
    for d in shape:
        size *= int(d)
    if size != world:
        raise ValueError(f"a {'x'.join(map(str, shape))} mesh needs {size} "
                         f"ranks; the world has {world}")
    return init_device_mesh(device_type, tuple(int(d) for d in shape),
                            mesh_dim_names=names)


def make_host_mesh(model_axis: int = 1, device_type: str = "cuda"):
    """A ``("data", "model")`` mesh over every rank, ``model_axis`` wide."""
    world = init_world(device_type)
    if world % model_axis:
        raise ValueError(f"model axis {model_axis} does not divide the world "
                         f"({world})")
    return _mesh((world // model_axis, model_axis), ("data", "model"),
                 device_type)


def make_trial_mesh(n_devices: int = 0, device_type: str = "cuda"):
    """A 1-D ``("trial",)`` mesh over the Monte-Carlo trial axis."""
    world = init_world(device_type)
    return _mesh((n_devices or world,), ("trial",), device_type)


def make_serve_mesh(spec: str, device_type: str = "cuda"):
    """``"DxM"`` -> a ``("data", "model")`` mesh of D x M ranks."""
    try:
        d_ax, m_ax = (int(v) for v in spec.lower().split("x"))
    except ValueError:
        raise ValueError(f"--mesh {spec!r}: expected DxM, e.g. 2x4") from None
    return _mesh((d_ax, m_ax), ("data", "model"), device_type)
