"""Multi-process rendering: torch.distributed and the (tile, sample) mesh
spanning processes (PyTorch port of smallpt_tpu/parallel/distributed.py).

The reference is one process on one GPU (smallpt.cpp:480-481). Here:
- ``initialize()``: one call per process joins the process group over a TCP
  rendezvous; nothing on the machine tells a process of a cluster, so the
  address, the world size and the rank are given. The backend is NCCL in a
  process with a card and gloo otherwise;
- ``global_mesh()``: every process calls it with its own devices and gets
  one (tile, sample) mesh over all of them, rank-major
  (parallel/shard.py::make_mesh); the renders of parallel/ then run
  unchanged, each process on its own shards, their results summed with
  all_reduce;
- ``host_tile_rows()``: the rows of this process's band, for per-process
  band output.
Progressive state is the checkpoint (engine/progressive.py); a restarted
process loads it, and the deterministic sample keying (core/rng.py)
resumes the exact stream.
"""

from __future__ import annotations

import torch

from smallpt_tpu_torch.parallel.shard import Mesh, make_mesh, rank


def initialize(coordinator_address: str, num_processes: int,
               process_id: int, backend: str | None = None) -> None:
    """Join this process to the process group: coordinator_address is
    "host:port" (or a full "tcp://host:port" init method) of rank 0's
    rendezvous, num_processes the world size, process_id this rank.
    backend None: "nccl" when this process sees a CUDA device, else
    "gloo"."""
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    init = (coordinator_address if "://" in coordinator_address
            else f"tcp://{coordinator_address}")
    torch.distributed.init_process_group(backend, init_method=init,
                                         world_size=num_processes,
                                         rank=process_id)


def global_mesh(n_sample: int = 1, devices=None) -> Mesh:
    """(tile, sample) mesh over every process's devices (devices: this
    process's; None: its visible CUDA devices). Keep n_sample at most the
    devices a process holds, so a sample slice's sum stays inside one
    host's interconnect; the tile axis then falls on the process
    boundary."""
    return make_mesh(n_sample=n_sample, devices=devices)


def host_tile_rows(height: int, mesh: Mesh) -> tuple[int, int]:
    """(row_start, n_rows) of this process's image band under a mesh whose
    tile axis is process-major (make_mesh's order): the rows of the tiles
    it holds a shard of; (0, 0) if it holds none."""
    if height % mesh.n_tile:
        raise ValueError(f"height {height} % tile axis {mesh.n_tile} != 0")
    rows = height // mesh.n_tile
    mine = sorted({k // mesh.n_sample for k in range(mesh.size)
                   if mesh.ranks[k] == rank()})
    if not mine:
        return 0, 0
    return mine[0] * rows, len(mine) * rows
