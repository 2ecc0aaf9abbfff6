"""Multi-device rendering over a (tile, sample) mesh (PyTorch port of
smallpt_tpu/parallel/shard.py).

The reference's parallelism maps onto two axes, as in the JAX package:
- ``tile``: image-row data parallelism (smallpt.cpp:736,784): a shard
  renders a contiguous band of rows;
- ``sample``: a shard renders a disjoint slice of every pixel's samples
  (the progressive loop's samples, smallpt.cpp:901-941), reduced by a sum.

JAX runs one SPMD program over a ``Mesh`` with ``shard_map``. Here a
``Mesh`` is a plain description: shard (t, s) sits on device t * n_sample
+ s of the mesh's device list (tile-major), and belongs to the process that
owns that device. One process may own several shards: they run in turn and
their results are summed in a fixed order (s = 0, 1, ...) into a zeroed
full-height buffer, so bands and sample slices reduce alike. When
torch.distributed is initialized, every process runs the same calls on its
own shards and the buffers are summed across processes with all_reduce (the
only collective: gloo offers no other on CUDA tensors), so every process
ends with the whole image, as JAX's replicated output. Sample keying is
global (core/rng.py), so a sharded render equals the single-device render
up to the order of its sums.

Scene and camera are replicated: each device gets its own copy, and its
intersect tables, built once per call. With ``differentiable=True`` the
sum across processes is torch.distributed.nn.functional.all_reduce, so
gradients flow back through it as through shard_map's transpose.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Sequence

import torch

from smallpt_tpu_torch.config import RenderConfig
from smallpt_tpu_torch.core import rng as prng
from smallpt_tpu_torch.engine import renderer
from smallpt_tpu_torch.ops.megakernel import render_pass_megakernel
from smallpt_tpu_torch.utils.device import torch_dtype


class Shard(NamedTuple):
    """One cell of the mesh: its tile (row band), its sample slice, and the
    device of this process it runs on."""

    tile: int
    sample: int
    device: torch.device


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A (tile, sample) layout of shards. ``ranks[k]`` owns shard k = t *
    n_sample + s; ``devices[k]`` is its device in the owning process (None
    for another process's shard)."""

    n_tile: int
    n_sample: int
    devices: tuple
    ranks: tuple

    @property
    def shape(self) -> dict:
        return {"tile": self.n_tile, "sample": self.n_sample}

    @property
    def size(self) -> int:
        return self.n_tile * self.n_sample

    def local_shards(self) -> list[Shard]:
        """This process's shards, tile-major (t, then s)."""
        me = rank()
        return [Shard(k // self.n_sample, k % self.n_sample, self.devices[k])
                for k in range(self.size) if self.ranks[k] == me]

    def out_device(self) -> torch.device:
        """Where this process sums its shards: its first shard's device."""
        shards = self.local_shards()
        if not shards:
            raise ValueError(f"rank {rank()} owns no shard of the mesh")
        return shards[0].device


def distributed() -> bool:
    return (torch.distributed.is_available()
            and torch.distributed.is_initialized())


def rank() -> int:
    return torch.distributed.get_rank() if distributed() else 0


def all_sum(t: torch.Tensor, differentiable: bool = False) -> torch.Tensor:
    """t summed over the processes (t itself in one process). NCCL reduces
    CUDA tensors only, so a CPU tensor goes through the card and back
    there; gloo reduces either. differentiable: the reduction is
    torch.distributed.nn.functional.all_reduce, whose backward sums the
    incoming gradients over the processes."""
    if not distributed():
        return t
    dev = t.device
    if torch.distributed.get_backend() == "nccl" and dev.type != "cuda":
        t = t.to("cuda")
    if differentiable:
        from torch.distributed.nn.functional import all_reduce

        return all_reduce(t).to(dev)
    t = t.clone()
    torch.distributed.all_reduce(t)
    return t.to(dev)


def _local_devices(devices) -> list[torch.device]:
    if devices is None:
        n = torch.cuda.device_count()
        if not torch.cuda.is_available() or n == 0:
            raise RuntimeError("no CUDA device: pass devices=['cpu', ...] "
                               "to build a mesh on the CPU")
        return [torch.device("cuda", k) for k in range(n)]
    return [torch.device(d) for d in devices]


def make_mesh(n_tile: int | None = None, n_sample: int = 1,
              devices: Sequence | None = None) -> Mesh:
    """Build a (tile, sample) mesh over this process's devices (None: every
    visible CUDA device; raises without one), and, when torch.distributed
    is initialized, every other process's too, rank-major (each process
    calls this with its own devices). n_tile defaults to all devices on the
    tile axis (the reference's row-parallel layout). A device may repeat:
    its shards run in turn."""
    local = _local_devices(devices)
    counts = [len(local)]
    if distributed():
        c = torch.zeros(torch.distributed.get_world_size(),
                        dtype=torch.int64)
        c[rank()] = len(local)
        counts = all_sum(c).tolist()
    n_dev = sum(counts)
    if n_tile is None:
        n_tile = n_dev // n_sample
    if n_tile * n_sample != n_dev or n_tile < 1 or n_sample < 1:
        raise ValueError(f"mesh {n_tile}x{n_sample} != {n_dev} devices")
    ranks, devs = [], []
    for r, c in enumerate(counts):
        ranks += [r] * c
        devs += list(local) if r == rank() else [None] * c
    return Mesh(n_tile, n_sample, tuple(devs), tuple(ranks))


def _check_divisible(config: RenderConfig, mesh: Mesh) -> None:
    if config.height % mesh.n_tile:
        raise ValueError(f"height {config.height} not divisible by tile "
                         f"axis {mesh.n_tile}")
    if config.spp % mesh.n_sample:
        raise ValueError(f"spp {config.spp} not divisible by sample axis "
                         f"{mesh.n_sample}")


def _shard_route(scene, config: RenderConfig, differentiable: bool) -> str:
    """The JAX package's sharded routing: the megakernel where _use_mega
    holds, REGEN where _use_regen does, FLAT otherwise. Its sharded path
    has no binned drain: a MEGA sphere scene above MEGA_MAX_SPHERES takes
    REGEN."""
    route = renderer._route(scene, config, differentiable)
    return "regen" if route == "binned" else route


def sample_grid(config: RenderConfig, tile: int, sample: int, n_tile: int,
                n_sample: int, device=None):
    """The FLAT samples of shard (tile, sample) in the JAX package's
    ``_sample_grids`` layout, flattened: rows of the band, then the
    shard's in-pixel samples, then columns. Returns (sample_ids, col, row,
    cell_x, cell_y), int32 (h_loc * spp_loc * W,) each."""
    w, spp = config.width, config.spp
    h_loc, spp_loc = config.height // n_tile, spp // n_sample
    i32 = dict(dtype=torch.int32, device=device)
    row = (torch.arange(h_loc, **i32) + tile * h_loc)[:, None, None]
    ip = (torch.arange(spp_loc, **i32) + sample * spp_loc)[None, :, None]
    col = torch.arange(w, **i32)[None, None, :]
    shape = (h_loc, spp_loc, w)
    group = ip // config.spp_per_cell
    out = ((row * w + col) * spp + ip, col, row,
           group % config.jitter_size, group // config.jitter_size)
    return tuple(x.expand(shape).reshape(-1) for x in out)


def render_shard(route: str, inputs, scene, camera, config: RenderConfig,
                 key, shard: Shard, mesh: Mesh,
                 differentiable: bool = False) -> torch.Tensor:
    """One shard's (h_loc, W, 3) summed radiance over its band and sample
    slice on shard.device. inputs: renderer.wavefront_inputs on that
    device (None on the megakernel route)."""
    h_loc = config.height // mesh.n_tile
    spp_loc = config.spp // mesh.n_sample
    w = config.width
    t, s, dev = shard
    if route == "mega":
        return render_pass_megakernel(
            scene, camera, config, key, ip_offset=s * spp_loc,
            row_offset=t * h_loc, n_rows=h_loc, k_samples=spp_loc,
            device=dev)[0]
    if route == "regen":
        # one lane a pixel of the band, consuming the shard's spp_loc
        # in-pixel samples in turn
        pixel = torch.arange(t * h_loc * w, (t + 1) * h_loc * w,
                             dtype=torch.int32, device=dev)
        rad, _ = renderer.render_pixels(
            inputs.scene, camera, config, key, pixel, pixel % w, pixel // w,
            s * spp_loc, spp_loc, mesh_nee=inputs.mesh_nee,
            intersect_fn=inputs.intersect_fn)
        return rad.reshape(h_loc, w, 3)
    sid, col, row, cx, cy = sample_grid(config, t, s, mesh.n_tile,
                                        mesh.n_sample, dev)
    rad = renderer.render_samples(
        inputs.scene, camera, config, key, sid, col, row, cx, cy,
        differentiable=differentiable, mesh_nee=inputs.mesh_nee,
        intersect_fn=inputs.intersect_fn)
    return rad.reshape(h_loc, spp_loc, w, 3).sum(dim=1)


def sum_bands(parts, mesh: Mesh, band_shape, dtype,
              differentiable: bool = False) -> torch.Tensor:
    """Place each local shard's band (parts: [(Shard, tensor (rows, ...))],
    tile-major) into a zeroed full-height buffer on mesh.out_device(),
    summing a band's sample slices in order s = 0, 1, ..., then sum the
    buffers over the processes."""
    out = mesh.out_device()
    bands = [torch.zeros(band_shape, dtype=dtype, device=out)
             for _ in range(mesh.n_tile)]
    for shard, part in parts:
        bands[shard.tile] = bands[shard.tile] + part.to(out)
    return all_sum(torch.cat(bands, dim=0), differentiable)


def render_sharded(scene, camera, config: RenderConfig, key, mesh: Mesh,
                   differentiable: bool = False) -> torch.Tensor:
    """One full-frame pass sharded over the mesh. Returns the (H, W, 3)
    summed-radiance image on this process's first shard's device, whole in
    every process (the reference's single accumBuffer).

    Each device gets the scene and its intersect tables (K2 or K6, or K7's
    mesh accel, and the mesh NEE tables) once, outside the shards, as the
    JAX package builds them outside its jit. differentiable: the flat
    route under autograd; with several processes each one's scene leaves
    then hold the gradient of its own shards times the world size (the
    all_reduce's backward sums the identical loss of every process), so
    average them across processes, as DistributedDataParallel does."""
    _check_divisible(config, mesh)
    route = _shard_route(scene, config, differentiable)
    shards = mesh.local_shards()
    inputs = {}
    if route != "mega":
        for dev in dict.fromkeys(sh.device for sh in shards):
            inputs[dev] = renderer.wavefront_inputs(
                scene, config, route, dev, differentiable=differentiable)
    h_loc = config.height // mesh.n_tile
    parts = [(sh, render_shard(route, inputs.get(sh.device), scene, camera,
                               config, key, sh, mesh, differentiable))
             for sh in shards]
    return sum_bands(parts, mesh, (h_loc, config.width, 3),
                     torch_dtype(config), differentiable)


def render_image_sharded(scene, camera, config: RenderConfig, mesh: Mesh,
                         seed: int = 0, n_passes: int = 1) -> torch.Tensor:
    """Progressive mean image over n_passes, sharded (render_image's
    analog: pass p keyed fold_in(base_key(seed), p))."""
    base = prng.base_key(seed)
    acc = None
    for p in range(n_passes):
        img = render_sharded(scene, camera, config, prng.fold_in(base, p),
                             mesh)
        acc = img if acc is None else acc + img
    return acc / (n_passes * config.spp)
