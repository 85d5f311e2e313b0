"""Device meshes over a torch.distributed world.

Port of `fhe_sorting_tpu/parallel/mesh.py`.  The reference's only
parallelism is OpenMP threads over independent ciphertext tasks; here, as
in the JAX package, those become named mesh axes:

  "batch" -- independent ciphertext work items (DirectSort's batches, the
             MEHP24 comparison triangle); data parallelism, whose
             accumulations are all-reduces over the axis;
  "limb"  -- RNS limb planes; ops that mix limbs all-gather along it
             (`parallel/limb_parallel.py`).

A mesh is PyTorch's `DeviceMesh` with `mesh_dim_names`, over the whole
initialised world (one rank a device).  Its device type follows the
world's backend: "cuda" under NCCL (one rank a GPU), "cpu" under gloo.
`init_world` joins a world through a `file://` store, so neither a test on
the CPU nor a run on one card needs a network.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


def init_world(backend: str, rank: int, world: int, init_file: str) -> None:
    """Join a `world`-rank process group as `rank` through the store file
    `init_file` (all ranks pass the same path; it must not exist yet).
    "nccl" binds the rank to GPU `rank` and raises where there is none;
    "gloo" runs on the CPU.  Ranks talk over the loopback interface."""
    if backend == "nccl":
        if not torch.cuda.is_available():
            raise RuntimeError("init_world: NCCL needs a CUDA device, and there is none")
        torch.cuda.set_device(rank)
        os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    else:
        os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    dist.init_process_group(backend, init_method=f"file://{init_file}",
                            rank=rank, world_size=world)


def _device_type() -> str:
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def make_mesh(n_devices: int | None = None, axis: str = "batch") -> DeviceMesh:
    """A 1D mesh named `axis` over the world (`n_devices`, where given,
    must be the world size)."""
    n = n_devices or dist.get_world_size()
    assert n == dist.get_world_size(), f"a mesh of {n} over a world of {dist.get_world_size()}"
    return init_device_mesh(_device_type(), (n,), mesh_dim_names=(axis,))


def make_mesh_2d(n_batch: int, n_limb: int, axes: tuple = ("batch", "limb")) -> DeviceMesh:
    """2D mesh: independent ciphertext work items on one axis, RNS limb
    planes on the other; rank = batch index * n_limb + limb index."""
    n = n_batch * n_limb
    assert n == dist.get_world_size(), f"need {n} ranks, have {dist.get_world_size()}"
    return init_device_mesh(_device_type(), (n_batch, n_limb), mesh_dim_names=axes)


def axis_size(mesh: DeviceMesh, axis: str) -> int:
    return mesh.shape[mesh.mesh_dim_names.index(axis)]


def block(length: int, parts: int, index: int) -> range:
    """The `index`-th of `parts` contiguous blocks of range(length), their
    lengths one apart at most (the split of a sharded axis)."""
    return range(index * length // parts, (index + 1) * length // parts)


def batch_sharding(mesh: DeviceMesh, length: int, axis: str = "batch") -> range:
    """This rank's contiguous block of a leading axis of `length` sharded
    over `axis` (the JAX package's `P("batch")` split); the whole axis,
    replicated, where `axis` has one rank."""
    return block(length, axis_size(mesh, axis), mesh.get_local_rank(axis))


def all_reduce_mod(ev, cts: list, mesh: DeviceMesh, axis: str = "batch") -> list:
    """Sum position by position the ciphertexts that the ranks of `axis`
    hold, mod each limb's prime: the JAX package's chains of `ev.add` over a
    sharded axis, as one all-reduce of int64 planes.  `cts[i]` is this
    rank's partial sum at position i, or None where it has none (it sends
    zeros); every ciphertext, on every rank, must carry the same (level,
    sdeg, slots).  Canonical residues are below 2^31, so the sum of the
    ranks' partials fits int64, and its remainder equals the chain of
    modular adds bit for bit.  Data-free ciphertexts (the depth meter) give
    their metadata at every position, with no collective."""
    held = [c for c in cts if c is not None]
    assert held, "every rank needs one ciphertext to take the shape from"
    like = held[0]
    if like.data is None:
        return [like] * len(cts)
    meta = {(c.level, c.sdeg, c.slots) for c in held}
    group = mesh.get_group(axis)
    metas = [None] * dist.get_world_size(group)
    dist.all_gather_object(metas, meta, group=group)
    if len(set().union(*metas)) != 1:
        raise ValueError(f"ranks disagree on the ciphertexts' (level, sdeg, slots): {metas}")
    stack = torch.stack([c.data if c is not None else torch.zeros_like(like.data) for c in cts])
    dist.all_reduce(stack, op=dist.ReduceOp.SUM, group=group)
    stack = torch.remainder(stack, ev.moduli(like))
    return [like.with_data(stack[i]) for i in range(len(cts))]
