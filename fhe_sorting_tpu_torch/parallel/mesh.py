"""Device meshes over a torch.distributed world.

Port of `fhe_sorting_tpu/parallel/mesh.py`.  The reference's only
parallelism is OpenMP threads over independent ciphertext tasks; here, as
in the JAX package, those become named mesh axes:

  "batch" -- independent ciphertext work items (DirectSort's batches, the
             MEHP24 comparison triangle); data parallelism, whose
             accumulations are all-reduces over the axis;
  "limb"  -- RNS limb planes, owned row by row (`LimbLayout`); the ops
             that mix limbs gather or broadcast along it
             (`parallel/limb_parallel.py`).

A mesh is PyTorch's `DeviceMesh` with `mesh_dim_names`, over the whole
initialised world.  Its device type follows the world's backend: "cuda"
under NCCL (one rank a GPU), "cpu" under gloo, whose groups are only the
ranks' bookkeeping there: a gloo rank computes on the device `init_world`
gave it (`world_device`), the CPU by default or a card that several gloo
ranks share (NCCL refuses two ranks on one GPU).  `init_world` joins a
world through a `file://` store, so neither a test on the CPU nor a run on
one card needs a network.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from ..core.context import cyclic


_world_device: torch.device | None = None


def init_world(backend: str, rank: int, world: int, init_file: str,
               device: str | None = None) -> None:
    """Join a `world`-rank process group as `rank` through the store file
    `init_file` (all ranks pass the same path; it must not exist yet).
    "nccl" binds the rank to GPU `rank` and raises where there is none;
    "gloo" computes on `device`: the CPU where it is None, or a CUDA card
    that every gloo rank may name (gloo moves CUDA tensors through host
    memory).  Ranks talk over the loopback interface."""
    global _world_device
    if backend == "nccl":
        if not torch.cuda.is_available():
            raise RuntimeError("init_world: NCCL needs a CUDA device, and there is none")
        assert device is None, "an NCCL rank computes on GPU `rank`"
        torch.cuda.set_device(rank)
        _world_device = torch.device("cuda", rank)
        os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    else:
        _world_device = torch.device(device or "cpu")
        if _world_device.type == "cuda":
            torch.cuda.set_device(_world_device)
        os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    dist.init_process_group(backend, init_method=f"file://{init_file}",
                            rank=rank, world_size=world)


def world_device() -> torch.device:
    """The device this rank computes on (`init_world`'s)."""
    assert _world_device is not None, "no world: call init_world first"
    return _world_device


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


@dataclass(frozen=True)
class LimbLayout:
    """Which RNS rows one rank of a limb axis owns, by global index and the
    same at every level: Q limb i on rank i mod `parts`, special prime j on
    rank j mod `parts` (`core/context.cyclic`, by which `Context.ks_rows`
    and `Context.rescale_rows` pick a rank's rows).  A rescale drops the
    top limbs, so no limb ever changes owner, and the ranks' shares stay
    within one row of each other at every level.  Rows are held in ascending global order, so a
    rank's rows at a level are the first ones of its rows at any level
    above it, and its rows of a whole tensor are the strided view
    `x[..., index::parts, :]`."""

    num_q: int       # Q limbs of the whole chain
    num_sp: int      # special primes
    parts: int       # ranks on the limb axis
    index: int       # this rank's position on it

    @classmethod
    def of(cls, ctx, mesh: DeviceMesh | None = None, axis: str = "limb") -> "LimbLayout":
        """This rank's layout over `mesh`'s `axis` (one part without a mesh)."""
        parts = 1 if mesh is None else axis_size(mesh, axis)
        index = 0 if mesh is None else mesh.get_local_rank(axis)
        return cls(ctx.num_q, ctx.num_sp, parts, index)

    def q_rows(self, limbs: int) -> range:
        """The global indices of this rank's rows among the first `limbs` Q
        limbs."""
        return cyclic(limbs, self.parts, self.index)

    def sp_rows(self) -> range:
        """The special primes this rank owns, 0-based."""
        return cyclic(self.num_sp, self.parts, self.index)

    def take(self, x: torch.Tensor, dim: int = -2) -> torch.Tensor:
        """This rank's rows, along the limb axis `dim`, of a whole tensor
        (a strided view)."""
        idx = [slice(None)] * x.dim()
        idx[dim] = slice(self.index, None, self.parts)
        return x[tuple(idx)]

    def owner(self, row: int) -> int:
        """The rank that owns Q limb (or special prime) `row`."""
        return row % self.parts

    def key_rows(self) -> tuple:
        """This rank's rows of a key-switch key [dnum, Lq+K, n], as indices
        of its second axis: its Q limbs over the whole chain, then its
        special primes (`core/keys.Keys.rows`)."""
        return (*self.q_rows(self.num_q), *(self.num_q + j for j in self.sp_rows()))


def batch_sharding(mesh: DeviceMesh, length: int, axis: str = "batch") -> range:
    """This rank's contiguous block of a leading axis of `length` sharded
    over `axis` (the JAX package's `P("batch")` split); the whole axis,
    replicated, where `axis` has one rank."""
    return block(length, axis_size(mesh, axis), mesh.get_local_rank(axis))


def check_agreement(cts: list, mesh: DeviceMesh, axis: str = "batch") -> None:
    """Raise unless the ciphertexts that the ranks of `axis` hold (None
    where a rank has none at a position) all carry one (level, sdeg,
    slots), the condition `all_reduce_mod` sums under.  One host round trip
    (`all_gather_object`), so a sort runs it once, where its stage sequence
    is first built: its stages assert the same metadata at every later
    call.  Data-free ciphertexts (the depth meter) pass with no
    collective."""
    held = [c for c in cts if c is not None]
    assert held, "every rank needs one ciphertext to take the shape from"
    if held[0].data is None:
        return
    meta = {(c.level, c.sdeg, c.slots) for c in held}
    group = mesh.get_group(axis)
    metas = [None] * dist.get_world_size(group)
    dist.all_gather_object(metas, meta, group=group)
    if len(set().union(*metas)) != 1:
        raise ValueError(f"ranks disagree on the ciphertexts' (level, sdeg, slots): {metas}")


def all_reduce_mod(ev, cts: list, mesh: DeviceMesh, axis: str = "batch") -> list:
    """Sum position by position the ciphertexts that the ranks of `axis`
    hold, mod each limb's prime: the JAX package's chains of `ev.add` over a
    sharded axis, as one all-reduce of int64 planes.  `cts[i]` is this
    rank's partial sum at position i, or None where it has none (it sends
    zeros); every ciphertext, on every rank, must carry the same (level,
    sdeg, slots), which `check_agreement` checks.  Canonical residues are
    below 2^31, so the sum of the ranks' partials fits int64, and its
    remainder equals the chain of modular adds bit for bit.  No host round
    trip: it runs between CUDA graph replays on the caller's stream.
    Data-free ciphertexts give their metadata at every position, with no
    collective."""
    held = [c for c in cts if c is not None]
    assert held, "every rank needs one ciphertext to take the shape from"
    like = held[0]
    if like.data is None:
        return [like] * len(cts)
    stack = torch.stack([c.data if c is not None else torch.zeros_like(like.data) for c in cts])
    dist.all_reduce(stack, op=dist.ReduceOp.SUM, group=mesh.get_group(axis))
    stack = torch.remainder(stack, ev.moduli(like))
    return [like.with_data(stack[i]) for i in range(len(cts))]
