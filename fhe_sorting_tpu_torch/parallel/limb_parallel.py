"""Limb-axis (tensor-parallel) sharding of ciphertext RNS planes.

Port of `fhe_sorting_tpu/parallel/limb_parallel.py`.  A ciphertext's data
[2, L, n] is split over the "limb" axis of a mesh: each rank holds a
contiguous block of its limb planes (`limb_spec`), with the whole
ciphertext's level, scale degree and slots (`LimbSharded`).  Most of the op
surface is limb-local, since every limb plane is computed on its own: add,
sub and negate, products by a plaintext or a scalar, the ct*ct tensor
product, and the NTTs inside them.  Those run on the local block with no
communication.  The ops that mix limbs are:

  * rescale          - the dropped limb's coefficients reach every other limb;
  * ModUp / ModDown  - the hybrid key switch's CRT base extensions (in
                       `rotate`, and in `mult`'s relinearisation).

Where the JAX package lets GSPMD insert the collectives, this module
all-gathers along the "limb" group itself.  `LimbParallelEvaluator` is the
`Evaluator` with its block's primes, scalar limbs and plaintext planes, and
a key switch that gathers its input plane; the ops that mix limbs outside a
key switch (rescale, level adjustment, the hoisted rotations, `combo`)
gather their sharded operands, run the plain op and keep this rank's block
of the result.  Each limb rank then computes a gathered op on the whole
ciphertext: distributing the key switch's digits over the limb ranks is
later work.

Composes with the batch axis: on a ("batch", "limb") mesh,
`ShardedDirectSort` shards batches over one axis and limbs over the other.
The all-gathers run inside the ops, so a CUDA graph of a stage
(`parallel/whole_graph.py`) captures them with the op: PyTorch's NCCL
process group can be captured.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..core.cipher import Ciphertext, Plaintext
from ..core.evaluator import Evaluator
from .mesh import axis_size, block


@dataclass(frozen=True)
class LimbSharded(Ciphertext):
    """A ciphertext whose `data` holds this rank's block of limb planes
    (`limb_spec`); level, sdeg and slots are the whole ciphertext's."""


def limb_spec(mesh: DeviceMesh, limbs: int, axis: str = "limb") -> range:
    """This rank's contiguous block of `limbs` limb planes along `axis`."""
    return block(limbs, axis_size(mesh, axis), mesh.get_local_rank(axis))


def shard_limbs(ct: Ciphertext, mesh: DeviceMesh, axis: str = "limb") -> LimbSharded:
    """This rank's block of a whole ciphertext's limbs."""
    blk = limb_spec(mesh, ct.num_limbs, axis)
    return LimbSharded(ct.data[:, blk.start:blk.stop], ct.level, ct.sdeg, ct.slots)


def is_limb_sharded(ct: Ciphertext) -> bool:
    return isinstance(ct, LimbSharded)


def gather_limbs(x: torch.Tensor, limbs: int, mesh: DeviceMesh, axis: str = "limb") -> torch.Tensor:
    """All-gather the blocks [..., block, n] of a `limbs`-limb tensor along
    `axis` into [..., limbs, n] (blocks padded to one length for the
    collective)."""
    parts = axis_size(mesh, axis)
    size = -(-limbs // parts)
    pad = x.new_zeros(*x.shape[:-2], size, x.shape[-1])
    pad[..., :x.shape[-2], :] = x
    got = [torch.empty_like(pad) for _ in range(parts)]
    dist.all_gather(got, pad, group=mesh.get_group(axis))
    return torch.cat([g[..., :len(block(limbs, parts, i)), :] for i, g in enumerate(got)], dim=-2)


def _gathered(name: str):
    """The plain evaluator's op `name` on gathered operands, returning this
    rank's block of each ciphertext it yields."""
    def op(self, *args, **kw):
        sharded = False

        def whole(x):
            nonlocal sharded
            if is_limb_sharded(x):
                sharded = True
                return self.gather(x)
            if isinstance(x, (list, tuple)):
                return type(x)(whole(y) for y in x)
            return x

        out = getattr(self.ev, name)(*(whole(a) for a in args),
                                     **{k: whole(v) for k, v in kw.items()})
        if not sharded:
            return out
        if isinstance(out, Ciphertext):
            return self.ingest(out)
        if isinstance(out, list) and out and isinstance(out[0], Ciphertext):
            return [self.ingest(c) for c in out]
        return out
    op.__name__ = name
    return op


class LimbParallelEvaluator(Evaluator):
    """`Evaluator` over limb-sharded operands.

    The limb-local ops are the Evaluator's own, on this rank's block: its
    primes (`moduli`), scalar limbs and plaintext planes, and a key switch
    that gathers its input plane.  The ops that mix limbs otherwise gather
    their `LimbSharded` arguments through the plain evaluator `ev`.  The op
    counters and the plaintext memo are `ev`'s.  A whole ciphertext enters
    through `ingest`."""

    def __init__(self, ev: Evaluator, mesh: DeviceMesh, axis: str = "limb"):
        self.ev = ev
        self.mesh = mesh
        self.axis = axis
        self.ctx, self.keys = ev.ctx, ev.keys
        # a block's automorphism is the gather: the affine path's tables
        # are selected by whole limb sets (the sharded classes keep the
        # gather, as the JAX package's do)
        self.use_affine = False

    def __getattr__(self, name):
        # the plain evaluator's state (pt_stats, pt_cache_bytes, ...)
        if name == "ev":
            raise AttributeError(name)
        return getattr(self.ev, name)

    # The op counter and a frozen section are the plain evaluator's, so a
    # stage (`parallel/whole_graph.py`) that swaps the counter or freezes
    # this evaluator counts, and records the reads of, the gathered ops too.

    @property
    def op_stats(self):
        return self.ev.op_stats

    @op_stats.setter
    def op_stats(self, counter):
        self.ev.op_stats = counter

    def frozen(self):
        return self.ev.frozen()

    def _read(self, obj):
        return self.ev._read(obj)

    # -- placement -----------------------------------------------------------

    def ingest(self, ct: Ciphertext) -> LimbSharded:
        return shard_limbs(ct, self.mesh, self.axis)

    def gather(self, ct: Ciphertext) -> Ciphertext:
        """The whole ciphertext of a `LimbSharded` (others pass through)."""
        if not is_limb_sharded(ct):
            return ct
        data = gather_limbs(ct.data, self.ctx.limbs_at(ct.level), self.mesh, self.axis)
        return Ciphertext(data, ct.level, ct.sdeg, ct.slots)

    def _blk(self, level: int) -> slice:
        b = limb_spec(self.mesh, self.ctx.limbs_at(level), self.axis)
        return slice(b.start, b.stop)

    # -- the block's operands --------------------------------------------------

    def moduli(self, a: Ciphertext) -> torch.Tensor:
        assert is_limb_sharded(a), "a whole ciphertext on the limb-parallel evaluator: ingest it"
        return self.ctx.p_active(a.level)[self._blk(a.level)]

    def _pt_planes(self, pt: Plaintext) -> torch.Tensor:
        return pt.data[..., self._blk(pt.level), :]

    def _scalar_limbs(self, c: float, level: int, scale: float) -> torch.Tensor:
        return self.ev._scalar_limbs(c, level, scale)[self._blk(level)]

    def _keyswitch_core(self, d_block: torch.Tensor, level: int, ksk):
        """The key switch of one plane's block: gather the plane, switch it
        whole, keep this rank's block of both outputs."""
        full = gather_limbs(d_block, self.ctx.limbs_at(level), self.mesh, self.axis)
        e0, e1 = self.ev._keyswitch_core(full, level, ksk)
        blk = self._blk(level)
        return e0[blk], e1[blk]

    def make_plaintext(self, *args, **kw) -> Plaintext:
        return self.ev.make_plaintext(*args, **kw)

    # -- ops that mix limbs outside a key switch -------------------------------

    rescale = _gathered("rescale")
    _rescale_impl = _gathered("_rescale_impl")
    adjust_level = _gathered("adjust_level")
    level_reduce = _gathered("level_reduce")
    rotate_precompute = _gathered("rotate_precompute")
    rotate_hoisted = _gathered("rotate_hoisted")
    combo = _gathered("combo")
