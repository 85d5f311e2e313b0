"""Limb-axis (tensor-parallel) sharding of ciphertext RNS planes.

Port of `fhe_sorting_tpu/parallel/limb_parallel.py`.  Each rank of a
mesh's "limb" axis owns RNS rows by their global index, the same at every
level (`mesh.LimbLayout`: Q limb i and special prime j on rank i, j mod R),
and holds only those rows: of every ciphertext (`LimbSharded`, its rows in
ascending global order) and of every key-switch key (`Keys.rows`).  Most of
the op surface is limb-local, since every limb plane is computed on its
own: add, sub and negate, products by a plaintext or a scalar, the ct*ct
tensor product, the Galois permutation, `combo`'s per-limb matmul, and the
NTTs inside them.  Those run on the rank's rows with no communication.  The
ops that mix limbs communicate where the JAX package's GSPMD partition
does, and nowhere else:

  * ModUp          - each rank takes its own rows of the input to
                     coefficients (INTT); one all-gather of the digit
                     coefficient planes [Ll, n]; each rank then multiplies
                     every gathered row by its dhat_inv and extends every
                     digit into its own target rows only (the rows of
                     `dig_ext`: the base extension is exact row by row), in
                     one call of `core/rns_bconv.py`, and NTTs them;
  * inner product  - local, against the rank's rows of the key;
  * ModDown        - INTT of the rank's special rows; one all-gather of the
                     special coefficient planes [..., K, n]; x phat_inv and
                     the extension into its own active rows (one call), the
                     NTT, the subtraction and x P^-1;
  * rescale        - for each dropped limb in turn, its owner INTTs it and
                     broadcasts the [2, 1, n] coefficient plane; every rank
                     finishes its own rows.

A key switch so moves Ll*n + 2*K*n residues and each rank transforms about
1/R of its planes (`comm`, `ntt_planes`); a plaintext is encoded whole (the
plain evaluator's memo) and each rank reads its rows of it, as GSPMD
reshards a whole plaintext.  The hoisted rotations share one distributed
ModUp, kept sharded over target rows; `adjust_level` is a local product and
a distributed rescale; `_drop_limbs` and `level_reduce` are local.  Only
`gather` joins a whole ciphertext, at a sort's exit.

Collectives: under NCCL they run on the card and a stage's CUDA graph
(`parallel/whole_graph.py`) captures them with its kernels.  Gloo ranks may
share one card (`mesh.init_world(..., device=...)`), since NCCL refuses two
ranks on one GPU; gloo moves the CUDA tensors through host memory itself.
A CUDA graph cannot capture a gloo collective, so such an evaluator is not
`capturable` and a stage on graphs raises (`whole_graph.use_graphs`).

Composes with the batch axis: on a ("batch", "limb") mesh,
`ShardedDirectSort` shards batches over one axis and limbs over the other.
"""

from __future__ import annotations

import math
from collections import Counter
from dataclasses import dataclass

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..core.cipher import Ciphertext, Plaintext
from ..core.evaluator import Evaluator
from ..core.context import cyclic
from .mesh import LimbLayout, axis_size


@dataclass(frozen=True)
class LimbSharded(Ciphertext):
    """A ciphertext whose `data` holds this rank's limb rows (`limb_spec`),
    in ascending global order; level, sdeg and slots are the whole
    ciphertext's."""


def limb_spec(mesh: DeviceMesh, limbs: int, axis: str = "limb") -> range:
    """This rank's rows among `limbs` limb planes along `axis`: plane i on
    rank i mod the axis size (`core/context.cyclic`, as `mesh.LimbLayout`)."""
    return cyclic(limbs, axis_size(mesh, axis), mesh.get_local_rank(axis))


def shard_limbs(ct: Ciphertext, mesh: DeviceMesh, axis: str = "limb") -> LimbSharded:
    """This rank's rows of a whole ciphertext's limbs."""
    rows = limb_spec(mesh, ct.num_limbs, axis)
    data = ct.data[:, rows.start::rows.step].contiguous()
    return LimbSharded(data, ct.level, ct.sdeg, ct.slots)


def is_limb_sharded(ct: Ciphertext) -> bool:
    return isinstance(ct, LimbSharded)


def gather_limbs(x: torch.Tensor, limbs: int, mesh: DeviceMesh,
                 axis: str = "limb") -> torch.Tensor:
    """All-gather the rows [..., own, n] each rank holds (`limb_spec`) of a
    `limbs`-row tensor into the whole [..., limbs, n], in global order
    (each rank's rows padded to one count for the collective)."""
    parts = axis_size(mesh, axis)
    m = -(-limbs // parts)
    if x.shape[-2] != m:
        pad = x.new_zeros(*x.shape[:-2], m, x.shape[-1])
        pad[..., :x.shape[-2], :] = x
        x = pad
    x = x.contiguous()
    got = [torch.empty_like(x) for _ in range(parts)]
    dist.all_gather(got, x, group=mesh.get_group(axis))
    # rank r's k-th row is global row k*parts + r
    whole = torch.stack(got).movedim(0, -2)
    return whole.reshape(*x.shape[:-2], m * parts, x.shape[-1])[..., :limbs, :]


def broadcast_limb(x: torch.Tensor, owner: int, mesh: DeviceMesh,
                   axis: str = "limb") -> torch.Tensor:
    """`owner`'s tensor `x` on every rank of `axis` (the others pass a
    buffer of its shape)."""
    group = mesh.get_group(axis)
    x = x.contiguous()
    dist.broadcast(x, src=dist.get_global_rank(group, owner), group=group)
    return x


class LimbParallelEvaluator(Evaluator):
    """`Evaluator` over limb-sharded operands, computing only this rank's
    rows (the module docstring).

    Its keys are `ev.keys`, which must hold this rank's rows
    (`Keys.from_numpy(..., rows=layout.key_rows())`; a whole key set on a
    one-rank limb axis).  The op counters, the frozen section and the
    plaintext memo are `ev`'s.  A whole ciphertext enters through `ingest`
    and leaves through `gather`.  `comm` counts the residues gathered and
    broadcast, `ntt_planes` the limb planes this rank's key switches and
    rescales transform."""

    def __init__(self, ev: Evaluator, mesh: DeviceMesh, axis: str = "limb"):
        self.ev = ev
        self.mesh = mesh
        self.axis = axis
        self.ctx, self.keys = ctx, keys = ev.ctx, ev.keys
        self.layout = LimbLayout.of(ctx, mesh, axis)
        self.limb_part = (self.layout.parts, self.layout.index)
        held = keys.rows or tuple(range(ctx.num_q + ctx.num_sp))
        assert held == self.layout.key_rows(), (
            "the key set must hold this limb rank's rows: "
            "Keys.from_numpy(..., rows=LimbLayout.of(ctx, mesh).key_rows())")
        # a rank's rows are strided views, and the affine path's tables are
        # selected by whole limb sets: the gather (as the sharded classes
        # of the JAX package keep it)
        self.use_affine = False
        self.ntt_planes: Counter = Counter()
        self.comm: Counter = Counter()
        # every level's rows and index sets now: none may be made inside a
        # frozen section (a CUDA graph capture)
        for level in range(ctx.params.mult_depth + 1):
            ctx.ks_rows(level, *self.limb_part)
        for drop in range(ctx.params.comp * ctx.params.mult_depth):
            ctx.rescale_rows(drop, *self.limb_part)
        for limb in range(ctx.num_q):
            ctx.limbs_range(limb, limb + 1)

    def __getattr__(self, name):
        # the plain evaluator's state (pt_stats, the memos, ...)
        if name == "ev":
            raise AttributeError(name)
        return getattr(self.ev, name)

    # The op counter and a frozen section are the plain evaluator's, so a
    # stage (`parallel/whole_graph.py`) that swaps the counter or freezes
    # this evaluator counts, and records the reads of, these ops too.

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

    @property
    def capturable(self) -> bool:
        """Whether a CUDA graph can capture this evaluator's collectives
        (NCCL's can, gloo's cannot)."""
        return dist.get_backend(self.mesh.get_group(self.axis)) == "nccl"

    # -- placement -----------------------------------------------------------

    def ingest(self, ct: Ciphertext) -> LimbSharded:
        return shard_limbs(ct, self.mesh, self.axis)

    def gather(self, ct: Ciphertext) -> Ciphertext:
        """The whole ciphertext of a `LimbSharded` (others pass through)."""
        if not is_limb_sharded(ct):
            return ct
        data = self._gather_rows(ct.data, self.ctx.limbs_at(ct.level))
        return Ciphertext(data, ct.level, ct.sdeg, ct.slots)

    # -- this rank's rows ------------------------------------------------------

    def _own(self, x: torch.Tensor, dim: int = -2) -> torch.Tensor:
        return self.layout.take(x, dim)

    def _primes(self, level: int) -> torch.Tensor:
        return self.ctx.ks_rows(level, *self.limb_part).p_active

    def _rows_at(self, level: int) -> int:
        return self.ctx.ks_rows(level, *self.limb_part).n_active

    def moduli(self, a: Ciphertext) -> torch.Tensor:
        assert is_limb_sharded(a), "a whole ciphertext on the limb-parallel evaluator: ingest it"
        return self._primes(a.level)

    def make_plaintext(self, *args, **kw) -> Plaintext:
        return self.ev.make_plaintext(*args, **kw)

    # A rank may own no row of a set (more ranks than limbs at a deep level):
    # its transform of no plane launches nothing.

    def _ntt(self, x, limbs, what: str = "other"):
        return x if x.shape[-2] == 0 else super()._ntt(x, limbs, what)

    def _intt(self, x, limbs, what: str = "other"):
        return x if x.shape[-2] == 0 else super()._intt(x, limbs, what)

    # -- the collectives: the hooks of the key switch and the rescale ----------

    def _gather_rows(self, y: torch.Tensor, limbs: int) -> torch.Tensor:
        self.comm["gathered"] += math.prod(y.shape[:-2]) * limbs * y.shape[-1]
        self.comm["collectives"] += 1
        return gather_limbs(y, limbs, self.mesh, self.axis)

    def _drop_limb(self, data: torch.Tensor, limb: int):
        """The owner of the dropped limb takes it to coefficients and
        broadcasts them; the others receive them and keep all their rows."""
        owner = self.layout.owner(limb)
        if owner == self.layout.index:
            x = self._intt(data[:, -1:], self.ctx.limbs_range(limb, limb + 1), "rescale")
            data = data[:, :-1]
        else:
            x = data.new_empty(data.shape[0], 1, data.shape[-1])
        self.comm["broadcast"] += x.numel()
        self.comm["collectives"] += 1
        return broadcast_limb(x, owner, self.mesh, self.axis), data
