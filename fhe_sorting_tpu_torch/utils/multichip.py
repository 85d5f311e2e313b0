"""Multi-process runs of the sharded sorts over a torch.distributed world.

    python -m fhe_sorting_tpu_torch.utils.multichip --ranks 8 [--backend nccl|gloo] [--eager]

`spawn(fn, world, args, backend, device)` starts `world` processes, joins
them into one process group through a `file://` store in a fresh temporary
directory (no network) and calls `fn(rank, world, *args)` in each.  The
caller chooses the backend: "nccl" puts rank r on `cuda:r` and raises where
the machine has fewer than `world` GPUs; "gloo" runs every rank on
`device`, the CPU by default or one card that the gloo ranks share (NCCL
refuses two ranks on one GPU).  Each rank builds its own context on its
device (`mesh.world_device`).

`dryrun_multichip(n)` is the port's counterpart of the JAX package's
`__graft_entry__.dryrun_multichip`, at the same shapes: ShardedDirectSort
N=16 at ring 64 over num_batch=8; the same sort on a 2D (n/2 x 2) mesh
with its limbs distributed over two limb ranks (n >= 4), each holding its
rows of every key; ShardedMehp24 over 4 parts of sub-length 2
at depth 33 (fewer parts below 4 ranks).  Rank 0 prints each step's error,
and every step asserts the 0.01 contract.  Under "nccl" the sorts run each
rank's stages on CUDA graphs (`--eager`: eagerly); under "gloo" eagerly.

The rank functions `run_sharded_direct`, `run_sharded_mehp24` and
`run_limb_parallel` take numpy arrays (keys and ciphertexts made
elsewhere, for example by the JAX package) and `graphs` (as the sorts
take it), and write each rank's result to `{out}{rank}.npz`; a limb rank
uploads only its rows of the keys.  `run_limb_sort` is the card's entry:
the sharded DirectSort on a (1 x R) mesh, its keys made on each rank from
a seed, row by row.
"""

from __future__ import annotations

import argparse
import faulthandler
import os
import sys
import tempfile

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def _rank_main(rank: int, world: int, backend: str, init_file: str, device, fn, args):
    from ..parallel.mesh import init_world

    # a rank that dies in native code (an abort in the backend) prints the
    # Python stack of every thread to stderr before it goes
    faulthandler.enable(all_threads=True)
    if backend == "gloo":
        torch.set_num_threads(1)
    init_world(backend, rank, world, init_file, device)
    try:
        fn(rank, world, *args)
    finally:
        dist.destroy_process_group()
    # The rank's work is done and written.  Leave without the interpreter's
    # teardown: under load a gloo rank aborted in it ("terminate called
    # without an active exception", no Python frame left) after its results
    # were on disk, failing a spawn whose every rank had succeeded.
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(0)


def spawn(fn, world: int, args: tuple, backend: str, device: str | None = None) -> None:
    """fn(rank, world, *args) in `world` processes of one process group
    under `backend` ("nccl" or "gloo"), gloo ranks on `device` (None: the
    CPU); raises where a rank fails."""
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend {backend!r}: expected 'nccl' or 'gloo'")
    if backend == "nccl" and torch.cuda.device_count() < world:
        raise RuntimeError(f"nccl over {world} ranks needs {world} GPUs; "
                           f"this machine has {torch.cuda.device_count()}")
    with tempfile.TemporaryDirectory(prefix="fhe_world_") as tmp:
        mp.spawn(_rank_main,
                 args=(world, backend, os.path.join(tmp, "init"), device, fn, args),
                 nprocs=world, join=True)


def _env(params, keys_np: dict, mesh=None):
    """(ctx, keys, evaluator) on this rank's device from `keys_np`; with a
    `mesh` that has a "limb" axis, the keys hold this rank's rows only (all
    of them on a one-rank axis) and the evaluator is limb-parallel."""
    from ..core.context import Context
    from ..core.evaluator import Evaluator
    from ..core.keys import Keys
    from ..parallel.limb_parallel import LimbParallelEvaluator
    from ..parallel.mesh import LimbLayout, world_device

    ctx = Context(params, device=world_device())
    limb = mesh is not None and "limb" in mesh.mesh_dim_names
    rows = LimbLayout.of(ctx, mesh).key_rows() if limb else None
    keys = Keys.from_numpy(ctx, **keys_np, rows=rows)
    ev = Evaluator(ctx, keys)
    return ctx, keys, LimbParallelEvaluator(ev, mesh) if limb else ev


def run_sharded_direct(rank: int, world: int, params, keys_np: dict, ct_np: tuple, N: int,
                       cfg: tuple, mesh_shape: tuple, out: str, graphs: bool | None = None) -> None:
    """ShardedDirectSort of the ciphertext `ct_np` = (data, level, sdeg,
    slots) on the keys `keys_np` (`Keys.from_numpy`'s arguments, the offset
    keys among the rotation keys) over a mesh of `mesh_shape`: (world,)
    or (n_batch, n_limb), the limbs then distributed over the limb ranks.
    A rank takes from `keys_np` only the offset keys of its own batches,
    and on a limb axis only its rows of every key, as a deployment hands
    each rank its share; it writes its offset keys (`off_kb`, `off_ka`, by
    batch in `off_batches`), the galois elements it holds (`held`), its key
    rows (`key_rows`, all where None) and the key bytes it holds beside its
    result."""
    from ..core.cipher import Ciphertext
    from ..ops.sign import CompositeSignConfig, SignConfig
    from ..parallel.direct_sharded import ShardedDirectSort
    from ..parallel.mesh import batch_sharding, make_mesh, make_mesh_2d

    mesh = make_mesh() if len(mesh_shape) == 1 else make_mesh_2d(*mesh_shape)
    P = min(N, (params.ring_n // 2) // N)
    own = batch_sharding(mesh, N // P)
    # the galois elements of the other ranks' offsets (`Context.galois_element_rot`)
    others = {pow(5, (b * P) % (params.ring_n // 2), 2 * params.ring_n)
              for b in range(N // P) if b not in own}
    ctx, keys, ev = _env(params, {**keys_np, "rot": {g: k for g, k in keys_np["rot"].items()
                                                     if g not in others}}, mesh)
    srt = ShardedDirectSort(ev, N, SignConfig(CompositeSignConfig(*cfg)), mesh=mesh,
                            graphs=graphs)
    got = srt(Ciphertext.from_numpy(*ct_np, ctx.device))
    np.savez(f"{out}{rank}.npz", data=got.data.cpu().numpy(),
             meta=np.array([got.level, got.sdeg, got.slots]),
             held=np.array(sorted(keys.rot)), off_batches=np.array(list(own)),
             off_kb=np.stack([srt.off_keys[b].kb.cpu().numpy() for b in own]),
             off_ka=np.stack([srt.off_keys[b].ka.cpu().numpy() for b in own]),
             key_rows=np.array(keys.rows if keys.rows is not None else []),
             key_bytes=np.array(keys.key_bytes()))


def run_sharded_mehp24(rank: int, world: int, params, keys_np: dict, parts_np: list,
                       sub: int, cfg: tuple, out: str, graphs: bool | None = None) -> None:
    """ShardedMehp24 of the parts `parts_np` (each (data, level, sdeg,
    slots)) with (dg_c, df_c, dg_i, df_i) = `cfg` over the world; writes
    the sorted parts stacked."""
    from ..core.cipher import Ciphertext
    from ..parallel.mehp24_sharded import ShardedMehp24

    ctx, _, ev = _env(params, keys_np)
    parts = [Ciphertext.from_numpy(*p, ctx.device) for p in parts_np]
    got = ShardedMehp24(ev, sub, len(parts), *cfg, graphs=graphs)(parts)
    np.savez(f"{out}{rank}.npz", data=np.stack([c.data.cpu().numpy() for c in got]),
             meta=np.array([got[0].level, got[0].sdeg, got[0].slots]))


def run_limb_parallel(rank: int, world: int, params, keys_np: dict, cts_np: list,
                      out: str, graphs: bool | None = None, comp2: tuple | None = None) -> None:
    """Limb-parallel cases over a `world`-rank "limb" axis against the plain
    evaluator on the same ciphertexts (four of them, at level 0, sdeg 1),
    each written as (limb-parallel result gathered, plain result): mult +
    rescale, rotate by 1, add (with this rank's rows and whether it stayed
    sharded), square, conjugate, `adjust_level` by two levels, three hoisted
    rotations over one precompute, `combo` of three ciphertexts at two
    (level, sdeg), a (world x 1) mesh's stack of ciphertexts, each rank
    multiplying its own share of the stack, and mult + rescale + rotate as
    one stage (`parallel/whole_graph.py`: a CUDA graph where `graphs`
    allows, eager on the CPU), called twice, the second time inside the
    evaluator's frozen section; with the stage's op tally and the plain
    ops' count, and whether the frozen call recorded the relinearisation
    key (an eager call does; a replay runs no op).  `comp2` = (params,
    keys_np, ct_np) of a chain with two primes a level: mult + rescale
    there too.  Also written: the rank's key rows and key bytes against the
    whole key set's, the planes its plain NTT transformed in one ModUp, the
    residues one key switch gathers and one rescale broadcasts, and what a
    stage table on graphs by default raised (nothing where the evaluator's
    collectives can be captured or the context is on the CPU)."""
    from collections import Counter

    from ..core import bf_ntt
    from ..core.cipher import Ciphertext
    from ..core.evaluator import Evaluator
    from ..core.keys import Keys
    from ..parallel.limb_parallel import LimbParallelEvaluator, is_limb_sharded
    from ..parallel.mesh import LimbLayout, batch_sharding, make_mesh, make_mesh_2d
    from ..parallel.whole_graph import StageTable

    mesh = make_mesh(axis="limb")

    def evaluators(prm, kn):
        """The plain evaluator on the whole keys, and the limb-parallel one
        on this rank's rows of them."""
        ctx, keys, ev = _env(prm, kn)
        rkeys = Keys.from_numpy(ctx, **kn, rows=LimbLayout.of(ctx, mesh).key_rows())
        return ctx, keys, ev, LimbParallelEvaluator(Evaluator(ctx, rkeys), mesh)

    ctx, keys, ev, lp = evaluators(params, keys_np)
    cts = [Ciphertext.from_numpy(*c, ctx.device) for c in cts_np]
    sh = [lp.ingest(c) for c in cts]
    res = {}

    def case(name, got, ref):
        if isinstance(got, list):
            res[name] = (torch.stack([lp.gather(c).data for c in got]),
                         torch.stack([c.data for c in ref]))
        else:
            res[name] = (lp.gather(got).data, ref.data)

    case("mult_rescale", lp.rescale(lp.mult(sh[0], sh[0])), ev.rescale(ev.mult(cts[0], cts[0])))
    case("rotate", lp.rotate(sh[1], 1), ev.rotate(cts[1], 1))
    added, ref = lp.add(sh[2], sh[2]), ev.add(cts[2], cts[2])
    case("add", added, ref)
    res["add_block"] = (added.data, lp.ingest(ref).data)
    stayed = is_limb_sharded(added)
    case("square", lp.square(sh[0]), ev.square(cts[0]))
    case("conjugate", lp.conjugate(sh[1]), ev.conjugate(cts[1]))
    case("adjust_level", lp.adjust_level(sh[2], 2), ev.adjust_level(cts[2], 2))
    # one ModUp, the planes counted where the plain NTT runs
    planes = []
    real = bf_ntt.butterfly_plain
    bf_ntt.butterfly_plain = lambda x, t, limbs, inv: (
        planes.append((int(inv), x.shape[0] * x.shape[1])) or real(x, t, limbs, inv))
    try:
        pre = lp.rotate_precompute(sh[0])
    finally:
        bf_ntt.butterfly_plain = real
    pre_ref = ev.rotate_precompute(cts[0])
    case("hoisted", [lp.rotate_hoisted(sh[0], pre, r) for r in (1, 2, 4)],
         [ev.rotate_hoisted(cts[0], pre_ref, r) for r in (1, 2, 4)])
    rows, consts = [[0.5, -0.25, 1.0], [1.5, 0.75, -2.0]], [0.125, 0.0]
    case("combo", lp.combo([sh[0], lp.mult(sh[1], sh[1]), sh[2]], rows, consts),
         ev.combo([cts[0], ev.mult(cts[1], cts[1]), cts[2]], rows, consts))
    # what one key switch (a relinearisation) and one rescale communicate
    before = Counter(lp.comm)
    x = lp.mult(sh[3], sh[3])
    ks_comm = lp.comm - before
    before = Counter(lp.comm)
    lp.rescale(x)
    rescale_comm = lp.comm - before
    # a (world x 1) mesh: the stack's leading axis over "batch", limbs whole
    mesh2 = make_mesh_2d(world, 1)
    lp2 = LimbParallelEvaluator(ev, mesh2)
    mine = batch_sharding(mesh2, 4)
    res["stack"] = (torch.stack([lp2.gather(lp2.mult(lp2.ingest(cts[3]), lp2.ingest(cts[3]))).data
                                 for _ in mine]),
                    torch.stack([ev.mult(cts[3], cts[3]).data for _ in mine]))
    try:
        StageTable(lp, None)
        refused = ""
    except ValueError as e:
        refused = str(e)
    # the ops as a stage, their collectives inside it
    table = StageTable(lp, graphs, "limb")

    def limb_ops(c):
        return lp.gather(lp.rotate(lp.rescale(lp.mult(c[0], c[0])), 1))

    staged = table.run("limb", limb_ops, [lp.ingest(cts[0])])
    with lp.frozen() as reads:          # on a CUDA context, a replay
        again = table.run("limb", limb_ops, [lp.ingest(cts[0])])
    before = Counter(ev.op_stats)
    plain = ev.rotate(ev.rescale(ev.mult(cts[0], cts[0])), 1)
    res["staged"] = (staged.data, plain.data)
    res["staged_again"] = (again.data, plain.data)
    if comp2 is not None:
        ctx2, _, ev2, lp2c = evaluators(*comp2[:2])
        c = Ciphertext.from_numpy(*comp2[2], ctx2.device)
        s2 = lp2c.ingest(c)
        res["comp2_mult_rescale"] = (lp2c.gather(lp2c.rescale(lp2c.mult(s2, s2))).data,
                                     ev2.rescale(ev2.mult(c, c)).data)
    np.savez(f"{out}{rank}.npz", stayed_sharded=np.array(stayed),
             stage_ops=np.array(repr(sorted(table["limb"].op_counts.items()))),
             plain_ops=np.array(repr(sorted((ev.op_stats - before).items()))),
             frozen_read_relin=np.array(any(r is lp.keys.relin for r in reads)),
             key_rows=np.array(lp.keys.rows), relin_rows=np.array(lp.keys.relin.kb.shape[1]),
             key_bytes=np.array(lp.keys.key_bytes()), whole_key_bytes=np.array(keys.key_bytes()),
             modup_planes=np.array(planes), graphs_refused=np.array(refused),
             ks_gathered=np.array(ks_comm["gathered"]), ks_broadcast=np.array(ks_comm["broadcast"]),
             rescale_gathered=np.array(rescale_comm["gathered"]),
             rescale_broadcast=np.array(rescale_comm["broadcast"]),
             **{f"{k}_got": g.cpu().numpy() for k, (g, _) in res.items()},
             **{f"{k}_ref": r.cpu().numpy() for k, (_, r) in res.items()})


def run_limb_sort(rank: int, world: int, N: int, out: str, ring: int = 1 << 17) -> None:
    """The sharded DirectSort of N values on a (1 x world) ("batch", "limb")
    mesh of this world's ranks, eagerly (`chip_smoke.py` phase 17 runs it
    on gloo ranks that share one card), on the N=128 sort's chain
    (`profile_sort.sort_context(N, "staged", "butterfly")`: ring 2^17, scale
    2^56 from prime pairs, dnum 3, the butterfly NTT; a smaller `ring` for a
    rehearsal on the CPU, which reckons and measures no memory).  Each rank makes its
    rows of the keys from seed 0, row by row (`Keys.rows`), so every world
    size computes with the same keys, and encrypts its input with
    seed 1; it reckons its memory (`hbm_budget.check_phase`, the ranks
    reckoned together on the card), then sorts once, the kernels' launch
    counter (`cuda_build.counts()`) set to 0 just before and read just
    after.  Writes `{out}{rank}.npz`: the gathered output planes and
    metadata, the sort's seconds, its launches as JSON `{kernel: count}`
    (`k1` to `k4`), the error (rank 0), the key bytes held, the limb
    planes its key switches and rescales transformed (`ntt_planes`) and its
    plaintext encodes, the residues gathered and broadcast, its peak and
    its reckoning."""
    import json
    import time

    from ..core import cuda_build
    from ..core import ntt as nttm
    from ..core.evaluator import Evaluator
    from ..core.keys import Keys
    from ..parallel.direct_sharded import ShardedDirectSort, rotation_indices_sharded
    from ..parallel.limb_parallel import LimbParallelEvaluator
    from ..parallel.mesh import LimbLayout, make_mesh_2d, world_device
    from . import hbm_budget
    from .profile_sort import sort_context

    dev = world_device()
    card = dev.type == "cuda"
    mesh = make_mesh_2d(1, world)
    ctx, cfg, depth = sort_context(N, "staged", "butterfly", ring=ring, device=dev)
    steps = sorted(rotation_indices_sharded(N, ring))
    nb = N // min(N, (ring // 2) // N)
    report = {}
    if card:
        # the keys (rotations and the batches' offsets) and the input, the
        # rank, its index difference and a batch sum
        report = hbm_budget.check_phase(ctx, len(steps) + nb, 4,
                                        work_cts=hbm_budget.WORK_CTS["direct_sharded"],
                                        limb_ranks=world,
                                        label=f"sharded DirectSort N={N} on (1 x {world})")
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.time()
    keys = Keys.generate(ctx, seed=0, rows=LimbLayout.of(ctx, mesh).key_rows())
    keys.gen_rotation_keys(steps)
    lp = LimbParallelEvaluator(Evaluator(ctx, keys), mesh)
    srt = ShardedDirectSort(lp, N, cfg, mesh=mesh, graphs=False)
    nttm.synchronize(dev)
    setup_s = time.time() - t0
    vals = np.random.default_rng(0).permutation(N) / N + 0.5 / N
    ct = keys.encrypt(vals, slots=N, seed=1)
    cuda_build.reset()
    t0 = time.time()
    got = srt(ct)
    nttm.synchronize(dev)
    sort_s = time.time() - t0
    launches = json.dumps(cuda_build.counts())
    err = float(np.abs(keys.decrypt(got, N) - np.sort(vals)).max()) if rank == 0 else -1.0
    np.savez(f"{out}{rank}.npz", data=got.data.cpu().numpy(),
             meta=np.array([got.level, got.sdeg, got.slots]), depth=np.array(depth),
             num_q=np.array(ctx.num_q), num_sp=np.array(ctx.num_sp),
             setup_s=np.array(setup_s), sort_s=np.array(sort_s), launches=np.array(launches),
             err=np.array(err), key_bytes=np.array(keys.key_bytes()),
             n_keys=np.array(len(keys.rot) + 1),
             ks_planes=np.array([lp.ntt_planes[k] for k in ("modup", "moddown", "rescale")]),
             pt_planes=np.array(lp.ev.ntt_planes["plaintext"]),
             gathered=np.array(lp.comm["gathered"]), broadcast=np.array(lp.comm["broadcast"]),
             collectives=np.array(lp.comm["collectives"]),
             peak_gib=np.array(torch.cuda.max_memory_allocated(dev) / 2**30 if card else 0.0),
             report=np.array(json.dumps(report)))


def _dryrun_rank(rank: int, world: int, graphs: bool | None = None) -> None:
    import time

    from ..core.context import CkksParams, Context
    from ..core.evaluator import Evaluator
    from ..core.keys import Keys
    from ..models.mehp24.utils import rotation_indices_mehp24
    from ..ops.sign import CompositeSignConfig, SignConfig
    from ..parallel.direct_sharded import ShardedDirectSort, rotation_indices_sharded
    from ..parallel.limb_parallel import LimbParallelEvaluator
    from ..parallel.mehp24_sharded import ShardedMehp24
    from ..parallel.mesh import LimbLayout, make_mesh, make_mesh_2d, world_device
    from .depth_meter import measure_direct_sort_depth
    from .params_registry import mehp24_indicator_cfg

    say = print if rank == 0 else (lambda *a, **k: None)
    dev = world_device()

    # 1. ShardedDirectSort, N=16 over num_batch=8 at ring 64 (the geometry
    # of N=1024 at ring 2^17 at the smallest ring that fills 8 ranks)
    N, ring = 16, 64
    cfg = SignConfig(CompositeSignConfig(3, 3, 2))
    depth = measure_direct_sort_depth(N, ring, cfg)["mult_depth"] + 1
    ctx = Context(CkksParams(ring_n=ring, mult_depth=depth), device=dev)
    keys = Keys.generate(ctx, seed=0)
    keys.gen_rotation_keys(sorted(rotation_indices_sharded(N, ring)))
    ev = Evaluator(ctx, keys)
    rng = np.random.default_rng(0)
    vals = rng.permutation(N) / N + 0.5 / N
    # one encryption on every rank (a seeded one): the ranks hold one
    # ciphertext, as the JAX package's single controller does
    ct = keys.encrypt(vals, seed=1)
    srt = ShardedDirectSort(ev, N, cfg, mesh=make_mesh(), graphs=graphs)
    t0 = time.time()
    out = srt(ct)
    err_ds = float(np.abs(keys.decrypt(out, N) - np.sort(vals)).max())
    say(f"dryrun DirectSort N={N} (num_batch={srt.nb} sharded over {world} ranks, "
        f"{dist.get_backend()}): err {err_ds:.4f}; sort {time.time() - t0:.2f}s", flush=True)
    assert err_ds < 0.01, f"DirectSort sorted error {err_ds} >= 0.01"

    # 1b. the same sort on a 2D ("batch", "limb") mesh, the limbs distributed:
    # each rank makes and holds its rows of the keys (the same secret and
    # public key, so `ct` and `decrypt` serve both sorts)
    if world >= 4:
        mesh2d = make_mesh_2d(world // 2, 2)
        rkeys = Keys.generate(ctx, seed=0, rows=LimbLayout.of(ctx, mesh2d).key_rows())
        rkeys.gen_rotation_keys(sorted(rotation_indices_sharded(N, ring)))
        srt2 = ShardedDirectSort(LimbParallelEvaluator(Evaluator(ctx, rkeys), mesh2d), N, cfg,
                                 mesh=mesh2d, graphs=graphs)
        out2 = srt2(ct)
        err_2d = float(np.abs(keys.decrypt(out2, N) - np.sort(vals)).max())
        say(f"dryrun DirectSort N={N} on 2D mesh "
            f"{dict(zip(mesh2d.mesh_dim_names, mesh2d.shape))}: err {err_2d:.4f}", flush=True)
        assert err_2d < 0.01, f"2D-mesh sorted error {err_2d} >= 0.01"

    # 2. the MEHP24 triangle: 4 parts of 2x2 matrices, depth 33
    n_parts, sub = min(4, world), 2
    total = n_parts * sub
    dg_i, df_i = mehp24_indicator_cfg(total)
    ctx2 = Context(CkksParams(ring_n=ring, mult_depth=33), device=dev)
    keys2 = Keys.generate(ctx2, seed=0)
    keys2.gen_rotation_keys(sorted(rotation_indices_mehp24(sub) | {1 << i for i in range(7)}
                                   | {-(1 << i) for i in range(7)}))
    sharded = ShardedMehp24(Evaluator(ctx2, keys2), sub, n_parts, dg_c=2, df_c=2,
                            dg_i=dg_i, df_i=df_i, mesh=make_mesh(), graphs=graphs)
    vals_all = rng.permutation(total) / total + 0.5 / total
    parts = []
    for i in range(n_parts):
        v = np.zeros(sub * sub)
        v[:sub] = vals_all[i * sub:(i + 1) * sub]
        parts.append(keys2.encrypt(v, slots=sub * sub, seed=2 + i))
    out_parts = sharded(parts)
    assert len(out_parts) == n_parts
    got = np.concatenate([keys2.decrypt(p, sub) for p in out_parts])
    err_m = float(np.abs(got - np.sort(vals_all)).max())
    say(f"dryrun MEHP24 {total} elts (triangle over {world} ranks, dg_i={dg_i}, "
        f"df_i={df_i}): err {err_m:.4f}", flush=True)
    assert err_m < 0.01, f"MEHP24 sorted error {err_m} >= 0.01"
    say(f"dryrun_multichip({world}): sharded sort step OK on a mesh of {world} ranks; "
        f"sorted max err {max(err_ds, err_m):.4f}", flush=True)


def dryrun_multichip(n: int, backend: str = "nccl", graphs: bool | None = None) -> None:
    """The three sharded steps over `n` ranks (n in 1, 2, 4, 8: num_batch is
    8): one GPU a rank under "nccl", the CPU under "gloo".  The sorts run
    on CUDA graphs under "nccl" unless `graphs` is False, eagerly on the
    CPU."""
    spawn(_dryrun_rank, n, (graphs,), backend)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ranks", type=int, default=8)
    ap.add_argument("--backend", choices=("nccl", "gloo"), default="nccl",
                    help="nccl: one GPU a rank (the default); gloo: the CPU")
    ap.add_argument("--eager", action="store_true",
                    help="run the sorts eagerly on the card instead of on CUDA graphs")
    a = ap.parse_args()
    dryrun_multichip(a.ranks, a.backend, False if a.eager else None)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
