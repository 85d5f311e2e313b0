"""Multi-process runs of the sharded sorts over a torch.distributed world.

    python -m fhe_sorting_tpu_torch.utils.multichip --ranks 8 [--backend nccl|gloo]

`spawn(fn, world, args, backend)` starts `world` processes, joins them into
one process group through a `file://` store in a fresh temporary directory
(no network) and calls `fn(rank, world, *args)` in each.  The caller
chooses the backend: "nccl" puts rank r on `cuda:r` and raises where the
machine has fewer than `world` GPUs; "gloo" runs every rank on the CPU.
Each rank builds its own context on its own device.

`dryrun_multichip(n)` is the port's counterpart of the JAX package's
`__graft_entry__.dryrun_multichip`, at the same shapes: ShardedDirectSort
N=16 at ring 64 over num_batch=8; the same sort on a 2D (n/2 x 2) mesh
with its limbs sharded (n >= 4); ShardedMehp24 over 4 parts of sub-length 2
at depth 33 (fewer parts below 4 ranks).  Rank 0 prints each step's error,
and every step asserts the 0.01 contract.

The rank functions `run_sharded_direct`, `run_sharded_mehp24` and
`run_limb_parallel` take numpy arrays (keys and ciphertexts made
elsewhere, for example by the JAX package) and write each rank's result to
`{out}{rank}.npz`.
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


def _rank_main(rank: int, world: int, backend: str, init_file: str, fn, args):
    from ..parallel.mesh import init_world

    # a rank that dies in native code (an abort in the backend) prints the
    # Python stack of every thread to stderr before it goes
    faulthandler.enable(all_threads=True)
    if backend == "gloo":
        torch.set_num_threads(1)
    init_world(backend, rank, world, init_file)
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


def spawn(fn, world: int, args: tuple, backend: str) -> None:
    """fn(rank, world, *args) in `world` processes of one process group
    under `backend` ("nccl" or "gloo"); raises where a rank fails."""
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend {backend!r}: expected 'nccl' or 'gloo'")
    if backend == "nccl" and torch.cuda.device_count() < world:
        raise RuntimeError(f"nccl over {world} ranks needs {world} GPUs; "
                           f"this machine has {torch.cuda.device_count()}")
    with tempfile.TemporaryDirectory(prefix="fhe_world_") as tmp:
        mp.spawn(_rank_main, args=(world, backend, os.path.join(tmp, "init"), fn, args),
                 nprocs=world, join=True)


def _device(rank: int) -> str:
    return f"cuda:{rank}" if dist.get_backend() == "nccl" else "cpu"


def _env(params, keys_np: dict, rank: int):
    from ..core.context import Context
    from ..core.evaluator import Evaluator
    from ..core.keys import Keys

    ctx = Context(params, device=_device(rank))
    keys = Keys.from_numpy(ctx, **keys_np)
    return ctx, keys, Evaluator(ctx, keys)


def run_sharded_direct(rank: int, world: int, params, keys_np: dict, ct_np: tuple, N: int,
                       cfg: tuple, mesh_shape: tuple, out: str) -> None:
    """ShardedDirectSort of the ciphertext `ct_np` = (data, level, sdeg,
    slots) on the keys `keys_np` (`Keys.from_numpy`'s arguments, the offset
    keys among the rotation keys) over a mesh of `mesh_shape`: (world,)
    or (n_batch, n_limb), the limbs then sharded."""
    from ..core.cipher import Ciphertext
    from ..ops.sign import CompositeSignConfig, SignConfig
    from ..parallel.direct_sharded import ShardedDirectSort
    from ..parallel.limb_parallel import LimbParallelEvaluator
    from ..parallel.mesh import make_mesh, make_mesh_2d

    ctx, _, ev = _env(params, keys_np, rank)
    if len(mesh_shape) == 1:
        mesh = make_mesh()
    else:
        mesh = make_mesh_2d(*mesh_shape)
        ev = LimbParallelEvaluator(ev, mesh)
    got = ShardedDirectSort(ev, N, SignConfig(CompositeSignConfig(*cfg)), mesh=mesh)(
        Ciphertext.from_numpy(*ct_np, ctx.device))
    np.savez(f"{out}{rank}.npz", data=got.data.cpu().numpy(),
             meta=np.array([got.level, got.sdeg, got.slots]))


def run_sharded_mehp24(rank: int, world: int, params, keys_np: dict, parts_np: list,
                       sub: int, cfg: tuple, out: str) -> None:
    """ShardedMehp24 of the parts `parts_np` (each (data, level, sdeg,
    slots)) with (dg_c, df_c, dg_i, df_i) = `cfg` over the world; writes
    the sorted parts stacked."""
    from ..core.cipher import Ciphertext
    from ..parallel.mehp24_sharded import ShardedMehp24

    ctx, _, ev = _env(params, keys_np, rank)
    parts = [Ciphertext.from_numpy(*p, ctx.device) for p in parts_np]
    got = ShardedMehp24(ev, sub, len(parts), *cfg)(parts)
    np.savez(f"{out}{rank}.npz", data=np.stack([c.data.cpu().numpy() for c in got]),
             meta=np.array([got[0].level, got[0].sdeg, got[0].slots]))


def run_limb_parallel(rank: int, world: int, params, keys_np: dict, cts_np: list,
                      out: str) -> None:
    """Four limb-parallel cases against the plain evaluator on the same
    ciphertexts, each written as (sharded result gathered, plain result):
    mult + rescale, rotate by 1, add (with this rank's block and whether it
    stayed sharded), and a (world x 1) mesh's stack of ciphertexts, each
    rank multiplying its own block of the stack."""
    from ..core.cipher import Ciphertext
    from ..parallel.limb_parallel import LimbParallelEvaluator, is_limb_sharded
    from ..parallel.mesh import batch_sharding, make_mesh, make_mesh_2d

    ctx, _, ev = _env(params, keys_np, rank)
    cts = [Ciphertext.from_numpy(*c, ctx.device) for c in cts_np]
    lp = LimbParallelEvaluator(ev, make_mesh(axis="limb"))
    res = {}
    sh = lp.ingest(cts[0])
    res["mult_rescale"] = (lp.gather(lp.rescale(lp.mult(sh, sh))).data,
                           ev.rescale(ev.mult(cts[0], cts[0])).data)
    res["rotate"] = (lp.gather(lp.rotate(lp.ingest(cts[1]), 1)).data, ev.rotate(cts[1], 1).data)
    sh = lp.ingest(cts[2])
    added, ref = lp.add(sh, sh), ev.add(cts[2], cts[2])
    res["add"] = (lp.gather(added).data, ref.data)
    res["add_block"] = (added.data, lp.ingest(ref).data)
    stayed = is_limb_sharded(added)
    # a (world x 1) mesh: the stack's leading axis over "batch", limbs whole
    mesh2 = make_mesh_2d(world, 1)
    lp2 = LimbParallelEvaluator(ev, mesh2)
    mine = batch_sharding(mesh2, 4)
    res["stack"] = (torch.stack([lp2.gather(lp2.mult(lp2.ingest(cts[3]), lp2.ingest(cts[3]))).data
                                 for _ in mine]),
                    torch.stack([ev.mult(cts[3], cts[3]).data for _ in mine]))
    np.savez(f"{out}{rank}.npz", stayed_sharded=np.array(stayed),
             **{f"{k}_got": g.cpu().numpy() for k, (g, _) in res.items()},
             **{f"{k}_ref": r.cpu().numpy() for k, (_, r) in res.items()})


def _dryrun_rank(rank: int, world: int) -> None:
    import time

    from ..core.context import CkksParams, Context
    from ..core.evaluator import Evaluator
    from ..core.keys import Keys
    from ..models.mehp24.utils import rotation_indices_mehp24
    from ..ops.sign import CompositeSignConfig, SignConfig
    from ..parallel.direct_sharded import ShardedDirectSort, rotation_indices_sharded
    from ..parallel.limb_parallel import LimbParallelEvaluator
    from ..parallel.mehp24_sharded import ShardedMehp24
    from ..parallel.mesh import make_mesh, make_mesh_2d
    from .depth_meter import measure_direct_sort_depth
    from .params_registry import mehp24_indicator_cfg

    say = print if rank == 0 else (lambda *a, **k: None)
    dev = _device(rank)

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
    srt = ShardedDirectSort(ev, N, cfg, mesh=make_mesh())
    t0 = time.time()
    out = srt(ct)
    err_ds = float(np.abs(keys.decrypt(out, N) - np.sort(vals)).max())
    say(f"dryrun DirectSort N={N} (num_batch={srt.nb} sharded over {world} ranks, "
        f"{dist.get_backend()}): err {err_ds:.4f}; sort {time.time() - t0:.2f}s", flush=True)
    assert err_ds < 0.01, f"DirectSort sorted error {err_ds} >= 0.01"

    # 1b. the same sort on a 2D ("batch", "limb") mesh, limbs sharded
    if world >= 4:
        mesh2d = make_mesh_2d(world // 2, 2)
        srt2 = ShardedDirectSort(LimbParallelEvaluator(ev, mesh2d), N, cfg, mesh=mesh2d)
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
                            dg_i=dg_i, df_i=df_i, mesh=make_mesh())
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


def dryrun_multichip(n: int, backend: str = "nccl") -> None:
    """The three sharded steps over `n` ranks (n in 1, 2, 4, 8: num_batch is
    8): one GPU a rank under "nccl", the CPU under "gloo"."""
    spawn(_dryrun_rank, n, (), backend)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ranks", type=int, default=8)
    ap.add_argument("--backend", choices=("nccl", "gloo"), default="nccl",
                    help="nccl: one GPU a rank (the default); gloo: the CPU")
    a = ap.parse_args()
    dryrun_multichip(a.ranks, a.backend)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
