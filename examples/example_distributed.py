"""Multi-device example: fused LASSO solved three distributed ways.

The reference library is single-process OpenMP only; this example shows
the three distribution strategies this framework adds, on a fused-LASSO
problem shaped like the EEG workload (dense A with N << V, grid graph):

1. observation/edge-sharded PFDR (``parallel/dp.py``) — replicated
   iterate, two psums per iteration;
2. vertex-sharded halo-exchange PFDR on the stencil container
   (``parallel/halo.py``) — `ppermute` ring, the graph analog of context
   parallelism;
3. distributed cut-pursuit (``parallel/cp_dist.py``) — operator rows
   sharded over the mesh, collectives inserted by the SPMD partitioner,
   host combinatorics replicated;
4. sharded-graph DEVICE cut-pursuit (``parallel/cp_sharded.py``) — the
   PDHG cuts, pointer-jumping components and contraction themselves run
   with all O(E) state sharded into vertex row blocks, for graphs larger
   than one device's memory.

Runs on the accelerators it finds when there are at least two (for
example four GPUs of one host); with ``--cpu-mesh`` it runs on a virtual
8-device CPU mesh instead:

    python examples/example_distributed.py            # >= 2 GPUs
    python examples/example_distributed.py --cpu-mesh # any host
"""
import os
import sys

if __name__ == "__main__" and "--cpu-mesh" in sys.argv[1:]:
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + " --xla_force_host_platform_device_count=8"
                               ).strip()

import jax
import jax.numpy as jnp
import numpy as np

from cp_pfdr_graph_d1_tpu import (CPOptions, DenseOp, GraphD1, PFDROptions,
                                  VertexProx)
from cp_pfdr_graph_d1_tpu.parallel import (cp_quadratic_d1_dist, make_mesh,
                                           pfdr_quadratic_d1_halo,
                                           pfdr_quadratic_d1_sharded,
                                           shard_quadratic_problem,
                                           shard_stencil_problem)
from cp_pfdr_graph_d1_tpu.solvers.pfdr_quadratic import pfdr_quadratic_d1
from cp_pfdr_graph_d1_tpu.stencil import StencilGraphD1


def main():
    n_dev = min(8, jax.device_count())
    if n_dev < 2:
        raise SystemExit("needs at least 2 devices; pass --cpu-mesh to use "
                         "a virtual CPU mesh")
    mesh = make_mesh(n_dev)
    print(f"mesh: {n_dev} x {jax.devices()[0].platform}")

    # EEG-shaped problem: dense A (N=64 << V), 32x32 grid, blob ground truth
    h = w = 32
    v = h * w
    n = 64
    idx = np.arange(v).reshape(h, w)
    eu = np.concatenate([idx[:, :-1].ravel(),
                         idx[:-1, :].ravel()]).astype(np.int32)
    ev = np.concatenate([idx[:, 1:].ravel(),
                         idx[1:, :].ravel()]).astype(np.int32)
    r = np.random.default_rng(0)
    a = (r.standard_normal((n, v)) / np.sqrt(n)).astype(np.float32)
    x_true = np.zeros((h, w), np.float32)
    x_true[8:16, 8:16] = 1.5
    y = (a @ x_true.ravel() + 0.02 * r.standard_normal(n)).astype(np.float32)
    la_d1 = np.full(eu.shape, 0.1, np.float32)
    la_l1 = np.full(v, 0.05, np.float32)
    lip = float(np.linalg.svd(a, compute_uv=False)[0] ** 2)
    vprox = VertexProx(kind="l1", positivity=True)
    opt = PFDROptions(rho=1.5, dif_tol=1e-6, it_max=3000)

    # single-device reference solve
    base = pfdr_quadratic_d1(
        DenseOp(jnp.asarray(a)), jnp.asarray(y),
        GraphD1.create(eu, ev, la_d1), la_l1=jnp.asarray(la_l1),
        vprox=vprox, lipsch=lip, opt=opt)
    x_base = np.asarray(base.x)

    # 1. observation/edge-sharded PFDR
    prob = shard_quadratic_problem(a, y, eu, ev, la_d1, n_dev)
    res1 = pfdr_quadratic_d1_sharded(prob, mesh, la_l1=la_l1, vprox=vprox,
                                     lipsch=lip, opt=opt)
    err1 = float(np.max(np.abs(np.asarray(res1.x) - x_base)))
    print(f"1. edge/observation-sharded PFDR: it={int(res1.it)} "
          f"max|dx|={err1:.2e}")

    # 2. vertex-sharded halo-exchange PFDR (stencil container)
    sg = StencilGraphD1.create((h, w), {(0, 1): 0.1, (1, 0): 0.1})
    hprob = shard_stencil_problem(a, y, sg, n_dev)
    res2 = pfdr_quadratic_d1_halo(hprob, mesh, la_l1=la_l1, vprox=vprox,
                                  lipsch=lip, opt=opt)
    err2 = float(np.max(np.abs(np.asarray(res2.x) - x_base)))
    print(f"2. vertex-sharded halo PFDR:      it={int(res2.it)} "
          f"max|dx|={err2:.2e}")

    # 3. distributed cut-pursuit (operator rows sharded, GSPMD)
    copt = CPOptions(dif_tol=1e-5, it_max=10,
                     pfdr=PFDROptions(rho=1.5, dif_tol=1e-8, it_max=5000))
    res3 = cp_quadratic_d1_dist(
        DenseOp(jnp.asarray(a)), jnp.asarray(y),
        GraphD1.create(eu, ev, la_d1), mesh,
        la_l1=la_l1, positivity=True, opt=copt)
    x3 = np.asarray(res3.rx)[np.asarray(res3.cv)]
    sup = x3 > 0.5 * x3.max()
    tru = x_true.ravel() > 0
    dice = 2 * np.sum(sup & tru) / (sup.sum() + tru.sum())
    print(f"3. distributed cut-pursuit:       it={res3.it} "
          f"components={len(res3.rx)} support-Dice={dice:.3f}")

    # 4. sharded-graph device cut-pursuit (identity-operator TV denoising:
    # the whole-graph combinatorics run sharded, not just the operator)
    from cp_pfdr_graph_d1_tpu import IdentityOp
    from cp_pfdr_graph_d1_tpu.parallel import cp_quadratic_d1_sharded
    from cp_pfdr_graph_d1_tpu.solvers.cut_pursuit import cp_quadratic_d1

    y_img = (x_true + 0.1 * r.standard_normal((h, w))
             ).astype(np.float32).ravel()
    sg_tv = StencilGraphD1.create((h, w), {(0, 1): 0.3, (1, 0): 0.3})
    kw = dict(dif_tol=1e-4, it_max=4,
              pfdr=PFDROptions(rho=1.8, dif_tol=1e-6, it_max=1500),
              cut_tol=1e-6, cut_it_max=60_000, inexact="off")
    res4 = cp_quadratic_d1_sharded(y_img, sg_tv, mesh, opt=CPOptions(**kw))
    ref4 = cp_quadratic_d1(IdentityOp(), jnp.asarray(y_img), sg_tv,
                           opt=CPOptions(**kw, cut="device"))
    cv_match = bool(np.array_equal(np.asarray(res4.cv),
                                   np.asarray(ref4.cv)))
    print(f"4. sharded-graph device CP:       it={res4.it} "
          f"components={len(res4.rx)} cv==single-device: {cv_match}")

    assert err1 < 1e-5 and err2 < 1e-5 and dice > 0.9 and cv_match
    print("all distributed paths agree with the single-device solve")


if __name__ == "__main__":
    main()
