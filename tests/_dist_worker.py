"""Multi-process worker: runs the dp and halo PFDR solvers across
process boundaries and checks them against the single-process solutions.

Spawned by ``tests/test_multihost.py`` as N processes with a local
coordinator; exercises exactly the code path a multi-host deployment uses
(``jax.distributed.initialize`` -> global mesh -> shard_map + collectives),
on the CPU backend with gloo collectives.

Usage: python -m tests._dist_worker <process_id> <num_processes> <port>
"""
import os
import sys


def main():
    pid, nproc, port = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    os.environ["JAX_PLATFORMS"] = "cpu"

    from cp_pfdr_graph_d1_tpu.parallel import (initialize_distributed,
                                               make_hybrid_mesh, make_mesh)
    initialize_distributed(coordinator_address=f"127.0.0.1:{port}",
                           num_processes=nproc, process_id=pid,
                           local_device_count=4)

    import jax
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import numpy as np
    from jax.experimental import multihost_utils

    import cp_pfdr_graph_d1_tpu as cp
    from cp_pfdr_graph_d1_tpu.parallel import (
        pfdr_quadratic_d1_halo, pfdr_quadratic_d1_sharded,
        shard_quadratic_problem, shard_stencil_problem)

    assert jax.process_count() == nproc, jax.process_count()
    n_dev = jax.device_count()
    assert n_dev == 4 * nproc, n_dev
    mesh = make_mesh()
    hybrid = make_hybrid_mesh()
    if nproc > 1:
        assert dict(hybrid.shape) == {"host": nproc, "dp": 4}, hybrid.shape

    # -- identical problem on every process --------------------------------
    r = np.random.default_rng(0)
    h = w = 16
    v, n = h * w, 24
    idx = np.arange(v).reshape(h, w)
    eu = np.concatenate([idx[:, :-1].ravel(),
                         idx[:-1, :].ravel()]).astype(np.int32)
    ev = np.concatenate([idx[:, 1:].ravel(),
                         idx[1:, :].ravel()]).astype(np.int32)
    a = (r.standard_normal((n, v)) / np.sqrt(n)).astype(np.float32)
    y = (a @ r.standard_normal(v) * 0.3).astype(np.float32)
    la_d1 = np.full(len(eu), 0.1, np.float32)
    la_l1 = np.full(v, 0.05, np.float32)
    lip = float(np.linalg.eigvalsh((a @ a.T).astype(np.float64))[-1])
    vprox = cp.VertexProx(kind="l1", positivity=True)
    opt = cp.PFDROptions(rho=1.4, dif_tol=0.0, it_max=60)

    # single-device truth, computed locally on each process
    graph = cp.GraphD1.create(eu, ev, la_d1, num_vertices=v)
    ref = cp.pfdr_quadratic_d1(
        cp.DenseOp(jnp.asarray(a)), jnp.asarray(y), graph,
        la_l1=jnp.asarray(la_l1), vprox=vprox, lipsch=lip, opt=opt)
    x_ref = np.asarray(ref.x)

    # -- dp solver across processes ----------------------------------------
    prob = shard_quadratic_problem(a, y, eu, ev, la_d1, n_dev)
    res = pfdr_quadratic_d1_sharded(prob, mesh, la_l1=la_l1, vprox=vprox,
                                    lipsch=lip, opt=opt)
    x_dp = np.asarray(multihost_utils.process_allgather(
        res.x, tiled=True)).reshape(-1)[:v]
    err_dp = float(np.max(np.abs(x_dp - x_ref)))

    # -- halo (vertex-sharded) solver across processes ---------------------
    sgraph = cp.StencilGraphD1.create((h, w), {(0, 1): 0.1, (1, 0): 0.1},
                                      dtype=jnp.float32)
    sref = cp.pfdr_quadratic_d1(
        cp.DenseOp(jnp.asarray(a)), jnp.asarray(y), sgraph,
        la_l1=jnp.asarray(la_l1), vprox=vprox, lipsch=lip, opt=opt)
    hprob = shard_stencil_problem(a, y, sgraph, n_dev)
    hres = pfdr_quadratic_d1_halo(hprob, mesh, la_l1=la_l1, vprox=vprox,
                                  lipsch=lip, opt=opt)
    x_halo = np.asarray(multihost_utils.process_allgather(
        hres.x, tiled=True)).reshape(-1)[:v]
    err_halo = float(np.max(np.abs(x_halo - np.asarray(sref.x))))

    tol = 1e-5  # f32; collective reduction order differs from local sums
    print(f"[{pid}] dp_err={err_dp:.3g} halo_err={err_halo:.3g}",
          flush=True)
    assert err_dp <= tol, f"dp mismatch {err_dp}"
    assert err_halo <= tol, f"halo mismatch {err_halo}"

    # -- distributed cut-pursuit (outer loop) across processes -------------
    # the host-replicated bookkeeping (cuts,
    # components, merges) must agree bit-identically ACROSS PROCESSES —
    # divergent cuts would deadlock/diverge the collectives — and the
    # solution must match the single-process solver to f32 tolerance
    from cp_pfdr_graph_d1_tpu.parallel import (cp_loss_d1_simplex_dist,
                                               cp_quadratic_d1_dist)
    from cp_pfdr_graph_d1_tpu.solvers.cut_pursuit import cp_quadratic_d1
    from cp_pfdr_graph_d1_tpu.solvers.cut_pursuit_simplex import \
        cp_loss_d1_simplex
    copt = cp.CPOptions(dif_tol=1e-5, it_max=6, host_small="off",
                        pfdr=cp.PFDROptions(rho=1.4, dif_tol=1e-6,
                                            it_max=600))
    ref_cp = cp_quadratic_d1(cp.DenseOp(jnp.asarray(a)), jnp.asarray(y),
                             graph, la_l1=la_l1, opt=copt)
    dres = cp_quadratic_d1_dist(cp.DenseOp(a), y, graph, mesh,
                                la_l1=la_l1, opt=copt)
    cv_all = np.asarray(multihost_utils.process_allgather(
        jnp.asarray(dres.cv), tiled=False))
    assert all(np.array_equal(cv_all[k], cv_all[0])
               for k in range(cv_all.shape[0])), "cv diverged across procs"
    x_dist = np.asarray(dres.rx)[np.asarray(dres.cv)]
    x_cp_ref = np.asarray(ref_cp.rx)[np.asarray(ref_cp.cv)]
    err_cp = float(np.max(np.abs(x_dist - x_cp_ref)))
    print(f"[{pid}] cp_dist_err={err_cp:.3g}", flush=True)
    assert err_cp <= 5e-4, f"cp_dist mismatch {err_cp}"

    # -- distributed multi-label cut-pursuit -------------------------------
    k = 3
    q = np.abs(r.standard_normal((v, k))).astype(np.float32)
    q /= q.sum(axis=1, keepdims=True)
    mlg = cp.GraphD1.create(eu, ev, np.full(len(eu), 0.15, np.float32),
                            num_vertices=v)
    sopt = cp.CPOptions(dif_tol=0.5, it_max=4,
                        pfdr=cp.PFDROptions(rho=1.2, dif_tol=1e-4,
                                            it_max=300))
    ref_ml = cp_loss_d1_simplex(mlg, jnp.asarray(q), al=1.0, opt=sopt)
    dml = cp_loss_d1_simplex_dist(mlg, q, mesh, al=1.0, opt=sopt)
    cv_ml = np.asarray(multihost_utils.process_allgather(
        jnp.asarray(dml.cv), tiled=False))
    assert all(np.array_equal(cv_ml[k_], cv_ml[0])
               for k_ in range(cv_ml.shape[0])), "ml cv diverged"
    p_dist = np.asarray(dml.rp)[np.asarray(dml.cv)]
    p_ref = np.asarray(ref_ml.rp)[np.asarray(ref_ml.cv)]
    err_ml = float(np.max(np.abs(p_dist - p_ref)))
    print(f"[{pid}] ml_dist_err={err_ml:.3g}", flush=True)
    assert err_ml <= 1e-3, f"ml_dist mismatch {err_ml}"

    # -- sharded-graph DEVICE cut-pursuit across processes -----------------
    # (the r04 capstone, now process-spanning): O(E) cut/contraction state
    # sharded over the 2x4 global mesh, label/triple fetches via
    # process_allgather, replicated host combinatorics — cv must agree
    # bit-identically across processes and the solution must match the
    # single-device device-cut solver
    from cp_pfdr_graph_d1_tpu.parallel import cp_quadratic_d1_sharded
    side = 64
    r2 = np.random.default_rng(5)
    xt = np.zeros((side, side), np.float32)
    xt[8:24, 8:24] = 1.0
    xt[40:56, 24:56] = -0.6
    y2 = (xt + 0.12 * r2.standard_normal((side, side))
          ).astype(np.float32).ravel()
    sg2 = cp.StencilGraphD1.create((side, side),
                                   {(0, 1): 0.3, (1, 0): 0.3},
                                   dtype=jnp.float32)
    skw = dict(dif_tol=1e-4, it_max=4,
               pfdr=cp.PFDROptions(rho=1.8, dif_tol=1e-6, it_max=2000),
               cut_tol=1e-6, cut_it_max=100_000, inexact="off")
    res_sh = cp_quadratic_d1_sharded(y2, sg2, mesh,
                                     opt=cp.CPOptions(**skw))
    res_1d = cp_quadratic_d1(
        cp.IdentityOp(), jnp.asarray(y2), sg2,
        opt=cp.CPOptions(**skw, cut="device"))
    cv_sh = np.asarray(multihost_utils.process_allgather(
        jnp.asarray(res_sh.cv), tiled=False))
    assert all(np.array_equal(cv_sh[k_], cv_sh[0])
               for k_ in range(cv_sh.shape[0])), "sharded cv diverged"
    x_sh = res_sh.rx[res_sh.cv]
    x_1d = np.asarray(res_1d.rx)[np.asarray(res_1d.cv)]

    def tv_obj(x):
        x = np.asarray(x, np.float64)
        d = x - y2.astype(np.float64)
        xg = x.reshape(side, side)
        return (0.5 * d @ d
                + np.sum(0.3 * np.abs(xg[:, 1:] - xg[:, :-1]))
                + np.sum(0.3 * np.abs(xg[1:, :] - xg[:-1, :])))

    err_sh = abs(tv_obj(x_sh) - tv_obj(x_1d)) / max(tv_obj(x_1d), 1e-12)
    print(f"[{pid}] cp_sharded_obj_rel={err_sh:.3g}", flush=True)
    assert err_sh <= 1e-3, f"cp_sharded objective mismatch {err_sh}"
    print(f"[{pid}] MULTIHOST_OK", flush=True)


if __name__ == "__main__":
    main()
