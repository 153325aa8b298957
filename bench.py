"""Benchmarks: PFDR/CP throughput vs the compiled reference C++ library.

Prints one JSON line per metric ``{"metric", "value", "unit",
"vs_baseline"}``; the HEADLINE metric (stencil-path PFDR TV edge-updates/s
on the EEG-scale fused LASSO) is printed LAST so a tail-parse lands on it.
Secondary metrics: unstructured-mesh PFDR through the circulant container,
multi-label (K=4) PFDR, and end-to-end cut-pursuit wall time.  A cell that
fails is reported and the script exits non-zero.

The problems mirror the reference's EEG example
(``/root/reference/octave/example_EEG_CP.m``: dense A with N=91
observations, V ~ 19.6k cortical-mesh vertices, ~2-3V edges; the bundled
EEG.mat is absent from the mount so the problems are regenerated
synthetically with the same structure).  ``vs_baseline`` is the speedup
against the reference C++/OpenMP solvers (compiled from the read-only
mount, run on this host's CPUs) on identical inputs.

Timing: every timed run materializes its result to host numpy (the
device finishes before the clock stops) and runs many iterations in one
jitted while_loop, so dispatch cost is a small share of the measurement.
Correctness is checked separately against the reference solver.
"""
import json
import os
import sys
import time
import traceback

import numpy as np

V_SIDE = 140                 # V = 19600 ~ EEG cortical mesh size
N_OBS = 91                   # EEG electrode count
ITERS = 400                  # solution-check run (matches reference run)
LA_D1 = 2e-3
LA_L1 = 2e-3


def _emit(metric, value, unit, vs):
    print(json.dumps({"metric": metric, "value": round(value, 1),
                      "unit": unit, "vs_baseline": round(vs, 3)}),
          flush=True)


def _oracle():
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from tests import _oracle as oracle
    return oracle


def _time_solve(solve, iters, repeats=3):
    solve(iters)  # compile + warm
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        solve(iters)
        best = min(best, time.perf_counter() - t0)
    return best / iters


def build_grid_problem(dtype=np.float32, seed=7, side=V_SIDE):
    h = w = side
    v = h * w
    idx = np.arange(v).reshape(h, w)
    eu = np.concatenate([idx[:, :-1].ravel(),
                         idx[:-1, :].ravel()]).astype(np.int32)
    ev = np.concatenate([idx[:, 1:].ravel(),
                         idx[1:, :].ravel()]).astype(np.int32)
    r = np.random.default_rng(seed)
    a = (r.standard_normal((N_OBS, v)) / np.sqrt(N_OBS)).astype(dtype)
    x_true = np.zeros(v, dtype)
    for _ in range(3):  # a few active sources, constant patches
        i, j = r.integers(10, h - 16, 2)
        x_true[idx[i:i + 6, j:j + 6].ravel()] = r.uniform(0.5, 2.0)
    y = (a @ x_true + 0.01 * r.standard_normal(N_OBS)).astype(dtype)
    la_d1 = np.full(eu.shape, LA_D1, dtype)
    la_l1 = np.full(v, LA_L1, dtype)
    return eu, ev, la_d1, a, y, la_l1


def build_mesh_problem(dtype=np.float32, seed=3, side=V_SIDE):
    """Unstructured Delaunay mesh, strip-ordered (the general-case graph)."""
    from scipy.spatial import Delaunay

    from cp_pfdr_graph_d1_tpu.circulant import strip_order
    v = side * side
    r = np.random.default_rng(seed)
    pts = r.random((v, 2))
    tri = Delaunay(pts)
    edges = set()
    for s in tri.simplices:
        for i in range(3):
            a_, b_ = int(s[i]), int(s[(i + 1) % 3])
            edges.add((min(a_, b_), max(a_, b_)))
    eu = np.fromiter((e[0] for e in edges), np.int32, len(edges))
    ev = np.fromiter((e[1] for e in edges), np.int32, len(edges))
    order = strip_order(pts)
    inv = np.empty(v, np.int64)
    inv[order] = np.arange(v)
    eu, ev = inv[eu].astype(np.int32), inv[ev].astype(np.int32)
    a = (r.standard_normal((N_OBS, v)) / np.sqrt(N_OBS)).astype(dtype)
    x_true = np.zeros(v, dtype)
    x_true[r.integers(0, v, max(v // 49, 1))] = 1.0
    y = (a @ x_true + 0.01 * r.standard_normal(N_OBS)).astype(dtype)
    la_d1 = np.full(eu.shape, LA_D1, dtype)
    la_l1 = np.full(v, LA_L1, dtype)
    return eu, ev, la_d1, a, y, la_l1


def build_labeling_problem(side=512, k=4, seed=17):
    """Four-quadrant K=4 labeling with 35% of the vertices' observations
    replaced by random distributions; returns q [side*side, K]."""
    v = side * side
    idx = np.arange(v).reshape(side, side)
    r = np.random.default_rng(seed)
    labels = (idx // (side // 2) % 2 * 2
              + (idx % side) // (side // 2) % 2).ravel()
    q = np.full((v, k), 0.05, np.float32)
    q[np.arange(v), labels] = 0.85
    flip = r.random(v) < 0.35
    q[flip] = r.dirichlet(np.full(k, 0.8),
                          size=int(flip.sum())).astype(np.float32)
    return q


def build_denoise_problem(side=724, seed=5):
    """Piecewise-constant image (12 random boxes) plus Gaussian noise;
    returns the flattened observation y."""
    r = np.random.default_rng(seed)
    x_true = np.zeros((side, side), np.float32)
    for _ in range(12):
        i, j = r.integers(20, side - 80, 2)
        h_, w_ = r.integers(24, 64, 2)
        x_true[i:i + h_, j:j + w_] = r.uniform(0.3, 1.5)
    return (x_true + 0.15 * r.standard_normal((side, side))
            ).astype(np.float32).ravel()


def _pfdr_solver(graph, a, y, la_l1, lip):
    import jax.numpy as jnp

    from cp_pfdr_graph_d1_tpu import (DenseOp, PFDROptions, VertexProx,
                                      pfdr_quadratic_d1)
    op = DenseOp(jnp.asarray(a))
    obs = jnp.asarray(y)
    l1 = jnp.asarray(la_l1)
    vprox = VertexProx(kind="l1", positivity=True)

    def solve(iters):
        opt = PFDROptions(rho=1.5, dif_tol=0.0, it_max=iters)
        res = pfdr_quadratic_d1(op, obs, graph, la_l1=l1, vprox=vprox,
                                lipsch=lip, opt=opt)
        return np.asarray(res.x)  # host materialization barrier

    return solve


def _ref_updates_per_s(oracle, eu, ev, la_d1, a, y, la_l1, lip):
    t0 = time.perf_counter()
    x, it, _, _ = oracle.pfdr_ql1(y, a, eu, ev, la_d1, la_l1, 1, L=lip,
                                  rho=1.5, difTol=0.0, itMax=ITERS)
    dt = time.perf_counter() - t0
    return len(eu) * it / dt, x


def bench_stencil(oracle):
    """Headline: gather-free stencil container on the grid problem."""
    import jax.numpy as jnp

    from cp_pfdr_graph_d1_tpu.stencil import StencilGraphD1
    eu, ev, la_d1, a, y, la_l1 = build_grid_problem()
    lip = float(np.linalg.eigvalsh((a @ a.T).astype(np.float64))[-1])
    graph = StencilGraphD1.create((V_SIDE, V_SIDE),
                                  {(0, 1): LA_D1, (1, 0): LA_D1},
                                  dtype=jnp.float32)
    solve = _pfdr_solver(graph, a, y, la_l1, lip)
    x_ours = solve(ITERS)
    t_iter = _time_solve(solve, 40000)
    ups = len(eu) / t_iter
    vs = 0.0
    if oracle is not None:
        ref_ups, x_ref = _ref_updates_per_s(oracle, eu, ev, la_d1, a, y,
                                            la_l1, lip)
        vs = ups / ref_ups
        err = np.max(np.abs(x_ours - x_ref)) / max(1e-12,
                                                   np.max(np.abs(x_ref)))
        if err > 0.05:
            print(f"WARNING: stencil solver mismatch rel={err:.3g}",
                  file=sys.stderr)
    return ("PFDR TV edge-updates/s (EEG-scale fused LASSO)", ups,
            "edge-updates/s", vs)


def bench_unstructured(oracle):
    """Unstructured COO mesh through the circulant shift-family container."""
    from cp_pfdr_graph_d1_tpu.circulant import CirculantGraphD1
    eu, ev, la_d1, a, y, la_l1 = build_mesh_problem()
    v = a.shape[1]
    lip = float(np.linalg.eigvalsh((a @ a.T).astype(np.float64))[-1])
    graph = CirculantGraphD1.create(eu, ev, la_d1, num_vertices=v)
    solve = _pfdr_solver(graph, a, y, la_l1, lip)
    x_ours = solve(ITERS)
    t_iter = _time_solve(solve, 20000)
    ups = len(eu) / t_iter
    vs = 0.0
    if oracle is not None:
        ref_ups, x_ref = _ref_updates_per_s(oracle, eu, ev, la_d1, a, y,
                                            la_l1, lip)
        vs = ups / ref_ups
        err = np.max(np.abs(x_ours - x_ref)) / max(1e-12,
                                                   np.max(np.abs(x_ref)))
        if err > 0.05:
            print(f"WARNING: circulant solver mismatch rel={err:.3g}",
                  file=sys.stderr)
    return ("PFDR TV edge-updates/s (unstructured Delaunay mesh, "
            "circulant container)", ups, "edge-updates/s", vs)


def bench_simplex(oracle):
    """Multi-label (K=4) PFDR on the grid stencil."""
    import jax.numpy as jnp

    from cp_pfdr_graph_d1_tpu import PFDROptions
    from cp_pfdr_graph_d1_tpu.solvers.pfdr_simplex import pfdr_loss_d1_simplex
    from cp_pfdr_graph_d1_tpu.stencil import StencilGraphD1
    k = 4
    eu, ev, la_d1, _, _, _ = build_grid_problem()
    v = V_SIDE * V_SIDE
    r = np.random.default_rng(11)
    q = r.dirichlet(np.full(k, 0.7), size=v).astype(np.float32)
    graph = StencilGraphD1.create((V_SIDE, V_SIDE),
                                  {(0, 1): 0.5, (1, 0): 0.5},
                                  dtype=jnp.float32)
    la_d1_ref = np.full(eu.shape, 0.5, np.float32)
    q_dev = jnp.asarray(q)

    def solve(iters):
        res = pfdr_loss_d1_simplex(
            graph, q_dev, al=1.0,
            opt=PFDROptions(rho=1.5, dif_tol=0.0, it_max=iters))
        return np.asarray(res.p)

    p_ours = solve(ITERS)
    t_iter = _time_solve(solve, 10000)
    ups = len(eu) / t_iter
    vs = 0.0
    if oracle is not None:
        t0 = time.perf_counter()
        p_ref, it = oracle.pfdr_simplex(q, 1.0, eu, ev, la_d1_ref,
                                        rho=1.5, difTol=0.0, itMax=ITERS)
        dt = time.perf_counter() - t0
        vs = ups / (len(eu) * it / dt)
        err = np.max(np.abs(p_ours - p_ref))
        if err > 0.05:
            print(f"WARNING: simplex solver mismatch abs={err:.3g}",
                  file=sys.stderr)
    return ("multi-label PFDR edge-updates/s (K=4 stencil)", ups,
            "edge-updates/s", vs)


def bench_unstructured_simplex(oracle):
    """Multi-label (K=4) PFDR on the unstructured Delaunay mesh through
    the circulant container."""
    import jax.numpy as jnp

    from cp_pfdr_graph_d1_tpu import PFDROptions
    from cp_pfdr_graph_d1_tpu.circulant import CirculantGraphD1
    from cp_pfdr_graph_d1_tpu.solvers.pfdr_simplex import pfdr_loss_d1_simplex
    k = 4
    eu, ev, la_d1, _, _, _ = build_mesh_problem()
    v = V_SIDE * V_SIDE
    r = np.random.default_rng(13)
    q = r.dirichlet(np.full(k, 0.7), size=v).astype(np.float32)
    la_ml = np.full(eu.shape, 0.5, np.float32)
    graph = CirculantGraphD1.create(eu, ev, la_ml, num_vertices=v)
    q_dev = jnp.asarray(q)

    def solve(iters):
        res = pfdr_loss_d1_simplex(
            graph, q_dev, al=1.0,
            opt=PFDROptions(rho=1.5, dif_tol=0.0, it_max=iters))
        return np.asarray(res.p)

    p_ours = solve(ITERS)
    t_iter = _time_solve(solve, 4000)
    ups = len(eu) / t_iter
    vs = 0.0
    if oracle is not None:
        t0 = time.perf_counter()
        p_ref, it = oracle.pfdr_simplex(q, 1.0, eu, ev, la_ml,
                                        rho=1.5, difTol=0.0, itMax=ITERS)
        dt = time.perf_counter() - t0
        vs = ups / (len(eu) * it / dt)
        err = np.max(np.abs(p_ours - p_ref))
        if err > 0.05:
            print(f"WARNING: unstructured simplex mismatch abs={err:.3g}",
                  file=sys.stderr)
    return ("multi-label PFDR edge-updates/s (K=4 unstructured Delaunay, "
            "circulant container)", ups, "edge-updates/s", vs)


def bench_cut_pursuit(oracle):
    """End-to-end cut-pursuit fused-LASSO solve, reference parameters,
    through the device-resident outer loop (PDHG cuts, device components
    and contraction)."""
    import jax.numpy as jnp

    from cp_pfdr_graph_d1_tpu import DenseOp
    from cp_pfdr_graph_d1_tpu.config import CPOptions, PFDROptions
    from cp_pfdr_graph_d1_tpu.solvers.cut_pursuit import cp_quadratic_d1
    from cp_pfdr_graph_d1_tpu.stencil import StencilGraphD1
    eu, ev, la_d1, a, y, la_l1 = build_grid_problem()
    graph = StencilGraphD1.create((V_SIDE, V_SIDE),
                                  {(0, 1): LA_D1, (1, 0): LA_D1},
                                  dtype=jnp.float32)
    op = DenseOp(jnp.asarray(a))
    obs = jnp.asarray(y)
    l1 = jnp.asarray(la_l1)
    opt = CPOptions(
        dif_tol=1e-4, it_max=15,
        pfdr=PFDROptions(rho=1.5, cond_min=1e-3, dif_rcd=0.0,
                         dif_tol=1e-7, it_max=10_000),
        cut="device", cut_tol=1e-6, cut_it_max=100_000)

    class _Out:
        pass

    def run():
        t0 = time.perf_counter()
        res = cp_quadratic_d1(op, obs, graph, la_l1=l1, positivity=True,
                              opt=opt)
        np.asarray(res.rx)  # host materialization
        out = _Out()
        out.Cv, out.rX = np.asarray(res.cv), np.asarray(res.rx)
        return time.perf_counter() - t0, out

    run()  # warm (compile + native build)
    t_ours, out = run()
    t2, _ = run()
    t_ours = min(t_ours, t2)
    vs = 0.0
    if oracle is not None:
        t0 = time.perf_counter()
        cv, rx, it, _ = oracle.cp_ql1(
            y, a, eu, ev, la_d1, la_l1, 1, CP_difTol=1e-4, CP_itMax=15,
            rho=1.5, condMin=1e-3, difRcd=0.0, difTol=1e-7, itMax=10_000)
        t_ref = time.perf_counter() - t0
        vs = t_ref / t_ours
        x_ref = rx[cv]
        x_ours = out.rX[out.Cv]

        # parity check on the OBJECTIVE, not pointwise values: cut-pursuit
        # can settle on different near-optimal partitions (a float32 run
        # can land a few % away pointwise with an equal or better
        # objective); the reference's own quality trace is Obj
        def objective(x):
            x = np.asarray(x, np.float64)
            r = a.astype(np.float64) @ x - y.astype(np.float64)
            tv = np.sum(la_d1.astype(np.float64) * np.abs(x[eu] - x[ev]))
            l1 = np.sum(la_l1.astype(np.float64) * np.abs(x))
            return 0.5 * r @ r + tv + l1

        f_ours, f_ref = objective(x_ours), objective(x_ref)
        if f_ours > f_ref * (1 + 1e-3):
            print(f"WARNING: cut-pursuit objective regression "
                  f"{f_ours:.6g} vs reference {f_ref:.6g}",
                  file=sys.stderr)
    return ("cut-pursuit EEG-scale fused LASSO end-to-end", t_ours * 1000,
            "ms", vs)


def bench_cut_pursuit_device(oracle):
    """Fully device-resident cut-pursuit (PDHG cuts + device contraction +
    staged reduced solves, cuts warm-started across CP iterations) on a
    524k-vertex grid TV denoising problem.  ``vs_baseline`` is the speedup
    over the reference C++ identity-mode cut-pursuit on the same inputs."""
    import jax.numpy as jnp

    from cp_pfdr_graph_d1_tpu import IdentityOp
    from cp_pfdr_graph_d1_tpu.config import CPOptions, PFDROptions
    from cp_pfdr_graph_d1_tpu.solvers.cut_pursuit import cp_quadratic_d1
    from cp_pfdr_graph_d1_tpu.stencil import StencilGraphD1

    side = 724  # V = 524k, E = 1.047M
    y = build_denoise_problem(side)
    graph = StencilGraphD1.create((side, side),
                                  {(0, 1): 0.35, (1, 0): 0.35},
                                  dtype=jnp.float32)
    op = IdentityOp()
    obs = np.asarray(y)
    pf = PFDROptions(rho=1.8, dif_tol=1e-5, it_max=2000)

    def run(cut):
        opt = CPOptions(dif_tol=1e-4, it_max=4, pfdr=pf, cut=cut,
                        cut_tol=1e-5, cut_it_max=50_000)
        t0 = time.perf_counter()
        res = cp_quadratic_d1(op, obs, graph, opt=opt)
        x = np.asarray(res.rx)[np.asarray(res.cv)]  # host materialization
        return time.perf_counter() - t0, x

    run("device")  # warm (compile)
    t_dev, x_dev = run("device")
    t_dev2, _ = run("device")
    t_dev = min(t_dev, t_dev2)

    def objective(x):
        x = np.asarray(x, np.float64)
        d = x - y.astype(np.float64)
        xg = x.reshape(side, side)
        tv = (np.sum(0.35 * np.abs(xg[:, 1:] - xg[:, :-1]))
              + np.sum(0.35 * np.abs(xg[1:, :] - xg[:-1, :])))
        return 0.5 * d @ d + tv

    vs = 0.0
    if oracle is not None:
        eu = np.asarray(graph.eu)
        ev = np.asarray(graph.ev)
        keep = np.asarray(graph.la_d1) > 0  # stencil containers pad edges
        t0 = time.perf_counter()
        cv, rx, _, _ = oracle.cp_ql1(
            y, None, eu[keep], ev[keep],
            np.asarray(graph.la_d1)[keep].astype(np.float64), None, 0,
            N=0, CP_difTol=1e-4, CP_itMax=4, rho=1.8, condMin=1e-3,
            difRcd=0.0, difTol=1e-5, itMax=2000)
        t_ref = time.perf_counter() - t0
        vs = t_ref / t_dev
        f_dev, f_ref = objective(x_dev), objective(rx[cv])
        if f_dev > f_ref * (1 + 1e-3):
            print(f"WARNING: device-CP objective regression {f_dev:.6g} "
                  f"vs reference {f_ref:.6g}", file=sys.stderr)
    return ("device-resident cut-pursuit, 524k-vertex grid TV "
            "(warm-started PDHG cuts)", t_dev * 1000, "ms", vs)


def bench_cut_pursuit_simplex(oracle):
    """End-to-end multi-label (K=4) cut-pursuit segmentation, 262k
    vertices with 35% label noise, through the device-resident loop
    (PDHG alpha-expansion cuts + device contraction), vs the reference
    ``CP_PFDR_graph_loss_d1_simplex`` on identical inputs."""
    import jax.numpy as jnp

    from cp_pfdr_graph_d1_tpu.config import CPOptions, PFDROptions
    from cp_pfdr_graph_d1_tpu.solvers.cut_pursuit_simplex import \
        cp_loss_d1_simplex
    from cp_pfdr_graph_d1_tpu.stencil import StencilGraphD1
    side = 512
    v = side * side
    idx = np.arange(v).reshape(side, side)
    eu = np.concatenate([idx[:, :-1].ravel(),
                         idx[:-1, :].ravel()]).astype(np.int32)
    ev = np.concatenate([idx[:, 1:].ravel(),
                         idx[1:, :].ravel()]).astype(np.int32)
    q = build_labeling_problem(side)
    la = 0.4
    graph = StencilGraphD1.create((side, side),
                                  {(0, 1): la, (1, 0): la},
                                  dtype=jnp.float32)
    q_dev = jnp.asarray(q)
    opt = CPOptions(dif_tol=1e-3, it_max=10,
                    pfdr=PFDROptions(rho=1.5, dif_tol=1e-6, it_max=3000),
                    cut="device", cut_tol=1e-5, cut_it_max=50_000)

    def run():
        t0 = time.perf_counter()
        res = cp_loss_d1_simplex(graph, q_dev, al=1.0, opt=opt)
        np.asarray(res.rp)
        return time.perf_counter() - t0, res

    run()
    t_ours, res = run()
    t2, res = run()
    t_ours = min(t_ours, t2)
    vs = 0.0
    if oracle is not None:
        t0 = time.perf_counter()
        cv_r, rp_r, _ = oracle.cp_simplex(
            q, 1.0, eu, ev, la, CP_difTol=1e-3, CP_itMax=10, rho=1.5,
            difTol=1e-6, itMax=3000)
        t_ref = time.perf_counter() - t0
        vs = t_ref / t_ours
        ml_ours = np.asarray(res.rp)[np.asarray(res.cv)].argmax(1)
        ml_ref = rp_r[cv_r].argmax(1)
        dis = float(np.mean(ml_ours != ml_ref))
        if dis > 0.02:
            print(f"WARNING: multi-label CP labeling mismatch {dis:.3%}",
                  file=sys.stderr)
    return ("multi-label cut-pursuit end-to-end (K=4, 262k vertices)",
            t_ours * 1000, "ms", vs)


def bench_cut_pursuit_bounds(oracle):
    """End-to-end bounds-family cut-pursuit (box [0, 1]) at EEG scale
    through the device-resident loop, vs the reference
    ``CP_PFDR_graph_quadratic_d1_bounds``."""
    import jax.numpy as jnp

    from cp_pfdr_graph_d1_tpu import DenseOp
    from cp_pfdr_graph_d1_tpu.config import CPOptions, PFDROptions
    from cp_pfdr_graph_d1_tpu.solvers.cut_pursuit import cp_quadratic_d1
    from cp_pfdr_graph_d1_tpu.stencil import StencilGraphD1
    eu, ev, la_d1, a, y, _ = build_grid_problem(seed=23)
    graph = StencilGraphD1.create((V_SIDE, V_SIDE),
                                  {(0, 1): LA_D1, (1, 0): LA_D1},
                                  dtype=jnp.float32)
    op = DenseOp(jnp.asarray(a))
    obs = jnp.asarray(y)
    opt = CPOptions(
        dif_tol=1e-4, it_max=15,
        pfdr=PFDROptions(rho=1.5, dif_tol=1e-7, it_max=10_000),
        cut="device", cut_tol=1e-6, cut_it_max=100_000)

    def run():
        t0 = time.perf_counter()
        res = cp_quadratic_d1(op, obs, graph, bounds=(0.0, 1.0), opt=opt)
        x = np.asarray(res.rx)[np.asarray(res.cv)]
        return time.perf_counter() - t0, x

    run()
    t_ours, x_ours = run()
    t2, x_ours = run()
    t_ours = min(t_ours, t2)
    vs = 0.0
    if oracle is not None:
        t0 = time.perf_counter()
        cv, rx, _ = oracle.cp_qbounds(
            y, a, eu, ev, la_d1, 0.0, 1.0, CP_difTol=1e-4, CP_itMax=15,
            rho=1.5, difTol=1e-7, itMax=10_000)
        t_ref = time.perf_counter() - t0
        vs = t_ref / t_ours

        def objective(x):
            x = np.asarray(x, np.float64)
            r = a.astype(np.float64) @ x - y.astype(np.float64)
            tv = np.sum(la_d1.astype(np.float64) * np.abs(x[eu] - x[ev]))
            return 0.5 * r @ r + tv

        f_ours, f_ref = objective(x_ours), objective(rx[cv])
        if f_ours > f_ref * (1 + 1e-3):
            print(f"WARNING: bounds cut-pursuit objective regression "
                  f"{f_ours:.6g} vs reference {f_ref:.6g}",
                  file=sys.stderr)
    return ("bounds cut-pursuit EEG-scale end-to-end (box [0,1])",
            t_ours * 1000, "ms", vs)


def main():
    from cp_pfdr_graph_d1_tpu.utils.compile_cache import enable_compile_cache
    enable_compile_cache()
    try:
        oracle = _oracle()
        if not oracle.available():
            oracle = None
    except Exception as ex:  # noqa: BLE001
        print(f"WARNING: reference baseline unavailable: {ex}",
              file=sys.stderr)
        oracle = None

    headline = None
    failed = []
    for fn, is_headline in ((bench_stencil, True),
                            (bench_unstructured, False),
                            (bench_simplex, False),
                            (bench_unstructured_simplex, False),
                            (bench_cut_pursuit, False),
                            (bench_cut_pursuit_bounds, False),
                            (bench_cut_pursuit_simplex, False),
                            (bench_cut_pursuit_device, False)):
        try:
            row = fn(oracle)
        except Exception:  # report, run the other cells, then fail
            traceback.print_exc()
            failed.append(fn.__name__)
            continue
        if is_headline:
            headline = row
        _emit(*row)
    if failed:
        raise SystemExit(f"bench cells failed: {', '.join(failed)}")
    _emit(*headline)  # printed last: tail-parse lands on the headline


if __name__ == "__main__":
    main()
