"""Smoke test of the solvers on NVIDIA GPUs, each phase checked against a
plain float64 reference.

    python chip_smoke.py           # one GPU: PFDR and cut-pursuit phases
    python chip_smoke.py --multi   # four GPUs: only the sharded paths

Every phase runs a public entry point at the size of a ``bench.py`` cell
and prints its wall time, iteration counts, and its error next to the
tolerance.  References:

* PFDR phases run a fixed 400 iterations against the in-repo float64 C++
  twins (``native.pfdr_quadratic_d1_host`` / ``_loss_d1_simplex_host``);
* cut-pursuit phases compare the objective (the multi-label phase: the
  maximum-likelihood labelling) with the exact host route — native
  push-relabel cuts plus native float64 reduced solves — run in float64
  by a child process with ``JAX_PLATFORMS=cpu``, so only this process
  opens the card;
* ``--multi`` compares each sharded solve on four cards with the same
  solve on one card (the distributed cut-pursuit by its objective).

The script exits non-zero, printing no result, when JAX finds no GPU or
any phase fails.  On success the last line of standard output is one JSON
object ``{"ok": true, "device": {"platform", "kind", "count"}}``.
"""
import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

# tolerances: float32 on the card vs float64 references (the bench's own
# acceptance thresholds)
PFDR_TOL = 1e-3         # max |x - x_ref| / max |x_ref| after 400 iterations
CP_OBJ_TOL = 1e-3       # objective <= (1 + tol) * reference objective
LABEL_TOL = 0.02        # share of vertices whose ML label differs
MULTI_TOL = 1e-5        # sharded vs one-card iterates, relative
PFDR_ITERS = 400
# sharded vs one-card float32 iterates drift apart by reduction order
# alone; 120 iterations (the CPU suite's halo check) keeps that drift
# below MULTI_TOL, where 400 does not on the virtual CPU mesh
HALO_ITERS = 120
REFERENCE_TIMEOUT = 900  # seconds for the CPU reference child

# the bench cells' parameters (bench.py)
CP_EEG = dict(dif_tol=1e-4, it_max=15, pfdr=dict(rho=1.5, dif_tol=1e-7,
                                                 it_max=10_000))
# the bounds problem is still moving after the bench's 15 CP iterations
# (relative evolution ~1e-3), so two routes' objectives there differ by
# their cut paths (+-3e-3 between two GPU runs); with room to converge
# (~25 iterations) they agree to ~1e-6
CP_BOUNDS = dict(CP_EEG, it_max=60)
CP_LABEL = dict(dif_tol=1e-3, it_max=10, pfdr=dict(rho=1.5, dif_tol=1e-6,
                                                   it_max=3000))
CP_DENOISE = dict(dif_tol=1e-4, it_max=4, pfdr=dict(rho=1.8, dif_tol=1e-5,
                                                    it_max=2000))
SIZES = dict(grid=140, label=512, denoise=724, sharded=(1024, 512))


def log(msg):
    print(msg, flush=True)


def cp_options(spec, **kw):
    from cp_pfdr_graph_d1_tpu import CPOptions, PFDROptions
    return CPOptions(dif_tol=spec["dif_tol"], it_max=spec["it_max"],
                     pfdr=PFDROptions(**spec["pfdr"]), **kw)


def grid_edges(side):
    idx = np.arange(side * side).reshape(side, side)
    eu = np.concatenate([idx[:, :-1].ravel(), idx[:-1, :].ravel()])
    ev = np.concatenate([idx[:, 1:].ravel(), idx[1:, :].ravel()])
    return eu.astype(np.int32), ev.astype(np.int32)


class Check:
    """Collects phase results; a failed phase fails the run at the end."""

    def __init__(self):
        self.failed = []

    def report(self, phase, err, tol, seconds, **counts):
        ok = bool(np.isfinite(err)) and err <= tol
        extra = " ".join(f"{k}={v}" for k, v in counts.items())
        log(f"[{'ok' if ok else 'FAIL'}] {phase}: err={err:.3e} "
            f"tol={tol:.0e} wall={seconds:.2f}s {extra}")
        if not ok:
            self.failed.append(phase)


def timed(fn):
    t0 = time.perf_counter()
    out = fn()
    return out, time.perf_counter() - t0


# ---------------------------------------------------------------------------
# problems (bench.py's cells, rebuilt from their seeds)
# ---------------------------------------------------------------------------

def eeg_problems(side):
    from bench import LA_D1, build_grid_problem, build_mesh_problem
    grid = build_grid_problem(side=side)
    mesh = build_mesh_problem(side=side)
    return LA_D1, grid, mesh


def quadratic_objective(x, a, y, eu, ev, la_d1, la_l1=None):
    x = np.asarray(x, np.float64)
    r = y.astype(np.float64) - (x if a is None else a.astype(np.float64) @ x)
    obj = 0.5 * r @ r + np.sum(np.asarray(la_d1, np.float64)
                               * np.abs(x[eu] - x[ev]))
    if la_l1 is not None:
        obj += np.sum(la_l1.astype(np.float64) * np.abs(x))
    return float(obj)


# ---------------------------------------------------------------------------
# CPU float64 reference child
# ---------------------------------------------------------------------------

def cpu_reference(outdir, sizes):
    """Exact host route (native min-cut + native f64 reduced solves) for
    every cut-pursuit phase; runs with JAX_PLATFORMS=cpu and x64."""
    import jax
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    from bench import (build_denoise_problem, build_grid_problem,
                       build_labeling_problem)
    from cp_pfdr_graph_d1_tpu import DenseOp, GraphD1, IdentityOp
    from cp_pfdr_graph_d1_tpu.solvers.cut_pursuit import cp_quadratic_d1
    from cp_pfdr_graph_d1_tpu.solvers.cut_pursuit_simplex import \
        cp_loss_d1_simplex

    la_d1, grid, _ = eeg_problems(sizes["grid"])
    out = {}

    def host(spec):
        return cp_options(spec, cut="host", host_small="on")

    eu, ev, la, a, y, la_l1 = grid
    g = GraphD1.create(eu, ev, la.astype(np.float64), dtype=jnp.float64)
    op = DenseOp(jnp.asarray(a, jnp.float64))
    t0 = time.perf_counter()
    r = cp_quadratic_d1(op, y.astype(np.float64), g,
                        la_l1=la_l1.astype(np.float64), positivity=True,
                        opt=host(CP_EEG))
    out["eeg"] = r.rx[r.cv]
    _, _, _, a2, y2, _ = build_grid_problem(seed=23, side=sizes["grid"])
    r = cp_quadratic_d1(DenseOp(jnp.asarray(a2, jnp.float64)),
                        y2.astype(np.float64), g, bounds=(0.0, 1.0),
                        opt=host(CP_BOUNDS))
    out["bounds"] = r.rx[r.cv]
    side = sizes["label"]
    eu, ev = grid_edges(side)
    q = build_labeling_problem(side).astype(np.float64)
    g = GraphD1.create(eu, ev, 0.4, dtype=jnp.float64)
    r = cp_loss_d1_simplex(g, jnp.asarray(q), al=1.0, opt=host(CP_LABEL))
    out["label"] = np.argmax(np.asarray(r.rp)[r.cv], axis=1)
    side = sizes["denoise"]
    eu, ev = grid_edges(side)
    y = build_denoise_problem(side).astype(np.float64)
    g = GraphD1.create(eu, ev, 0.35, dtype=jnp.float64)
    r = cp_quadratic_d1(IdentityOp(), y, g, opt=host(CP_DENOISE))
    out["denoise"] = r.rx[r.cv]
    out["seconds"] = np.asarray(time.perf_counter() - t0)
    np.savez(os.path.join(outdir, "reference.npz"), **out)


def start_reference(outdir, sizes):
    env = dict(os.environ, JAX_PLATFORMS="cpu", CUDA_VISIBLE_DEVICES="")
    with open(os.path.join(outdir, "reference.log"), "w") as out:
        return subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--cpu-reference",
             outdir, "--sizes", json.dumps(sizes)],
            env=env, stdout=out, stderr=subprocess.STDOUT)


def finish_reference(proc, outdir):
    proc.wait(timeout=REFERENCE_TIMEOUT)
    if proc.returncode != 0:
        with open(os.path.join(outdir, "reference.log")) as f:
            raise RuntimeError(f"CPU reference failed:\n{f.read()}")
    ref = dict(np.load(os.path.join(outdir, "reference.npz")))
    log(f"reference: exact host route (native push-relabel cuts + native "
        f"float64 reduced solves), float64, CPU child process, "
        f"{float(ref['seconds']):.1f}s")
    return ref


# ---------------------------------------------------------------------------
# single-card phases
# ---------------------------------------------------------------------------

def pfdr_phases(check, sizes):
    import jax.numpy as jnp

    from cp_pfdr_graph_d1_tpu import (DenseOp, GraphD1, PFDROptions,
                                      VertexProx, native,
                                      pfdr_loss_d1_simplex,
                                      pfdr_quadratic_d1)
    from cp_pfdr_graph_d1_tpu.circulant import CirculantGraphD1
    from cp_pfdr_graph_d1_tpu.stencil import StencilGraphD1

    side = sizes["grid"]
    v = side * side
    la_d1, grid, mesh = eeg_problems(side)
    opt = PFDROptions(rho=1.5, dif_tol=0.0, it_max=PFDR_ITERS)
    vprox = VertexProx(kind="l1", positivity=True)

    def stencil(la):
        return StencilGraphD1.create((side, side), {(0, 1): la, (1, 0): la},
                                     dtype=jnp.float32)

    def mesh_graphs(la):
        eu, ev = mesh[:2]
        la = np.broadcast_to(np.asarray(la, np.float32), eu.shape)
        return (("coo", GraphD1.create(eu, ev, la, num_vertices=v)),
                ("circulant", CirculantGraphD1.create(eu, ev, la,
                                                      num_vertices=v)))

    quadratic = (("grid", grid, (("stencil", stencil(la_d1)),)),
                 ("mesh", mesh, mesh_graphs(la_d1)))
    for name, (eu, ev, la, a, y, la_l1), graphs in quadratic:
        lip = float(np.linalg.eigvalsh((a @ a.T).astype(np.float64))[-1])
        (x_ref, it_ref), t_ref = timed(lambda: native.pfdr_quadratic_d1_host(
            a.shape[0], a, y, eu, ev, la, la_l1=la_l1, positivity=True,
            lip_scal=lip, rho=1.5, dif_tol=0.0, it_max=PFDR_ITERS))
        for cname, g in graphs:
            def run():
                r = pfdr_quadratic_d1(DenseOp(jnp.asarray(a)),
                                      jnp.asarray(y), g,
                                      la_l1=jnp.asarray(la_l1),
                                      vprox=vprox, lipsch=lip, opt=opt)
                return np.asarray(r.x), int(r.it)

            _, t_cold = timed(run)
            (x, it), t_warm = timed(run)
            err = np.max(np.abs(x - x_ref)) / np.max(np.abs(x_ref))
            check.report(f"pfdr-quadratic {name}/{cname}", err, PFDR_TOL,
                         t_warm, it=it, it_ref=it_ref,
                         us_per_it=f"{1e6 * t_warm / it:.1f}",
                         compile_s=f"{t_cold - t_warm:.1f}",
                         ref_s=f"{t_ref:.1f}")
            if it != it_ref:
                check.failed.append(f"pfdr-quadratic {name}/{cname} it")

    k = 4
    simplex = (("grid", grid[:2], 11, (("stencil", stencil(0.5)),)),
               ("mesh", mesh[:2], 13, mesh_graphs(0.5)))
    for name, (eu, ev), seed, graphs in simplex:
        q = np.random.default_rng(seed).dirichlet(
            np.full(k, 0.7), size=v).astype(np.float32)
        (p_ref, it_ref), t_ref = timed(
            lambda: native.pfdr_loss_d1_simplex_host(
                q, 1.0, eu, ev, 0.5, rho=1.5, dif_tol=0.0,
                it_max=PFDR_ITERS))
        for cname, g in graphs:
            def run():
                r = pfdr_loss_d1_simplex(g, jnp.asarray(q), al=1.0, opt=opt)
                return np.asarray(r.p), int(r.it)

            _, t_cold = timed(run)
            (p, it), t_warm = timed(run)
            err = np.max(np.abs(p - p_ref)) / np.max(np.abs(p_ref))
            check.report(f"pfdr-simplex K=4 {name}/{cname}", err, PFDR_TOL,
                         t_warm, it=it, it_ref=it_ref,
                         us_per_it=f"{1e6 * t_warm / it:.1f}",
                         compile_s=f"{t_cold - t_warm:.1f}",
                         ref_s=f"{t_ref:.1f}")
            if it != it_ref:
                check.failed.append(f"pfdr-simplex {name}/{cname} it")


def cp_phases(check, sizes, get_ref):
    import jax.numpy as jnp

    from bench import (build_denoise_problem, build_grid_problem,
                       build_labeling_problem)
    from cp_pfdr_graph_d1_tpu import DenseOp, IdentityOp, api
    from cp_pfdr_graph_d1_tpu.solvers.cut_pursuit import cp_quadratic_d1
    from cp_pfdr_graph_d1_tpu.solvers.cut_pursuit_simplex import \
        cp_loss_d1_simplex
    from cp_pfdr_graph_d1_tpu.stencil import StencilGraphD1

    side = sizes["grid"]
    la_d1, grid, _ = eeg_problems(side)
    eu, ev, la, a, y, la_l1 = grid
    graph = StencilGraphD1.create((side, side),
                                  {(0, 1): la_d1, (1, 0): la_d1},
                                  dtype=jnp.float32)
    results = {}

    # fused LASSO through the reference-parity API (host cut), and the
    # device-resident loop through the solver entry point
    def eeg_host():
        out = api.cp_quadratic_d1_l1(
            y, a, eu, ev, la, la_l1, positivity=True, CP_difTol=1e-4,
            CP_itMax=15, PFDR_rho=1.5, PFDR_difTol=1e-7, PFDR_itMax=10_000,
            graph=graph)
        return out.rX[out.Cv], out.it

    def eeg_device():
        r = cp_quadratic_d1(
            DenseOp(jnp.asarray(a)), jnp.asarray(y), graph, la_l1=la_l1,
            positivity=True, opt=cp_options(CP_EEG, cut="device",
                                            cut_tol=1e-6,
                                            cut_it_max=100_000))
        return r.rx[r.cv], r.it

    _, _, _, a2, y2, _ = build_grid_problem(seed=23, side=side)

    def bounds_device():
        r = cp_quadratic_d1(
            DenseOp(jnp.asarray(a2)), jnp.asarray(y2), graph,
            bounds=(0.0, 1.0), opt=cp_options(CP_BOUNDS, cut="device",
                                              cut_tol=1e-6,
                                              cut_it_max=100_000))
        return r.rx[r.cv], r.it

    for phase, fn in (("cp-eeg cut=host", eeg_host),
                      ("cp-eeg cut=device", eeg_device),
                      ("cp-bounds cut=device", bounds_device)):
        _, t_cold = timed(fn)
        (x, it), t_warm = timed(fn)
        results[phase] = (x, it, t_cold, t_warm)

    side_l = sizes["label"]
    q = build_labeling_problem(side_l)
    g_l = StencilGraphD1.create((side_l, side_l), {(0, 1): 0.4, (1, 0): 0.4},
                                dtype=jnp.float32)

    def label_device():
        r = cp_loss_d1_simplex(g_l, jnp.asarray(q), al=1.0,
                               opt=cp_options(CP_LABEL, cut="device",
                                              cut_tol=1e-5,
                                              cut_it_max=50_000))
        return np.argmax(np.asarray(r.rp)[r.cv], axis=1), r.it

    side_d = sizes["denoise"]
    y_d = build_denoise_problem(side_d)
    g_d = StencilGraphD1.create((side_d, side_d),
                                {(0, 1): 0.35, (1, 0): 0.35},
                                dtype=jnp.float32)

    def denoise_device():
        r = cp_quadratic_d1(IdentityOp(), y_d, g_d,
                            opt=cp_options(CP_DENOISE, cut="device",
                                           cut_tol=1e-5, cut_it_max=50_000))
        return r.rx[r.cv], r.it

    for phase, fn in (("cp-label K=4 cut=device", label_device),
                      ("cp-denoise cut=device", denoise_device)):
        out, t_cold = timed(fn)
        results[phase] = (*out, t_cold, None)

    ref = get_ref()
    for phase, key, obj in (
            ("cp-eeg cut=host", "eeg", lambda x: quadratic_objective(
                x, a, y, eu, ev, la, la_l1)),
            ("cp-eeg cut=device", "eeg", lambda x: quadratic_objective(
                x, a, y, eu, ev, la, la_l1)),
            ("cp-bounds cut=device", "bounds", lambda x: quadratic_objective(
                x, a2, y2, eu, ev, la))):
        x, it, t_cold, t_warm = results[phase]
        f, f_ref = obj(x), obj(ref[key])
        check.report(phase, max(f / f_ref - 1.0, 0.0), CP_OBJ_TOL, t_warm,
                     cp_it=it, obj=f"{f:.7g}", obj_ref=f"{f_ref:.7g}",
                     cold_s=f"{t_cold:.2f}")
    lab, it, t_cold, _ = results["cp-label K=4 cut=device"]
    check.report("cp-label K=4 cut=device",
                 float(np.mean(lab != ref["label"])), LABEL_TOL, t_cold,
                 cp_it=it, note="wall includes compile")
    x, it, t_cold, _ = results["cp-denoise cut=device"]
    eu_d, ev_d = grid_edges(side_d)
    f = quadratic_objective(x, None, y_d, eu_d, ev_d, 0.35)
    f_ref = quadratic_objective(ref["denoise"], None, y_d, eu_d, ev_d, 0.35)
    check.report("cp-denoise cut=device", max(f / f_ref - 1.0, 0.0),
                 CP_OBJ_TOL, t_cold, cp_it=it, obj=f"{f:.7g}",
                 obj_ref=f"{f_ref:.7g}", note="wall includes compile")


# ---------------------------------------------------------------------------
# four-card phases
# ---------------------------------------------------------------------------

def multi_phases(check, sizes, n_dev):
    import jax.numpy as jnp

    from bench import LA_D1, build_grid_problem
    from cp_pfdr_graph_d1_tpu import (CPOptions, DenseOp, GraphD1,
                                      PFDROptions, VertexProx,
                                      pfdr_loss_d1_simplex,
                                      pfdr_quadratic_d1)
    from cp_pfdr_graph_d1_tpu.parallel import (
        cp_loss_d1_simplex_sharded, cp_quadratic_d1_dist,
        cp_quadratic_d1_sharded, make_mesh, pfdr_loss_d1_simplex_halo,
        pfdr_quadratic_d1_halo, shard_stencil_problem,
        shard_stencil_simplex_problem)
    from cp_pfdr_graph_d1_tpu.solvers.cut_pursuit import cp_quadratic_d1
    from cp_pfdr_graph_d1_tpu.stencil import StencilGraphD1

    mesh_n, mesh_1 = make_mesh(n_dev), make_mesh(1)

    def rel(a, b):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-30))

    # sharded-graph device cut-pursuit on the >= 1M-edge grid
    hh, ww = sizes["sharded"]
    r = np.random.default_rng(8)
    xt = np.zeros((hh, ww), np.float32)
    xt[hh // 8:hh // 3, ww // 6:ww // 2] = 1.0
    y8 = (xt + 0.1 * r.standard_normal((hh, ww))).astype(np.float32).ravel()
    sg8 = StencilGraphD1.create((hh, ww), {(0, 1): 0.3, (1, 0): 0.3},
                                dtype=jnp.float32)
    opt = CPOptions(dif_tol=1e-4, it_max=4, inexact="off", cut_tol=1e-6,
                    cut_it_max=60_000,
                    pfdr=PFDROptions(rho=1.8, dif_tol=1e-5, it_max=2000))
    outs = {}
    for m in (mesh_n, mesh_1):
        outs[m.size], t = timed(lambda: cp_quadratic_d1_sharded(
            y8, sg8, m, opt=opt))
        outs[m.size, "t"] = t
    rn, r1 = outs[n_dev], outs[1]
    same_cv = np.array_equal(rn.cv, r1.cv)
    err = rel(rn.rx, r1.rx) if same_cv else np.inf
    check.report(f"sharded CP quadratic {hh}x{ww} ({n_dev} vs 1 card)",
                 err, MULTI_TOL, outs[n_dev, "t"], cv_identical=same_cv,
                 components=len(rn.rx), one_card_s=f"{outs[1, 't']:.2f}")

    k = 3
    lab = np.zeros((hh, ww), np.int64)
    lab[hh // 8:hh // 3, ww // 6:ww // 2] = 1
    lab[hh // 2:, ww // 2:] = 2
    q9 = np.full((hh * ww, k), 0.1 / (k - 1), np.float32)
    q9[np.arange(hh * ww), lab.ravel()] = 0.9
    q9 += 0.05 * r.random((hh * ww, k)).astype(np.float32)
    q9 /= q9.sum(axis=1, keepdims=True)
    opt_s = CPOptions(dif_tol=1.0, it_max=4, inexact="off", cut_tol=1e-6,
                      cut_it_max=60_000,
                      pfdr=PFDROptions(rho=1.5, dif_tol=1e-4, it_max=1000))
    for m in (mesh_n, mesh_1):
        outs[m.size], t = timed(lambda: cp_loss_d1_simplex_sharded(
            q9, sg8, m, al=0.5, opt=opt_s))
        outs[m.size, "t"] = t
    rn, r1 = outs[n_dev], outs[1]
    same_cv = np.array_equal(rn.cv, r1.cv)
    err = rel(rn.rp, r1.rp) if same_cv else np.inf
    check.report(f"sharded CP simplex K=3 {hh}x{ww} ({n_dev} vs 1 card)",
                 err, MULTI_TOL, outs[n_dev, "t"], cv_identical=same_cv,
                 components=len(rn.rp), one_card_s=f"{outs[1, 't']:.2f}")

    # halo PFDR: row-sharded iterate, ppermute boundary exchange
    side = sizes["grid"]
    eu, ev, la, a, y, la_l1 = build_grid_problem(side=side)
    sg = StencilGraphD1.create((side, side), {(0, 1): LA_D1, (1, 0): LA_D1},
                               dtype=jnp.float32)
    lip = float(np.linalg.eigvalsh((a @ a.T).astype(np.float64))[-1])
    vp = VertexProx(kind="l1", positivity=True)
    popt = PFDROptions(rho=1.5, dif_tol=0.0, it_max=HALO_ITERS)
    prob = shard_stencil_problem(a, y, sg, n_dev)
    res_h, t = timed(lambda: pfdr_quadratic_d1_halo(
        prob, mesh_n, la_l1=la_l1, vprox=vp, lipsch=lip, opt=popt))
    res_1 = pfdr_quadratic_d1(DenseOp(jnp.asarray(a)), jnp.asarray(y), sg,
                              la_l1=jnp.asarray(la_l1), vprox=vp,
                              lipsch=lip, opt=popt)
    check.report(f"halo PFDR quadratic {side}x{side} ({n_dev} vs 1 card)",
                 rel(res_h.x, res_1.x), MULTI_TOL, t, it=int(res_h.it))
    q = np.random.default_rng(11).dirichlet(
        np.full(4, 0.7), size=side * side).astype(np.float32)
    sg5 = StencilGraphD1.create((side, side), {(0, 1): 0.5, (1, 0): 0.5},
                                dtype=jnp.float32)
    sprob = shard_stencil_simplex_problem(q, sg5, n_dev)
    res_h, t = timed(lambda: pfdr_loss_d1_simplex_halo(
        sprob, mesh_n, al=1.0, opt=popt))
    res_1 = pfdr_loss_d1_simplex(sg5, jnp.asarray(q), al=1.0, opt=popt)
    check.report(f"halo PFDR simplex K=4 {side}x{side} ({n_dev} vs 1 card)",
                 rel(res_h.p, res_1.p), MULTI_TOL, t, it=int(res_h.it))

    # distributed cut-pursuit: operator rows sharded over the mesh.  The
    # psum over row shards sums the float32 matvecs in another order than
    # one card does, so after 15 CP iterations the partitions differ (they
    # are identical in float64, tests/test_parallel.py); the check is the
    # objective, as for the single-card cut-pursuit phases
    g = GraphD1.create(eu, ev, la, num_vertices=side * side)
    copt = cp_options(CP_EEG, host_small="off")
    res_d, t = timed(lambda: cp_quadratic_d1_dist(
        DenseOp(jnp.asarray(a)), jnp.asarray(y), g, mesh_n, la_l1=la_l1,
        positivity=True, opt=copt))
    res_1, t1 = timed(lambda: cp_quadratic_d1(
        DenseOp(jnp.asarray(a)), jnp.asarray(y), g, la_l1=la_l1,
        positivity=True, opt=copt))
    obj_d, obj_1 = (quadratic_objective(r.rx[r.cv], a, y, eu, ev, la, la_l1)
                    for r in (res_d, res_1))
    check.report(f"cp_quadratic_d1_dist dense {side}x{side} "
                 f"({n_dev} vs 1 card)", max(obj_d / obj_1 - 1.0, 0.0),
                 CP_OBJ_TOL, t,
                 cv_identical=np.array_equal(res_d.cv, res_1.cv),
                 cp_it=res_d.it,
                 components=f"{len(res_d.rx)}/{len(res_1.rx)}",
                 obj=f"{obj_d:.7g}", obj_one_card=f"{obj_1:.7g}",
                 one_card_s=f"{t1:.2f}")


# ---------------------------------------------------------------------------
# main
# ---------------------------------------------------------------------------

def card_identity():
    """The card's name and power limit, as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    return out.splitlines()


def run(multi, sizes):
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(f"no GPU: JAX found {devs[0].platform} devices")
    n_dev = 4 if multi else 1
    if len(devs) < n_dev:
        raise SystemExit(f"needs {n_dev} GPUs, JAX found {len(devs)}")

    from cp_pfdr_graph_d1_tpu import maxflow, native
    from cp_pfdr_graph_d1_tpu.utils.compile_cache import enable_compile_cache

    cache = enable_compile_cache()
    log(f"device: {devs[0].platform} {devs[0].device_kind} "
        f"x{len(devs)}; jax {jax.__version__}; compile cache {cache}")
    for line in card_identity():
        log(f"card: {line}")
    built = native.available() and maxflow._get_lib() is not None
    log("native host libraries: " + (
        "built" if built else "NOT built (no g++): host-small route off, "
        "the device route is what was checked"))

    check = Check()
    t0 = time.perf_counter()
    if multi:
        multi_phases(check, sizes, n_dev)
    else:
        with tempfile.TemporaryDirectory() as tmp:
            proc = start_reference(tmp, sizes)
            try:
                pfdr_phases(check, sizes)
                cp_phases(check, sizes, lambda: finish_reference(proc, tmp))
            finally:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
    log(f"total wall {time.perf_counter() - t0:.1f}s")
    if check.failed:
        raise SystemExit(f"failed phases: {', '.join(check.failed)}")
    return {"ok": True, "device": {"platform": devs[0].platform,
                                   "kind": devs[0].device_kind,
                                   "count": len(devs)}}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--multi", action="store_true",
                    help="run only the sharded paths, on four GPUs")
    ap.add_argument("--cpu-reference", metavar="DIR",
                    help=argparse.SUPPRESS)
    ap.add_argument("--sizes", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    sizes = dict(SIZES, **json.loads(args.sizes)) if args.sizes else SIZES
    if args.cpu_reference:
        cpu_reference(args.cpu_reference, sizes)
        return
    result = run(args.multi, sizes)
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
