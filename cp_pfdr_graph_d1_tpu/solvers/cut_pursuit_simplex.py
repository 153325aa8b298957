"""Cut-pursuit outer solver for separable-loss + d1 + simplex labeling.

Minimizes ``sum_v f_al(p_v; q_v) + sum_e la_d1 ||p_u - p_v||_1`` over
per-vertex probability vectors, by alternating a sequence of K-1
alpha-expansion-style binary cuts (the steepest ternary descent search of
``/root/reference/src/CP_PFDR_graph_loss_d1_simplex.cpp:522-618``) with
multi-label PFDR solves of the component-contracted problem (:643-780).

The binary energies of each expansion cut use the Kolmogorov-Zabih
decomposition (:563-595); here they are re-expressed in the symmetric
form consumed by the native min-cut (unary costs + symmetric edge weights),
which is algebraically identical.
"""
from __future__ import annotations

import time as _time
from functools import partial
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from .. import maxflow, native
from ..config import CPOptions
from ..graph import GraphD1
from .cut_pursuit_common import (np64,
                                 build_reduced_graph, bucket,
                                 connected_components, machine_eps,
                                 make_reduced_container, pad_reduced_graph)
from .pfdr_simplex import (d1_objective, loss_objective,
                           pfdr_loss_d1_simplex)


class CPSimplexState(NamedTuple):
    active: np.ndarray
    cv: np.ndarray
    rp: np.ndarray       # [rV, K]


class CPSimplexResult(NamedTuple):
    cv: np.ndarray
    rp: np.ndarray       # [rV, K]
    it: int
    time: np.ndarray
    obj: np.ndarray
    dif: np.ndarray
    state: CPSimplexState


def _loss_grad_np(al, p_full, q, la_f=None):
    """Host-side loss gradient (``CP_PFDR_graph_loss_d1_simplex.cpp:
    327-354``); la_f is always None at the full-problem level."""
    k = q.shape[1]
    if al == 0.0:
        return -q.copy()
    if al == 1.0:
        return p_full - q
    al_k = al / k
    al_1 = 1.0 - al
    return -(al_k + al_1 * q) / (al_k / al_1 + p_full)


@partial(jax.jit, static_argnames=("al",))
def _loss_grad_device(q, p_full, al: float):
    """Jitted twin of :func:`_loss_grad_np`: elementwise over [V, K], so a
    vertex-sharded ``q`` (GSPMD) computes its shard locally."""
    k = q.shape[1]
    if al == 0.0:
        return -q
    if al == 1.0:
        return p_full - q
    al_k = al / k
    al_1 = 1.0 - al
    return -(al_k + al_1 * q) / (al_k / al_1 + p_full)


@partial(jax.jit, static_argnames=("rv_cap",))
def _reduce_obs_device(q, cv, rv_cap: int):
    """Reduced observations on device: component sums of ``q`` rows and
    component sizes as one-hot matmul contractions
    (``CP_PFDR_graph_loss_d1_simplex.cpp:733-766``).  Under GSPMD with
    ``q`` sharded over the vertex axis this is a local matmul + psum."""
    s = jax.nn.one_hot(cv, rv_cap, dtype=q.dtype)
    return jnp.matmul(s.T, q,
                      precision=jax.lax.Precision.HIGHEST), \
        jnp.sum(s, axis=0)


def _alpha_expansion_cuts(dfs, rdi, cv, eu, ev, la_d1, active, eps,
                          min_cut_fn=None):
    """Runs the K-1 binary expansion cuts; returns the per-vertex final
    descent counters ``djv`` (:522-606)."""
    if min_cut_fn is None:
        min_cut_fn = maxflow.min_cut
    num_v, k = dfs.shape
    djv = np.zeros(num_v, np.int32)
    # only inactive edges carry capacity; active ones get zero (:563-566)
    inact = np.nonzero(~active)[0]
    ieu, iev, ila = eu[inact], ev[inact], la_d1[inact]
    i_of_v = rdi[cv]  # confident label of each vertex's component
    rows = np.arange(num_v)
    dfs_i = dfs[rows, i_of_v]
    for n in range(1, k):
        j_of_v = np.where(n > i_of_v, n, n - 1)
        dfs_j = dfs[rows, j_of_v]
        cur = np.where(djv > i_of_v, djv, np.maximum(djv - 1, 0))
        dfs_cur = dfs[rows, cur]
        theta = np.where(
            djv == 0, dfs_j - dfs_i,
            np.where(djv == n, 0.0, dfs_j - dfs_cur))
        # pairwise: equal current directions -> symmetric 2*la; different ->
        # la with -la unary credits on both endpoints (KZ-equivalent)
        same = djv[ieu] == djv[iev]
        w = np.where(same, 2.0 * ila, ila)
        credit = np.where(same, 0.0, ila)
        np.subtract.at(theta, ieu, credit)
        np.subtract.at(theta, iev, credit)
        side = min_cut_fn(num_v, ieu, iev, w, theta)
        djv[side.astype(bool)] = n
    return djv


def cp_loss_d1_simplex(graph: GraphD1, q, *, al: float,
                       opt: CPOptions = CPOptions(),
                       monitor: bool = False,
                       state: Optional[CPSimplexState] = None,
                       device_obs: bool = False) -> CPSimplexResult:
    """Multi-label cut-pursuit solve.

    Args:
      graph: the d1 graph.
      q: [V, K] observations (vertex-major).
      al: loss selector — 0 linear, 1 quadratic, in ]0,1[ smoothed-KL.
      opt: outer options; ``opt.dif_tol >= 1`` switches the stopping
        criterion to the number of changed maximum-likelihood labels.
      device_obs: compute the O(V K) observation stages (loss gradient,
        reduced barycenters) as jitted device ops on ``q`` as given —
        pass a mesh-sharded ``q`` (:func:`~..parallel.cp_dist
        .cp_loss_d1_simplex_dist`) and GSPMD runs them distributed.

    Returns component labels and [rV, K] component distributions
    (full solution ``p = rp[cv]``).
    """
    if opt.cut == "device" and not device_obs:
        # fully device-resident iteration: expansion cuts, components,
        # contraction, merge all on device (the multi-label twin of
        # cut_pursuit_device); device_obs (mesh-sharded q) keeps the host
        # loop whose observation stages are GSPMD-distributed instead
        from .cut_pursuit_simplex_device import cp_loss_d1_simplex_device
        return cp_loss_d1_simplex_device(graph, q, al=al, opt=opt,
                                         monitor=monitor, state=state)
    t0 = _time.monotonic()
    eu = np.asarray(graph.eu)
    ev = np.asarray(graph.ev)
    la_d1 = np.asarray(graph.la_d1)
    if device_obs:
        # q stays a (possibly mesh-sharded) device array; the O(V K)
        # observation stages run jitted and GSPMD-distributed on it.
        # Rows beyond the vertex count are zero padding (sharding
        # divisibility), inert in every stage below.
        q_dev = q if isinstance(q, jax.Array) else jnp.asarray(q)
        q = None
        num_v = graph.num_vertices
        k = q_dev.shape[1]
        v_pad = q_dev.shape[0] - num_v
        dtype = np.dtype(q_dev.dtype)
    else:
        q = np.asarray(q)
        num_v, k = q.shape
        dtype = q.dtype
    num_e = graph.num_edges
    label_mode = opt.dif_tol >= 1.0

    tol_scale = opt.dif_tol / num_v if label_mode else opt.dif_tol
    ptol = opt.pfdr.dif_tol / num_v if opt.pfdr.dif_tol >= 1 \
        else opt.pfdr.dif_tol
    eps = machine_eps(dtype, min(tol_scale, ptol))

    if opt.cut == "device":
        from ..maxflow.device import min_cut_device_with_fallback
        min_cut_fn = partial(min_cut_device_with_fallback,
                             tol=opt.cut_tol, it_max=opt.cut_it_max)
    elif opt.cut == "host":
        min_cut_fn = maxflow.min_cut
    else:
        raise ValueError(f"unknown cut backend {opt.cut!r}")

    # -- initialization: unisimplicial solution (:66-148) -------------------
    if state is None:
        qsum = (np.asarray(jax.device_get(jnp.sum(q_dev, axis=0)))
                if device_obs else q.sum(axis=0))
        if al == 0.0:
            rp = np.zeros((1, k), dtype)
            rp[0, np.argmax(qsum)] = 1.0
        else:
            rp = (qsum / num_v)[None, :].astype(dtype)
        active = np.zeros(num_e, bool)
        cv = np.zeros(num_v, np.int32)
    else:
        active = state.active.copy()
        cv = state.cv.copy()
        rp = state.rp.copy()

    times = [0.0]
    objs = []
    difs = []
    if not device_obs:
        q_dev = jnp.asarray(q)

    # host-small routing: reduced multi-label problems below the crossover
    # solve on the host (native C++ PFDR), avoiding device dispatch latency
    if opt.host_small == "off":
        use_host = False
    elif opt.host_small == "on":
        use_host = native.available()
    else:
        use_host = (jax.default_backend() not in ("cpu",)
                    and native.available())

    def objective(rp_, cv_):
        p_full = jnp.asarray(rp_[cv_])
        q_obj = q_dev[:num_v] if (device_obs and v_pad) else q_dev
        return float(loss_objective(al, p_full, q_obj, None)
                     + d1_objective(graph, p_full))

    if monitor:
        objs.append(objective(rp, cv))

    prev_labels = np.argmax(rp, axis=1)[cv]
    prev_p_full = rp[cv]
    it = 0
    dif = max(opt.dif_tol, 1.0)
    num_comp = rp.shape[0]

    # inexact outer loop (same schedule as the quadratic family): capped
    # intermediate reduced solves + a full-accuracy polish on the settled
    # partition before returning
    inexact_on = (opt.inexact == "auto"
                  and opt.pfdr.it_max > opt.inexact_cap)
    last_capped = False
    while it < opt.it_max and dif >= opt.dif_tol:
        p_full = rp[cv]

        # -- gradient + active-edge d1 signs (:327-377) --------------------
        if device_obs:
            p_pad = (np.concatenate([p_full, np.full((v_pad, k), 1.0 / k)])
                     if v_pad else p_full)
            g_dev = _loss_grad_device(q_dev, jnp.asarray(p_pad), float(al))
            if jax.process_count() > 1 and not (
                    getattr(g_dev, "is_fully_replicated", True)):
                # multi-host: the gradient inherits the observation's
                # vertex sharding — gather it to every replicated host
                from jax.experimental import multihost_utils
                dfs = np.asarray(multihost_utils.process_allgather(
                    g_dev, tiled=True))[:num_v]
            else:
                dfs = np.array(jax.device_get(g_dev))[:num_v]
        else:
            dfs = _loss_grad_np(al, p_full, q)
        ae = np.nonzero(active)[0]
        if len(ae):
            d = p_full[eu[ae]] - p_full[ev[ae]]
            s = np.where(d > eps, 1.0, np.where(d < -eps, -1.0, 0.0))
            s = s * la_d1[ae][:, None]
            np.add.at(dfs, eu[ae], s)
            np.add.at(dfs, ev[ae], -s)

        # -- alpha-expansion cuts (:522-606) -------------------------------
        rdi = np.argmax(rp, axis=1).astype(np.int32)
        djv = _alpha_expansion_cuts(dfs, rdi, cv, eu, ev, la_d1, active,
                                    eps, min_cut_fn=min_cut_fn)
        inact = ~active
        sep = inact & (djv[eu] != djv[ev])
        n_new = int(sep.sum())
        active |= sep

        if n_new == 0:
            difs.append(0.0)
            dif = 0.0
            it += 1
            times.append(_time.monotonic() - t0)
            if monitor:
                objs.append(objs[-1] if objs else float("nan"))
            continue

        # -- contraction (:643-731) ----------------------------------------
        num_comp, cv = connected_components(num_v, eu, ev,
                                            ~active & (la_d1 > 0))
        rg = build_reduced_graph(cv, num_comp, eu, ev, la_d1, active, eps)
        host_reduce = use_host and num_comp <= opt.host_small_max
        rv_cap = num_comp if host_reduce else bucket(num_comp)

        # -- reduced observations (:733-766) -------------------------------
        if device_obs:
            # out-of-range padded labels one-hot to all-zero rows (inert)
            cv_pad = (np.concatenate([cv, np.full(v_pad, rv_cap,
                                                  np.int32)])
                      if v_pad else cv)
            qsum_d, sizes_d = _reduce_obs_device(q_dev,
                                                 jnp.asarray(cv_pad),
                                                 rv_cap)
            qsum = np.asarray(jax.device_get(qsum_d)).astype(dtype)
            sizes = np.asarray(jax.device_get(sizes_d)).astype(dtype)
        else:
            qsum = np.zeros((rv_cap, k), dtype)
            np.add.at(qsum, cv, q)
            sizes = np.bincount(cv, minlength=rv_cap).astype(dtype)
        if al == 0.0:
            rq = qsum
            rp0 = np.zeros((rv_cap, k), dtype)
            rp0[np.arange(rv_cap), np.argmax(qsum, axis=1)] = 1.0
            rp0[num_comp:] = 1.0 / k  # inert uniform rows on padding
            rla_f = None
        else:
            safe = np.maximum(sizes, 1)[:, None]
            rq = qsum / safe
            rp0 = rq.copy()
            rp0[num_comp:] = 1.0 / k
            rq[num_comp:] = 1.0 / k
            rla_f = np.maximum(sizes, 0)

        # -- reduced PFDR solve (:773-780) ---------------------------------
        def solve_reduced(rp_start, inner_it_max):
            if host_reduce:
                rp_new, _ = native.pfdr_loss_d1_simplex_host(
                    np64(rq), al, rg.eu, rg.ev,
                    np64(rg.la_d1),
                    la_f=(np64(rla_f)
                          if rla_f is not None else None),
                    rho=opt.pfdr.rho, cond_min=opt.pfdr.cond_min,
                    dif_rcd=opt.pfdr.dif_rcd, dif_tol=opt.pfdr.dif_tol,
                    it_max=inner_it_max, p0=rp_start)
                return rp_new.astype(dtype)
            re_cap = bucket(len(rg.eu))
            reu, rev, rla = pad_reduced_graph(rg, rv_cap, re_cap)
            rgraph = make_reduced_container(reu, rev, rla, rv_cap,
                                            q_dev.dtype)
            import dataclasses as _dc
            popt = (opt.pfdr if inner_it_max == opt.pfdr.it_max
                    else _dc.replace(opt.pfdr, it_max=inner_it_max))
            res = pfdr_loss_d1_simplex(
                rgraph, jnp.asarray(rq), al=al,
                la_f=jnp.asarray(rla_f) if rla_f is not None else None,
                p0=jnp.asarray(rp_start), opt=popt)
            return np.array(jax.device_get(res.p), dtype)[:num_comp]

        inner_cap = (opt.inexact_cap if inexact_on else opt.pfdr.it_max)
        rp = solve_reduced(rp0, inner_cap)
        last_capped = inner_cap < opt.pfdr.it_max

        # -- merge almost-equal components (:782-804) ----------------------
        p_full = rp[cv]
        ae = np.nonzero(active)[0]
        if len(ae):
            d = np.abs(p_full[eu[ae]] - p_full[ev[ae]]).max(axis=1)
            active[ae[d <= eps]] = False

        # -- evolution + objective (:806-917) ------------------------------
        if label_mode:
            labels = np.argmax(rp, axis=1)[cv]
            dif = float((labels != prev_labels).sum())
            prev_labels = labels
        else:
            dif = float(np.abs(p_full - prev_p_full).sum()) / num_v
            prev_p_full = p_full
        difs.append(dif)
        it += 1
        times.append(_time.monotonic() - t0)
        if monitor:
            objs.append(objective(rp, cv))
        if opt.verbose:
            print(f"CP-simplex it {it}: {num_comp} components, "
                  f"{int(active.sum())} active edges, dif {dif:.3g}")

    if last_capped:
        # final full-accuracy solve on the settled partition, warm-started
        # from the capped solution; merge and trace tails recomputed
        rp_pad = rp
        if rp_pad.shape[0] < rv_cap:
            pad = np.full((rv_cap - rp_pad.shape[0], k), 1.0 / k, dtype)
            rp_pad = np.concatenate([rp_pad, pad])
        rp = solve_reduced(rp_pad, opt.pfdr.it_max)[:num_comp]
        p_full = rp[cv]
        ae = np.nonzero(active)[0]
        if len(ae):
            d = np.abs(p_full[eu[ae]] - p_full[ev[ae]]).max(axis=1)
            active[ae[d <= eps]] = False
        times[-1] = _time.monotonic() - t0
        if monitor:
            objs[-1] = objective(rp, cv)
    return CPSimplexResult(
        cv=cv, rp=rp, it=it,
        time=np.asarray(times),
        obj=np.asarray(objs) if monitor else np.zeros(0, dtype),
        dif=np.asarray(difs),
        state=CPSimplexState(active=active, cv=cv, rp=rp))
