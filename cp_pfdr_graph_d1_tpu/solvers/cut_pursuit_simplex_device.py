"""Device-resident cut-pursuit iteration for the multi-label family.

The host multi-label loop (:mod:`.cut_pursuit_simplex`) keeps the
alpha-expansion bookkeeping, connected components, and contraction on
host — O(V K + E) host traffic per CP iteration.  This module is its
fully device-resident twin (the multi-label analog of
:mod:`.cut_pursuit_device`), mirroring the reference outer loop
``/root/reference/src/CP_PFDR_graph_loss_d1_simplex.cpp:186-926``:

* loss gradient + active-edge d1 subgradients as container-aware
  edge/vertex maps (``:327-377``);
* the K-1 alpha-expansion binary cuts (``:522-606``) as certified PDHG
  min-cuts (:mod:`..maxflow.device`) — the Kolmogorov-Zabih pairwise
  decomposition is re-expressed as symmetric weights plus unary credits,
  exactly as in the host loop; an uncertified cut falls back to the host
  push-relabel for that cut only (with a warning), never silently;
* connected components / contraction / merge reuse the device stages of
  the quadratic loop (:func:`.cut_pursuit_device._device_components`,
  ``_contract_sort``/``_contract_pad``);
* reduced observations (barycenters + component sizes, ``:733-766``) as
  a one-hot matmul contraction, or sorted run-length row sums beyond the
  one-hot regime.

Per-iteration host traffic: a handful of scalars plus the O(rE) reduced
edge arrays for container construction.  Selected via
``cp_loss_d1_simplex(..., opt=CPOptions(cut="device"))``.
"""
from __future__ import annotations

import time as _time
import warnings
from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from .. import maxflow
from ..config import CPOptions
from .cut_pursuit_common import np64
from ..graph import GraphD1
from ..maxflow.device import _pdhg_min_cut
from .cut_pursuit_common import bucket, machine_eps, make_reduced_container
from .cut_pursuit_device import (_ONEHOT_MAX, _contract_pad, _contract_sort,
                                 _dbg, _device_components, _vertex_runs)
from .cut_pursuit_simplex import (CPSimplexResult, CPSimplexState,
                                  _loss_grad_device)
from .pfdr_simplex import d1_objective, loss_objective, pfdr_loss_d1_simplex


@partial(jax.jit, static_argnames=("al",))
def _direction_costs_simplex(graph: GraphD1, q, p_full, active, al: float,
                             eps):
    """Loss gradient + active-edge d1 sign terms, [V, K] on device
    (``CP_PFDR_graph_loss_d1_simplex.cpp:327-377``)."""
    dfs = _loss_grad_device(q, p_full, al)
    pu, pv = graph.gather_endpoints(p_full)
    d = pu - pv
    s = jnp.where(d > eps, 1.0, jnp.where(d < -eps, -1.0, 0.0))
    s = s * (graph.la_d1 * active)[:, None]
    return dfs + graph.edge_to_vertex_sum(s, -s)


def _sel_label(dfs, idx):
    """``dfs[v, idx[v]]`` as a one-hot contraction."""
    k = dfs.shape[1]
    return jnp.sum(dfs * jax.nn.one_hot(idx, k, dtype=dfs.dtype), axis=1)


@partial(jax.jit, static_argnames=("n",))
def _expansion_capacities(graph: GraphD1, dfs, i_of_v, djv, active, n: int):
    """Unary costs and symmetric edge weights of expansion cut ``n``
    (``:539-595``; KZ decomposition re-expressed as weights + unary
    credits, algebraically identical — see the host twin
    :func:`.cut_pursuit_simplex._alpha_expansion_cuts`)."""
    dfs_i = _sel_label(dfs, i_of_v)
    j_of_v = jnp.where(n > i_of_v, n, n - 1)
    dfs_j = _sel_label(dfs, j_of_v)
    cur = jnp.where(djv > i_of_v, djv, jnp.maximum(djv - 1, 0))
    dfs_cur = _sel_label(dfs, cur)
    theta = jnp.where(djv == 0, dfs_j - dfs_i,
                      jnp.where(djv == n, 0.0, dfs_j - dfs_cur))
    du, dv = graph.gather_endpoints(djv)
    same = du == dv
    la = graph.la_d1
    valid = ~active & (la > 0)
    w = jnp.where(valid, jnp.where(same, 2.0 * la, la), 0.0)
    credit = jnp.where(valid & ~same, la, 0.0)
    theta = theta - graph.edge_to_vertex_sum(credit, credit)
    return w, theta


@partial(jax.jit, static_argnames=("it_max", "check_every"))
def _device_side(graph: GraphD1, w, c, tol, it_max: int, check_every: int,
                 x0=None, z0=None):
    """One certified PDHG min-cut; returns (side, gap, cost scale, and
    the relaxed (x, z) state — warm-start for the SAME label's expansion
    cut of the next CP iteration)."""
    big = 1.0 + 2.0 * (jnp.sum(w) + jnp.sum(jnp.abs(c)))
    c_cl = jnp.clip(c, -big, big)
    side, gap, _, x, z = _pdhg_min_cut(graph, w, c_cl.astype(w.dtype),
                                       (tol * big).astype(w.dtype), it_max,
                                       check_every, x0, z0)
    return side, gap, big, x, z


@partial(jax.jit, static_argnames=("rv_cap",))
def _reduce_obs(q, cv, rv_cap: int):
    """Component row sums of ``q`` and component sizes at static capacity
    (``:733-766``): one-hot matmul contraction, or sorted run-length row
    sums beyond the one-hot regime (O(V K) memory)."""
    if rv_cap <= _ONEHOT_MAX:
        s = jax.nn.one_hot(cv, rv_cap, dtype=q.dtype)
        return jnp.matmul(s.T, q,
                          precision=jax.lax.Precision.HIGHEST), \
            jnp.sum(s, axis=0)
    v = cv.shape[0]
    order, starts = _vertex_runs(cv, rv_cap)
    prefix = jnp.concatenate([jnp.zeros((1, q.shape[1]), q.dtype),
                              jnp.cumsum(q[order], axis=0)])
    nxt = jnp.concatenate([starts[1:], jnp.full((1,), v, starts.dtype)])
    end = jnp.where(starts < v, nxt, v)
    start_safe = jnp.where(starts < v, starts, v)
    qsum = prefix[end] - prefix[start_safe]
    sizes = (end - start_safe).astype(q.dtype)
    return qsum, sizes


@partial(jax.jit, static_argnames=("al", "rv_cap"))
def _reduced_problem(qsum, sizes, num_comp, al: float, rv_cap: int):
    """Reduced observations / warm start / per-component loss weights;
    padded rows (>= num_comp) are inert uniform distributions."""
    k = qsum.shape[1]
    live = (jnp.arange(rv_cap, dtype=jnp.int32) < num_comp)[:, None]
    unif = jnp.asarray(1.0 / k, qsum.dtype)
    if al == 0.0:
        rp0 = jax.nn.one_hot(jnp.argmax(qsum, axis=1), k, dtype=qsum.dtype)
        return qsum, jnp.where(live, rp0, unif), sizes
    safe = jnp.maximum(sizes, 1)[:, None]
    rq = jnp.where(live, qsum / safe, unif)
    return rq, rq, sizes


@jax.jit
def _device_merge_simplex(graph: GraphD1, p_full, active, eps):
    """Deactivates active edges whose endpoint distributions are equal to
    within eps in max-norm (``:782-804``)."""
    pu, pv = graph.gather_endpoints(p_full)
    d = jnp.max(jnp.abs(pu - pv), axis=1)
    return active & ~(d <= eps)


def cp_loss_d1_simplex_device(graph: GraphD1, q, *, al: float,
                              opt: CPOptions = CPOptions(),
                              monitor: bool = False,
                              state: Optional[CPSimplexState] = None,
                              ) -> CPSimplexResult:
    """Device-resident multi-label cut-pursuit solve (same contract as
    :func:`.cut_pursuit_simplex.cp_loss_d1_simplex`); see module
    docstring."""
    t0 = _time.monotonic()
    q = np.asarray(q)
    num_v, k = q.shape
    dtype = q.dtype
    q_dev = jnp.asarray(q)
    label_mode = opt.dif_tol >= 1.0
    tol_scale = opt.dif_tol / num_v if label_mode else opt.dif_tol
    ptol = opt.pfdr.dif_tol / num_v if opt.pfdr.dif_tol >= 1 \
        else opt.pfdr.dif_tol
    eps = machine_eps(dtype, min(tol_scale, ptol))
    eps_dev = jnp.asarray(eps, dtype)

    # -- initialization: unisimplicial solution (:66-148) -------------------
    if state is None:
        qsum0 = q.sum(axis=0)
        if al == 0.0:
            rp = np.zeros((1, k), dtype)
            rp[0, np.argmax(qsum0)] = 1.0
        else:
            rp = (qsum0 / num_v)[None, :].astype(dtype)
        active = jnp.zeros((graph.num_edges,), bool)
        cv = jnp.zeros((num_v,), jnp.int32)
        rp_dev = jnp.asarray(rp)
    else:
        active = jnp.asarray(state.active)
        cv = jnp.asarray(state.cv)
        rp_dev = jnp.asarray(state.rp, dtype)

    times = [0.0]
    objs = []
    difs = []

    def objective(p_full):
        return float(loss_objective(al, p_full, q_dev, None)
                     + d1_objective(graph, p_full))

    p_full = rp_dev[cv]
    if monitor:
        objs.append(objective(p_full))
    prev_labels = jnp.argmax(p_full, axis=1)
    prev_p_full = p_full
    it = 0
    dif = max(opt.dif_tol, 1.0)
    num_comp = rp_dev.shape[0]
    chk = min(250, opt.cut_it_max)

    cut_carry = {}
    while it < opt.it_max and dif >= opt.dif_tol:
        p_full = rp_dev[cv]

        # -- gradient + active-edge signs (:327-377) ------------------------
        dfs = _direction_costs_simplex(graph, q_dev, p_full, active,
                                       float(al), eps_dev)
        _dbg("simplex direction", dfs)

        # -- K-1 alpha-expansion cuts (:522-606) ----------------------------
        # the cuts are sequential (cut n's capacities depend on the labels
        # cut n-1 assigned) but their CERTIFICATES are not: the gaps stack
        # on device and sync in ONE host round trip after the sequence,
        # instead of K-1 blocking float() syncs
        rdi = jnp.argmax(rp_dev, axis=1).astype(jnp.int32)
        i_of_v = rdi[cv]
        djv = jnp.zeros((num_v,), jnp.int32)
        gaps = []
        for n in range(1, k):
            w, theta = _expansion_capacities(graph, dfs, i_of_v, djv,
                                             active, n)
            x0n, z0n = cut_carry.get(n, (None, None))
            side, gap, big, xn, zn = _device_side(
                graph, w, theta, opt.cut_tol, opt.cut_it_max, chk,
                x0n, z0n)
            cut_carry[n] = (xn, zn)
            gaps.append(jnp.stack([gap, big]))
            djv = jnp.where(side, jnp.int32(n), djv)
        certs = np.asarray(jax.device_get(jnp.stack(gaps)))
        if np.any(certs[:, 0] > opt.cut_tol * certs[:, 1]):
            # exactness guard: redo the WHOLE expansion sequence on host
            # (later cuts consumed the uncertified labels)
            bad = np.nonzero(certs[:, 0] > opt.cut_tol * certs[:, 1])[0]
            warnings.warn("falling back to the host min-cut solver for "
                          f"expansion cuts (uncertified: {bad + 1})",
                          UserWarning, stacklevel=2)
            djv = _host_expansion_fallback(graph, dfs, rdi, cv, active,
                                           eps)
        du, dv = graph.gather_endpoints(djv)
        sep = ~active & (graph.la_d1 > 0) & (du != dv)
        n_new = int(jnp.sum(sep))
        active = active | sep
        _dbg(f"expansion cuts n_new={n_new}")

        if n_new == 0:  # nothing to recompute (:620-641)
            difs.append(0.0)
            dif = 0.0
            it += 1
            times.append(_time.monotonic() - t0)
            if monitor:
                objs.append(objs[-1] if objs else float("nan"))
            continue

        # -- contraction, on device (:643-731) ------------------------------
        cv, num_comp_dev, _ = _device_components(graph, active)
        num_comp = int(num_comp_dev)
        lo_s, hi_s, w_sorted, flags, re_count = _contract_sort(cv, graph,
                                                               active)
        rv_cap = bucket(num_comp)
        re_cap = bucket(int(re_count))
        reu, rev, rla = _contract_pad(lo_s, hi_s, w_sorted, flags,
                                      num_comp_dev, eps, dtype, rv_cap,
                                      re_cap)
        rgraph = make_reduced_container(reu, rev, np.asarray(rla), rv_cap,
                                        q_dev.dtype)
        _dbg(f"contraction rv={num_comp} re={int(re_count)}")

        # -- reduced observations (:733-766) --------------------------------
        qsum, sizes = _reduce_obs(q_dev, cv, rv_cap)
        rq, rp0, rla_f = _reduced_problem(qsum, sizes, num_comp_dev,
                                          float(al), rv_cap)

        # -- reduced PFDR solve (:773-780) -----------------------------------
        res = pfdr_loss_d1_simplex(
            rgraph, rq, al=al, la_f=None if al == 0.0 else rla_f, p0=rp0,
            opt=opt.pfdr)
        rp_dev = res.p
        p_full = rp_dev[cv]
        _dbg(f"reduced pfdr it={int(res.it)}")

        # -- merge + evolution (:782-917) ------------------------------------
        active = _device_merge_simplex(graph, p_full, active, eps_dev)
        if label_mode:
            labels = jnp.argmax(p_full, axis=1)
            dif = float(jnp.sum(labels != prev_labels))
            prev_labels = labels
        else:
            dif = float(jnp.sum(jnp.abs(p_full - prev_p_full))) / num_v
            prev_p_full = p_full
        difs.append(dif)
        it += 1
        times.append(_time.monotonic() - t0)
        if monitor:
            objs.append(objective(p_full))
        if opt.verbose:
            print(f"CP-simplex it {it} (device): {num_comp} components, "
                  f"{int(jnp.sum(active))} active edges, dif {dif:.3g}")

    cv_host = np.asarray(jax.device_get(cv))
    rp_host = np.asarray(jax.device_get(rp_dev), dtype)[:num_comp]
    active_host = np.asarray(jax.device_get(active))
    return CPSimplexResult(
        cv=cv_host, rp=rp_host, it=it,
        time=np.asarray(times),
        obj=np.asarray(objs) if monitor else np.zeros(0, dtype),
        dif=np.asarray(difs),
        state=CPSimplexState(active=active_host, cv=cv_host, rp=rp_host))


def _host_expansion_fallback(graph: GraphD1, dfs, rdi, cv, active, eps):
    """Host push-relabel rerun of the FULL K-1 expansion sequence
    (certificate failure: later cuts consumed uncertified labels, so the
    whole sequence is redone with the host twin
    :func:`.cut_pursuit_simplex._alpha_expansion_cuts`)."""
    from .cut_pursuit_simplex import _alpha_expansion_cuts
    djv = _alpha_expansion_cuts(
        np.asarray(jax.device_get(dfs), np.float64),
        np.asarray(jax.device_get(rdi)),
        np.asarray(jax.device_get(cv)),
        np.asarray(graph.eu), np.asarray(graph.ev),
        np64(graph.la_d1),
        np.asarray(jax.device_get(active)), float(eps),
        min_cut_fn=maxflow.min_cut)
    return jnp.asarray(djv.astype(np.int32))
