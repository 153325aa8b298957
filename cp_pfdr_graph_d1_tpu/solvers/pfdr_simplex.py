"""Preconditioned forward-Douglas-Rachford for loss + d1 + simplex problems.

Solves, for ``K`` labels over a graph ``G = (V, E)``::

    min_{p_v in simplex}  sum_v  f_al(p_v; q_v)
                          + sum_{(u,v) in E} la_d1(uv) ||p_u - p_v||_1

with the loss keyed on the scalar ``al`` exactly as the reference
(``/root/reference/src/PFDR_graph_loss_d1_simplex.cpp:372-726``):

* ``al == 0``  — linear loss ``-<p, q>`` (zero Hessian; the d1-prox weights
  collapse to 1/2 and the thresholds to 2, reference :599-614),
* ``al == 1``  — quadratic loss ``1/2 la_f ||p - q||^2``,
* ``0 < al < 1`` — smoothed Kullback-Leibler
  ``KL(al/K + (1-al) q, al/K + (1-al) p)``.

State is laid out vertex-major ``[V, K]`` (same memory convention as the
reference's ``P[v*K+k]``), giving contiguous [E, K] edge slabs; the
per-vertex prox is the exact (Michelot active-set) simplex projection in
the metric ``Gamma`` (:mod:`..ops.prox`).
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..config import PFDROptions
from ..graph import GraphD1
from ..ops.prox import d1_pair_prox, proj_simplex_metric


class SimplexPrecond(NamedTuple):
    ga: jax.Array       # [V, K] descent metric (unnormalized)
    ga_proj: jax.Array  # [V, K] per-vertex max-normalized (projection metric)
    wu: jax.Array       # [E, K] splitting weights
    wv: jax.Array
    w_d1u: jax.Array    # [E, K] normalized d1 prox weights
    w_d1v: jax.Array
    th_d1: jax.Array    # [E, K] d1 thresholds


class SimplexState(NamedTuple):
    p: jax.Array
    zu: jax.Array
    zv: jax.Array
    pre: SimplexPrecond
    prev: jax.Array     # last iterate [V, K], or ML labels [V, 1]
    dif: jax.Array
    dif_rcd: jax.Array
    it: jax.Array
    obj_trace: jax.Array
    dif_trace: jax.Array


class SimplexResult(NamedTuple):
    p: jax.Array
    it: jax.Array
    obj: jax.Array
    dif: jax.Array


class SimplexSolveState(NamedTuple):
    """Complete loop-carried inner-solver state of the multi-label PFDR —
    the simplex twin of :class:`.pfdr_quadratic.PFDRSolveState` (the
    reference's ``CPls_Restart`` persists only outer-loop data,
    ``include/CP_PFDR_graph_loss_d1_simplex.hpp:26-48``).  Obtain with
    ``pfdr_loss_d1_simplex(..., return_state=True)``, persist with
    :func:`..utils.checkpoint.save_state`, resume via ``state0=`` (same
    graph container, observations, options and dtype)."""
    p: jax.Array
    zu: jax.Array
    zv: jax.Array
    pre: SimplexPrecond
    prev: jax.Array
    dif: jax.Array
    dif_rcd: jax.Array
    it: jax.Array


def _safe_div(num, den, fill=0.0):
    ok = den != 0
    return jnp.where(ok, num / jnp.where(ok, den, 1), fill)


def _loss_grad(al: float, p, q, la_f):
    """Gradient of the separable loss (``PFDR_graph_loss_d1_simplex.cpp:
    144-156`` for the three cases)."""
    if al == 0.0:
        return -q
    if al == 1.0:
        g = p - q
    else:
        al_k = al / q.shape[-1]
        al_1 = 1.0 - al
        g = -al_1 * (al_k + al_1 * q) / (al_k + al_1 * p)
    if la_f is not None:
        g = la_f[:, None] * g
    return g


def _loss_hessian(al: float, p, q, la_f):
    """Diagonal Hessian estimate (:160-190)."""
    if al == 0.0:
        return jnp.zeros_like(q)
    if al == 1.0:
        h = jnp.ones_like(q)
    else:
        al_k = al / q.shape[-1]
        al_1 = 1.0 - al
        denom = al_k / al_1 + p
        h = (al_k + al_1 * q) / (denom * denom)
    if la_f is not None:
        h = la_f[:, None] * h
    return h


def _loss_lipschitz(al: float, q, la_f):
    """Per-coordinate Lipschitz bound of the loss gradient (:249-285);
    returns None for the linear loss (L = 0, no cap)."""
    if al == 0.0:
        return None
    if al == 1.0:
        lip = jnp.ones_like(q)
    else:
        al_k = al / q.shape[-1]
        al_1 = 1.0 - al
        lip = (al_k + al_1 * q) / ((al_k / al_1) ** 2)
    if la_f is not None:
        lip = la_f[:, None] * lip
    return lip


def loss_pervertex(al: float, p, q, la_f):
    """Per-vertex loss values [V] (:476-526)."""
    if al == 0.0:
        per_v = -jnp.sum(p * q, axis=-1)
    elif al == 1.0:
        per_v = 0.5 * jnp.sum((p - q) ** 2, axis=-1)
    else:
        al_k = al / q.shape[-1]
        al_1 = 1.0 - al
        c = al_k + al_1 * q
        per_v = jnp.sum(c * jnp.log(c / (al_k + al_1 * p)), axis=-1)
    if la_f is not None:
        per_v = la_f * per_v
    return per_v


def loss_objective(al: float, p, q, la_f):
    """Loss part of the objective (:476-526)."""
    return jnp.sum(loss_pervertex(al, p, q, la_f))


def d1_objective(graph: GraphD1, p):
    pu, pv = graph.gather_endpoints(p)
    du = jnp.abs(pu - pv)
    return graph.edge_allsum(graph.la_d1 * jnp.sum(du, axis=-1))


def _precondition_simplex(al, la_f, graph: GraphD1, q, p, rho,
                          edge_w_raw) -> SimplexPrecond:
    """Builds the metric and splitting weights from raw per-(edge,label) d1
    weights ``edge_w_raw`` (:159-306)."""
    h = _loss_hessian(al, p, q, la_f)
    aux = graph.edge_to_vertex_sum(edge_w_raw, edge_w_raw)
    inv_aux = _safe_div(1.0, aux)
    inv_u, inv_v = graph.gather_endpoints(inv_aux)
    wu = edge_w_raw * inv_u
    wv = edge_w_raw * inv_v
    if al == 0.0:
        ga = inv_aux
    else:
        ga = _safe_div(1.0, h + aux, 1.0)
    cap_amt = 1.9 * (2.0 - rho)
    lip = _loss_lipschitz(al, q, la_f)
    if lip is not None:
        ga = jnp.minimum(ga, cap_amt / lip)
    if al == 0.0:
        # linear loss: fixed prox weights 1/2 and thresholds 2 (:599-614)
        w_d1u = jnp.full_like(wu, 0.5)
        w_d1v = jnp.full_like(wv, 0.5)
        th_d1 = jnp.full_like(wu, 2.0)
    else:
        gau, gav = graph.gather_endpoints(ga)
        w_d1u = wu / gau
        w_d1v = wv / gav
        s = w_d1u + w_d1v
        prod = w_d1u * w_d1v
        th_d1 = jnp.where(
            prod > 0,
            graph.la_d1[:, None] * _safe_div(s, prod), 0.0)
        w_d1u = _safe_div(w_d1u, s, 0.5)
        w_d1v = _safe_div(w_d1v, s, 0.5)
    # per-vertex max-normalization for projection stability (:360-369)
    ga_proj = _safe_div(ga, jnp.max(ga, axis=-1, keepdims=True), 1.0)
    return SimplexPrecond(ga, ga_proj, wu, wv, w_d1u, w_d1v, th_d1)


def initial_precondition_simplex(al, la_f, graph, q, p, rho):
    w_raw = jnp.broadcast_to(graph.la_d1[:, None],
                             (graph.num_edges, q.shape[-1]))
    return _precondition_simplex(al, la_f, graph, q, p, rho, w_raw)


def recondition_simplex(al, la_f, graph, q, p, rho, cond_min, zu, zv,
                        pre: SimplexPrecond):
    """Reconditioning preserving subgradients (:92-157,337-358)."""
    g = _loss_grad(al, p, q, la_f)
    pu, pv = graph.gather_endpoints(p)
    gau, gav = graph.gather_endpoints(pre.ga)
    gu, gv = graph.gather_endpoints(g)
    sub_u = (pre.wu / gau) * (pu - gau * gu - zu)
    sub_v = (pre.wv / gav) * (pv - gav * gv - zv)
    d = jnp.maximum(jnp.abs(pu - pv), cond_min)
    w_raw = graph.la_d1[:, None] / d
    new = _precondition_simplex(al, la_f, graph, q, p, rho, w_raw)
    ngau, ngav = graph.gather_endpoints(new.ga)
    zu = pu - ngau * (gu + _safe_div(sub_u, new.wu))
    zv = pv - ngav * (gv + _safe_div(sub_v, new.wv))
    return new, zu, zv


def _ml_labels(p):
    return jnp.argmax(p, axis=-1)


@partial(jax.jit, static_argnames=("al", "opt", "monitor", "has_laf",
                                   "return_state"))
def _pfdr_simplex_impl(graph: GraphD1, q, p0, la_f, *, al: float,
                       opt: PFDROptions, monitor: bool, has_laf: bool,
                       state0: SimplexSolveState | None = None,
                       return_state: bool = False):
    dtype = q.dtype
    laf = la_f if has_laf else None
    label_mode = opt.dif_tol >= 1.0

    if state0 is not None:
        pre = state0.pre
        p0 = state0.p
    else:
        pre = initial_precondition_simplex(al, laf, graph, q, p0, opt.rho)

    rho = jnp.asarray(opt.rho, dtype)
    vcount = graph.vertex_count_global()

    if state0 is not None:
        zu, zv = state0.zu, state0.zv
        prev = state0.prev
    else:
        zu, zv = graph.gather_endpoints(p0)
        if label_mode:
            prev = _ml_labels(p0).astype(dtype)[:, None]
        else:
            prev = p0
    n_trace = opt.it_max + 1 if monitor else 1
    state = SimplexState(
        p=p0, zu=zu, zv=zv, pre=pre, prev=prev,
        dif=(state0.dif if state0 is not None
             else jnp.asarray(max(opt.dif_tol, opt.dif_rcd), dtype)),
        dif_rcd=(state0.dif_rcd if state0 is not None
                 else jnp.asarray(opt.dif_rcd, dtype)),
        it=(state0.it if state0 is not None
            else jnp.asarray(0, jnp.int32)),
        obj_trace=jnp.zeros((n_trace,), dtype),
        dif_trace=jnp.zeros((n_trace,), dtype),
    )
    def cond(s: SimplexState):
        return jnp.logical_and(s.it < opt.it_max, s.dif >= opt.dif_tol)

    def body(s: SimplexState) -> SimplexState:
        obj_trace = s.obj_trace
        if monitor:
            obj = (graph.vertex_allsum(loss_pervertex(al, s.p, q, laf))
                   + d1_objective(graph, s.p))
            obj_trace = obj_trace.at[s.it].set(obj)

        if opt.dif_rcd > 0:
            def do_recond(args):
                pre, zu, zv, dif_rcd = args
                pre, zu, zv = recondition_simplex(
                    al, laf, graph, q, s.p, opt.rho, opt.cond_min, zu, zv,
                    pre)
                return pre, zu, zv, dif_rcd * jnp.asarray(0.1, dtype)

            pre, zu, zv, dif_rcd = jax.lax.cond(
                s.dif < s.dif_rcd, do_recond, lambda a: a,
                (s.pre, s.zu, s.zv, s.dif_rcd))
        else:
            pre, zu, zv, dif_rcd = s.pre, s.zu, s.zv, s.dif_rcd

        # forward step FP = 2P - Ga grad (:567-587)
        g = _loss_grad(al, s.p, q, laf)
        fp = 2.0 * s.p - pre.ga * g
        # per-(edge,label) d1 prox with relaxation (:589-634)
        fpu, fpv = graph.gather_endpoints(fp)
        spu, spv = graph.gather_endpoints(s.p)
        au = fpu - zu
        av = fpv - zv
        pu, pv = d1_pair_prox(au, av, pre.w_d1u, pre.w_d1v, pre.th_d1)
        zu = zu + rho * (pu - spu)
        zv = zv + rho * (pv - spv)
        # weighted average (:636-648)
        p = graph.edge_to_vertex_sum(pre.wu * zu, pre.wv * zv)
        # simplex projection in metric Ga (:650-651)
        p = proj_simplex_metric(p, pre.ga_proj, 1.0)

        # iterate evolution (:653-691)
        if label_mode:
            labels = _ml_labels(p).astype(dtype)[:, None]
            dif = graph.vertex_allsum(
                (labels != s.prev).astype(dtype))
            prev = labels
        else:
            dif = graph.vertex_allsum(jnp.abs(p - s.prev)) / vcount
            prev = p
        dif_trace = s.dif_trace
        if monitor:
            dif_trace = dif_trace.at[s.it].set(dif)

        # in-loop progress reporting (reference printf contract,
        # PFDR_graph_loss_d1_simplex.cpp:44-56); statically omitted at 0
        if opt.verbose:
            def _report(it, d):
                print(f"PFDR iteration {int(it)} (max. {opt.it_max}); "
                      f"relative evolution {float(d):.3e} "
                      f"(tol {opt.dif_tol:.1e})", flush=True)

            jax.lax.cond(
                (s.it + 1) % opt.verbose == 0,
                lambda args: jax.debug.callback(_report, *args),
                lambda args: None, (s.it + 1, dif))
        return SimplexState(p=p, zu=zu, zv=zv, pre=pre, prev=prev, dif=dif,
                            dif_rcd=dif_rcd, it=s.it + 1,
                            obj_trace=obj_trace, dif_trace=dif_trace)

    s = jax.lax.while_loop(cond, body, state)
    obj_trace = s.obj_trace
    dif_trace = s.dif_trace
    if monitor:
        obj_trace = obj_trace.at[s.it].set(
            graph.vertex_allsum(loss_pervertex(al, s.p, q, laf))
            + d1_objective(graph, s.p))
        # trace hygiene: entries beyond the final iteration are zero
        idx = jnp.arange(obj_trace.shape[0])
        obj_trace = jnp.where(idx <= s.it, obj_trace, 0)
        dif_trace = jnp.where(idx[:dif_trace.shape[0]] < s.it, dif_trace, 0)
    res = SimplexResult(p=s.p, it=s.it, obj=obj_trace, dif=dif_trace)
    if return_state:
        return res, SimplexSolveState(p=s.p, zu=s.zu, zv=s.zv, pre=s.pre,
                                      prev=s.prev, dif=s.dif,
                                      dif_rcd=s.dif_rcd, it=s.it)
    return res


def pfdr_loss_d1_simplex(graph: GraphD1, q, *, al: float, la_f=None,
                         p0=None, opt: PFDROptions = PFDROptions(),
                         monitor: bool = False,
                         state0: SimplexSolveState | None = None,
                         return_state: bool = False) -> SimplexResult:
    """Runs the multi-label PFDR iteration.

    Args:
      graph: the d1 graph.
      q: [V, K] observations (vertex-major, rows need not be normalized for
        the linear loss).
      al: loss selector — 0 linear, 1 quadratic, in ]0,1[ smoothed-KL.
      la_f: optional [V] per-vertex loss weights (quadratic/KL losses).
      p0: initial point (defaults to the uniform distribution).
      state0: optional :class:`SimplexSolveState` from an earlier
        ``return_state=True`` call — resumes the loop exactly where it
        stopped (same graph/observations/options); ``p0`` is ignored.
      return_state: when True, returns ``(result, SimplexSolveState)``.
    """
    q = jnp.asarray(q)
    if p0 is None:
        p0 = jnp.full_like(q, 1.0 / q.shape[-1])
    has_laf = la_f is not None
    if has_laf:
        la_f = jnp.broadcast_to(jnp.asarray(la_f, q.dtype), (q.shape[0],))
    else:
        la_f = jnp.zeros((q.shape[0],), q.dtype)  # placeholder, unused
    return _pfdr_simplex_impl(graph, q, p0, la_f, al=float(al), opt=opt,
                              monitor=monitor, has_laf=has_laf,
                              state0=state0, return_state=return_state)
