"""Preconditioned forward-Douglas-Rachford for quadratic + d1 problems.

Solves, over a graph ``G = (V, E)``::

    min_x  1/2 ||y - A x||^2  +  sum_{(u,v) in E} la_d1(uv) |x_u - x_v|
           + sum_v la_l1(v) |x_v|  (+ indicator of x >= 0)     [l1 family]
           + sum_v indicator of lo <= x_v <= hi                [bounds family]

This single solver unifies the reference's two near-identical files
``/root/reference/src/PFDR_graph_quadratic_d1_l1.cpp`` and
``.../PFDR_graph_quadratic_d1_bounds.cpp`` (same preconditioning and main
iteration; only the vertex prox differs: soft-threshold at :499-512 vs box
clamp at :472-489 respectively).  Numerics — Jacobi preconditioner,
``1.9 (2 - rho)`` metric cap, per-edge splitting weights and thresholds,
reconditioning with subgradient preservation — follow the reference exactly
(``PFDR_graph_quadratic_d1_l1.cpp:57-268`` for the preconditioner and
``:353-532`` for the iteration).

Device mapping: the whole solve is one jitted ``lax.while_loop``; the
per-edge prox is a vectorized map over ``E``; the serial edge->vertex
scatter of the reference (:492-497) becomes the graph container's
edge->vertex reduction; the dense A applications are matmuls.
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..config import Lipsch, PFDROptions
from ..graph import GraphD1
from ..operators import QuadOp
from ..ops.prox import d1_pair_prox


class VertexProx(NamedTuple):
    """Static description of the separable vertex term ``g_v``."""
    kind: str = "none"          # "none" | "l1" | "bounds"
    positivity: bool = False    # only for kind == "l1"
    lo: float = -jnp.inf        # only for kind == "bounds"
    hi: float = jnp.inf


class Precond(NamedTuple):
    """Preconditioning products (reference ``preconditioning()`` outputs)."""
    ga: jax.Array       # [V] diagonal descent metric Gamma
    wu: jax.Array       # [E] splitting weights (sum to 1 per vertex)
    wv: jax.Array
    w_d1u: jax.Array    # [E] normalized d1-prox weights
    w_d1v: jax.Array
    th_d1: jax.Array    # [E] d1 soft-threshold levels
    th_l1: jax.Array    # [V] l1 soft-threshold levels (zeros when unused)


class PFDRState(NamedTuple):
    x: jax.Array
    zu: jax.Array
    zv: jax.Array
    pre: Precond
    x_prev: jax.Array
    dif: jax.Array
    dif_rcd2: jax.Array
    it: jax.Array
    obj_trace: jax.Array
    dif_trace: jax.Array


class PFDRResult(NamedTuple):
    x: jax.Array
    it: jax.Array
    obj: jax.Array   # [it_max + 1]; entries beyond ``it`` are zero
    dif: jax.Array   # [it_max]


class PFDRSolveState(NamedTuple):
    """Complete loop-carried solver state — everything needed to resume a
    long inner solve mid-way and reproduce the uninterrupted trajectory
    (the reference's restart structs persist only the outer-loop data and
    are untested, ``CP_PFDR_graph_quadratic_d1_l1.hpp:36-42``).

    Obtain with ``pfdr_quadratic_d1(..., return_state=True)``, persist with
    :func:`..utils.checkpoint.save_state`, and resume by passing it back
    as ``state0=`` (with the SAME graph container, operator, options and
    dtype — the z layout follows the container's edge order)."""
    x: jax.Array
    zu: jax.Array
    zv: jax.Array
    pre: Precond
    x_prev: jax.Array
    dif: jax.Array
    dif_rcd2: jax.Array
    it: jax.Array


def _safe_div(num, den, fill=0.0):
    ok = den != 0
    return jnp.where(ok, num / jnp.where(ok, den, 1), fill)


def _amplitude_scale(graph, x, inverse: bool):
    """Amplitude statistic over nonzero coordinates
    (``PFDR_graph_quadratic_d1_l1.cpp:145-154``): the *inverse* mean
    ``n / sum|x|`` at initial preconditioning (``P == NULL`` branch), the
    mean ``sum|x| / n`` at reconditioning."""
    n = graph.vertex_allsum((x != 0).astype(x.dtype))
    s = graph.vertex_allsum(jnp.abs(x))
    if inverse:
        return _safe_div(n, s, 1.0)
    return _safe_div(s, n, 1.0)


def _metric_cap(inv_h, rho, lipsch, ltype: Lipsch):
    """Caps the metric at ``1.9 (2 - rho) / L``
    (``PFDR_graph_quadratic_d1_l1.cpp:224-239``)."""
    a = 1.9 * (2.0 - rho)
    if lipsch is None:
        return jnp.minimum(inv_h, a)
    if ltype is Lipsch.SCAL:
        return jnp.minimum(inv_h, a / lipsch)
    return jnp.where(lipsch > 0, jnp.minimum(inv_h, _safe_div(a, lipsch,
                                                              jnp.inf)),
                     inv_h)


def _finalize_precond(graph: GraphD1, h, wu_raw, wv_raw, la_l1, l1_h_term,
                      rho, lipsch, ltype) -> Precond:
    """Common tail of initial- and re-conditioning: normalizes splitting
    weights, inverts the Hessian estimate, caps the metric, and precomputes
    the d1 prox weights/thresholds
    (``PFDR_graph_quadratic_d1_l1.cpp:193-267``)."""
    aux = graph.vertex_degree_weighted(wu_raw)  # == sum of w at both ends
    h = h + aux
    inv_aux = _safe_div(1.0, aux, 0.0)
    inv_u, inv_v = graph.gather_endpoints(inv_aux)
    wu = wu_raw * inv_u
    wv = wv_raw * inv_v
    if la_l1 is not None:
        h = h + l1_h_term
    ga = _safe_div(1.0, h, 1.0)
    ga = _metric_cap(ga, rho, lipsch, ltype)

    gau, gav = graph.gather_endpoints(ga)
    w_d1u = wu / gau
    w_d1v = wv / gav
    s = w_d1u + w_d1v
    prod = w_d1u * w_d1v
    th_d1 = jnp.where(prod > 0, graph.la_d1 * _safe_div(s, prod), 0.0)
    w_d1u = _safe_div(w_d1u, s, 0.5)
    w_d1v = _safe_div(w_d1v, s, 0.5)
    if la_l1 is not None:
        th_l1 = ga * la_l1
    else:
        th_l1 = jnp.zeros_like(ga)
    return Precond(ga, wu, wv, w_d1u, w_d1v, th_d1, th_l1)


def initial_precondition(op: QuadOp, obs, graph: GraphD1,
                         la_l1, rho, lipsch, ltype) -> Precond:
    """First preconditioning, from the observation
    (``PFDR_graph_quadratic_d1_l1.cpp:57-268`` with ``P == NULL``)."""
    v = graph.num_vertices
    h = op.gram_diag(v, obs.dtype)
    # per-coordinate pseudo-inverse -> average amplitude scale c
    if op.uses_residual:
        pinv = _safe_div(op.apply_t(obs), h)
    else:
        pinv = _safe_div(obs, h)
    c = _amplitude_scale(graph, pinv, inverse=True)
    w_raw = c * graph.la_d1
    l1_h = c * la_l1 if la_l1 is not None else None
    return _finalize_precond(graph, h, w_raw, w_raw, la_l1, l1_h,
                             rho, lipsch, ltype)


def recondition(op: QuadOp, obs, graph: GraphD1, la_l1, rho, cond_min,
                lipsch, ltype, x, grad, zu, zv, pre: Precond):
    """Reconditioning at the current iterate, preserving subgradients
    (``PFDR_graph_quadratic_d1_l1.cpp:89-99,159-250`` with ``P != NULL``)."""
    # auxiliary subgradients in the old metric (:89-99)
    xu, xv = graph.gather_endpoints(x)
    gau, gav = graph.gather_endpoints(pre.ga)
    gu, gv = graph.gather_endpoints(grad)
    sub_u = (pre.wu / gau) * (xu - gau * gu - zu)
    sub_v = (pre.wv / gav) * (xv - gav * gv - zv)

    v = graph.num_vertices
    h = op.gram_diag(v, obs.dtype)
    c = _amplitude_scale(graph, x, inverse=False)
    # d1 weights from local finite differences (:167-191)
    amp = jnp.maximum(jnp.maximum(jnp.abs(xu), jnp.abs(xv)), c)
    d = jnp.maximum(jnp.abs(xu - xv), cond_min * amp)
    w_raw = _safe_div(graph.la_d1, d)
    if la_l1 is not None:
        l1_h = la_l1 / jnp.maximum(jnp.abs(x), c * cond_min)
    else:
        l1_h = None
    new = _finalize_precond(graph, h, w_raw, w_raw, la_l1, l1_h,
                            rho, lipsch, ltype)
    # re-express auxiliary variables in the new metric (:241-250)
    ngau, ngav = graph.gather_endpoints(new.ga)
    zu = xu - ngau * (gu + _safe_div(sub_u, new.wu))
    zv = xv - ngav * (gv + _safe_div(sub_v, new.wv))
    return new, zu, zv


def _vertex_prox(x, vprox: VertexProx, th_l1):
    if vprox.kind == "l1":
        pos = jnp.maximum(x - th_l1, 0)
        if vprox.positivity:
            return pos
        return pos + jnp.minimum(x + th_l1, 0)
    if vprox.kind == "bounds":
        return jnp.clip(x, vprox.lo, vprox.hi)
    if vprox.positivity:
        return jnp.maximum(x, 0)
    return x


def _grad_and_obj(op: QuadOp, x, obs):
    return op.grad(x, obs), op.quad_obj(x, obs)


def _full_obj(op: QuadOp, x, obs, graph: GraphD1, la_l1, vprox: VertexProx):
    """Objective: quadratic + d1 + (l1) terms
    (``PFDR_graph_quadratic_d1_l1.cpp:388-422``; the reference's stale-index
    bug at :417 is not reproduced)."""
    obj = op.quad_obj(x, obs)
    xu, xv = graph.gather_endpoints(x)
    obj = obj + graph.edge_allsum(graph.la_d1 * jnp.abs(xu - xv))
    if la_l1 is not None and vprox.kind == "l1":
        obj = obj + graph.vertex_allsum(la_l1 * jnp.abs(x))
    return obj


@partial(jax.jit, static_argnames=("vprox", "ltype", "opt", "monitor",
                                   "return_state"))
def pfdr_quadratic_d1(op: QuadOp, obs, graph: GraphD1, *,
                      la_l1=None,
                      vprox: VertexProx = VertexProx(),
                      lipsch=None,
                      ltype: Lipsch = Lipsch.SCAL,
                      x0=None,
                      opt: PFDROptions = PFDROptions(),
                      monitor: bool = False,
                      state0: PFDRSolveState | None = None,
                      return_state: bool = False):
    """Runs the PFDR iteration to convergence (jitted end-to-end).

    Args:
      op: quadratic-term operator (see :mod:`..operators`).
      obs: observation in the operator's convention ([N] or [V]).
      graph: the d1 graph.
      la_l1: optional [V] l1 weights (l1 family only).
      vprox: static vertex-prox description.
      lipsch: optional Lipschitz bound (scalar, or [V] with ``ltype=DIAG``).
      x0: initial iterate (defaults to zeros, as the reference callers use).
      monitor: when True, records objective and evolution traces.
      state0: optional :class:`PFDRSolveState` from an earlier
        ``return_state=True`` call — resumes the loop exactly where it
        stopped (same graph/operator/options required); ``x0`` is ignored.
      return_state: when True, returns ``(result, PFDRSolveState)``.

    Returns:
      :class:`PFDRResult` with the solution, iteration count and traces
      (plus the final solve state when ``return_state``).  Trace contract:
      ``obj`` and ``dif`` are fixed-capacity device arrays of length
      ``it_max + 1`` / ``it_max`` (XLA requires static shapes inside the
      loop); only ``obj[:it + 1]`` and ``dif[:it]`` are meaningful —
      slice before use, as :mod:`..api` does.  When ``monitor=False``
      they are all-zero placeholders.
    """
    vcount = graph.num_vertices
    dtype = obs.dtype
    if x0 is None:
        x0 = jnp.zeros((vcount,), dtype)
    if la_l1 is not None:
        la_l1 = jnp.broadcast_to(jnp.asarray(la_l1, dtype), (vcount,))

    eps_mach = jnp.finfo(dtype).eps
    dif_tol = opt.dif_tol
    eps = dif_tol if (0 < dif_tol < float(eps_mach)) else float(eps_mach)
    dif_tol2 = dif_tol * dif_tol
    dif_rcd2 = opt.dif_rcd * opt.dif_rcd
    rho = jnp.asarray(opt.rho, dtype)

    if state0 is not None:
        pre = state0.pre
        zu, zv = state0.zu, state0.zv
        x0 = state0.x
    else:
        pre = initial_precondition(op, obs, graph, la_l1, opt.rho, lipsch,
                                   ltype)
        zu, zv = graph.gather_endpoints(x0)

    n_trace = opt.it_max + 1 if monitor else 1
    state = PFDRState(
        x=x0, zu=zu, zv=zv, pre=pre,
        x_prev=state0.x_prev if state0 is not None else x0,
        dif=(state0.dif if state0 is not None
             else jnp.asarray(max(dif_tol2, dif_rcd2), dtype)),
        dif_rcd2=(state0.dif_rcd2 if state0 is not None
                  else jnp.asarray(dif_rcd2, dtype)),
        it=(state0.it if state0 is not None
            else jnp.asarray(0, jnp.int32)),
        obj_trace=jnp.zeros((n_trace,), dtype),
        dif_trace=jnp.zeros((n_trace,), dtype),
    )

    def cond(s: PFDRState):
        return jnp.logical_and(s.it < opt.it_max, s.dif >= dif_tol2)

    def body(s: PFDRState) -> PFDRState:
        grad, quad = _grad_and_obj(op, s.x, obs)
        obj_trace = s.obj_trace
        if monitor:
            oxu, oxv = graph.gather_endpoints(s.x)
            obj = quad + graph.edge_allsum(
                graph.la_d1 * jnp.abs(oxu - oxv))
            if la_l1 is not None:
                obj = obj + graph.vertex_allsum(la_l1 * jnp.abs(s.x))
            obj_trace = obj_trace.at[s.it].set(obj)

        # reconditioning (:448-460); statically omitted when disabled
        if opt.dif_rcd > 0:
            def do_recond(args):
                pre, zu, zv, dif_rcd2 = args
                pre, zu, zv = recondition(
                    op, obs, graph, la_l1, opt.rho, opt.cond_min, lipsch,
                    ltype, s.x, grad, zu, zv, pre)
                return pre, zu, zv, dif_rcd2 * jnp.asarray(0.01, dtype)

            pre, zu, zv, dif_rcd2 = jax.lax.cond(
                s.dif < s.dif_rcd2, do_recond, lambda a: a,
                (s.pre, s.zu, s.zv, s.dif_rcd2))
        else:
            pre, zu, zv, dif_rcd2 = s.pre, s.zu, s.zv, s.dif_rcd2

        # forward step P = 2 X - Ga grad (:463-464)
        p = 2.0 * s.x - pre.ga * grad
        # per-edge d1 prox on auxiliary pairs, with relaxation (:466-489)
        pxu, pxv = graph.gather_endpoints(jnp.stack([p, s.x], axis=-1))
        au = pxu[..., 0] - zu
        av = pxv[..., 0] - zv
        pu, pv = d1_pair_prox(au, av, pre.w_d1u, pre.w_d1v, pre.th_d1)
        zu = zu + rho * (pu - pxu[..., 1])
        zv = zv + rho * (pv - pxv[..., 1])
        # weighted average back to the iterate (:491-497)
        x = graph.edge_to_vertex_sum(pre.wu * zu, pre.wv * zv)
        # vertex prox (:499-512)
        x = _vertex_prox(x, vprox, pre.th_l1)
        delta = x - s.x_prev
        num = graph.vertex_allsum(delta * delta)
        den = graph.vertex_allsum(x * x)

        # relative iterate evolution (:514-529)
        num = num.astype(dtype)
        den = den.astype(dtype)
        dif = jnp.where(den > eps, num / den, num / eps)
        dif_trace = s.dif_trace
        if monitor:
            dif_trace = dif_trace.at[s.it].set(dif)

        # progress reporting from inside the jitted loop, every
        # opt.verbose iterations (reference per-iteration printf,
        # PFDR_graph_quadratic_d1_l1.cpp:43-55); statically omitted at 0
        if opt.verbose:
            def _report(it, d):
                print(f"PFDR iteration {int(it)} (max. {opt.it_max}); "
                      f"relative evolution {float(d):.3e} "
                      f"(tol {dif_tol:.1e})", flush=True)

            jax.lax.cond(
                (s.it + 1) % opt.verbose == 0,
                lambda args: jax.debug.callback(_report, *args),
                lambda args: None, (s.it + 1, dif))

        return PFDRState(x=x, zu=zu, zv=zv, pre=pre, x_prev=x,
                         dif=dif, dif_rcd2=dif_rcd2, it=s.it + 1,
                         obj_trace=obj_trace, dif_trace=dif_trace)

    s = jax.lax.while_loop(cond, body, state)
    obj_trace = s.obj_trace
    dif_trace = s.dif_trace
    if monitor:
        obj_trace = obj_trace.at[s.it].set(
            _full_obj(op, s.x, obs, graph, la_l1, vprox))
        # trace hygiene: entries beyond the final iteration are ZERO, not
        # stale loop residue (the fixed-capacity arrays are an XLA
        # static-shape requirement; callers may still slice to it)
        idx = jnp.arange(obj_trace.shape[0])
        obj_trace = jnp.where(idx <= s.it, obj_trace, 0)
        dif_trace = jnp.where(idx[:dif_trace.shape[0]] < s.it, dif_trace, 0)
    res = PFDRResult(x=s.x, it=s.it, obj=obj_trace, dif=dif_trace)
    if return_state:
        return res, PFDRSolveState(x=s.x, zu=s.zu, zv=s.zv, pre=s.pre,
                                   x_prev=s.x_prev, dif=s.dif,
                                   dif_rcd2=s.dif_rcd2, it=s.it)
    return res
