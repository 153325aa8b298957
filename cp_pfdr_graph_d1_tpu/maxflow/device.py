"""Device-resident min-cut: certified binary-TV relaxation (PDHG).

The reference computes the steepest cut with Boykov-Kolmogorov max-flow —
sequential augmenting-path search over pointer-linked trees
(``/root/reference/src/maxflow.cpp:484``), the one component of the
pipeline with no literal data-parallel analog (SURVEY §7 "hard parts").
This module solves the same problem natively on device via the exact
total-variation reformulation of min-cut (Chambolle 2005): the
steepest-cut objective

    min_U  sum_{v in U} c_v  +  sum_{e in boundary(U)} w_e

is the binary restriction of the convex program

    min_{x in [0,1]^V}  <c, x>  +  sum_e w_e |x_u - x_v|,

whose LP relaxation is *tight*: by the coarea formula every super-level
set of a relaxed minimizer is an optimal cut.  The relaxation is solved
with a diagonally preconditioned primal-dual hybrid gradient iteration
(Pock & Chambolle 2011) — per iteration one endpoint gather, one clip, one
incidence-gather accumulation and one clip, i.e. exactly the bulk
edge/vertex map-reduce pattern the rest of this library runs on device
(no pointer chasing, no scatters).

Certification: a feasible dual point ``z`` (|z| <= 1) lower-bounds every
cut by ``sum_v min(0, (c + K^t z)_v)``; the iteration stops when the best
thresholded cut meets that bound within ``tol`` — the returned cut then
carries an optimality certificate, not a heuristic guarantee.

The host push-relabel (``mincut.cpp``) remains the default for the
cut-pursuit outer loop — at reduced-problem sizes the cut is index work,
not FLOPs, and a sequential solver wins; this device path exists for
full-graph cuts at scales where the graph lives on device and host
round-trips dominate (select with ``CPOptions(cut="device")``).
"""
from __future__ import annotations

import warnings
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..graph import GraphD1

_THRESHOLDS = 15   # cut candidates per certificate check (coarea levels)


@partial(jax.jit, static_argnames=("it_max", "check_every"))
def _pdhg_min_cut(graph: GraphD1, w, c, tol, it_max: int, check_every: int,
                  x0=None, z0=None):
    """Jitted PDHG loop; returns (side [V] bool, gap, iterations, x, z).

    ``x0``/``z0`` warm-start the primal/dual state (e.g. from the previous
    cut-pursuit iteration's cut on the same graph — the reference reuses
    its BK graph across iterations the same way,
    ``/root/reference/include/graph.hpp:280``); the duality-gap
    certificate is computed fresh for the given capacities, so a warm
    start can only save iterations, never certify a stale cut."""
    dtype = w.dtype
    v = graph.num_vertices

    # diagonal preconditioning (alpha = 1): tau_v = 1 / sum_{e ~ v} w_e,
    # sigma_e = 1 / (2 w_e) — convergent for any graph, no operator norm
    deg_w = graph.vertex_degree_weighted(w)
    # vertices with no (nonzero-weight) incident edge have an empty K row:
    # any step size is admissible — pick one that resolves their purely
    # linear subproblem (x -> 0 or 1 by sign of c) in a single step
    tau = jnp.where(deg_w > 0, 1.0 / jnp.maximum(deg_w, 1e-30),
                    1.0 / jnp.maximum(jnp.abs(c), 1e-12))
    sigma = jnp.where(w > 0, 0.5 / jnp.maximum(w, 1e-30), 0.0)

    ts = jnp.linspace(0.03, 0.97, _THRESHOLDS, dtype=dtype)

    def cut_values(x):
        """Objective of the _THRESHOLDS super-level-set cuts of x."""
        side = x[:, None] > ts[None, :]                    # [V, T]
        lin = jnp.sum(jnp.where(side, c[:, None], 0), axis=0)
        su, sv = graph.gather_endpoints(side)              # [E, T]
        bnd = jnp.sum(jnp.where(su != sv, w[:, None], 0), axis=0)
        return lin + bnd

    def gap_state(x, z):
        ktz = graph.edge_to_vertex_sum(w * z, -(w * z))
        dual = jnp.sum(jnp.minimum(c + ktz, 0))
        vals = cut_values(x)
        best = jnp.argmin(vals)
        return vals[best], dual, ts[best]

    def pdhg_chunk(carry, _):
        x, xb, z = carry
        xbu, xbv = graph.gather_endpoints(xb)
        z = jnp.clip(z + sigma * w * (xbu - xbv), -1, 1)
        ktz = graph.edge_to_vertex_sum(w * z, -(w * z))
        x_new = jnp.clip(x - tau * (ktz + c), 0, 1)
        return (x_new, 2 * x_new - x, z), None

    def cond(state):
        x, xb, z, it, gap, _ = state
        return jnp.logical_and(it < it_max, gap > tol)

    def body(state):
        x, xb, z, it, _, _ = state
        (x, xb, z), _ = jax.lax.scan(pdhg_chunk, (x, xb, z), None,
                                     length=check_every)
        primal, dual, t_best = gap_state(x, z)
        return x, xb, z, it + check_every, primal - dual, t_best

    if x0 is None:
        x0 = jnp.full((v,), 0.5, dtype)
    if z0 is None:
        z0 = jnp.zeros_like(w)
    state = (x0, x0, z0, jnp.asarray(0),
             jnp.asarray(jnp.inf, dtype), ts[0])
    x, _, z, it, gap, t_best = jax.lax.while_loop(cond, body, state)
    return x > t_best, gap, it, x, z


def min_cut_device(num_vertices: int, eu, ev, w, c, *,
                   graph: GraphD1 | None = None,
                   tol: float = 1e-6, it_max: int = 200_000,
                   check_every: int = 250,
                   dtype=jnp.float32, return_gap: bool = False):
    """Device-resident drop-in for :func:`..maxflow.min_cut`.

    Returns ``side`` (uint8 [V], 1 for vertices in the minimizing U), or
    ``(side, gap, certified)`` when ``return_gap`` is set.  Infinite
    entries of ``c`` are clamped beyond any finite cut, as in the host
    solver.  ``tol`` is the absolute duality-gap certificate the returned
    cut satisfies (relative to the problem's cost scale); if the PDHG
    iteration exits at ``it_max`` with the gap still above it, the cut is
    NOT certified optimal — a :class:`UserWarning` is emitted (the
    reference's analog is its ``test_consistency`` debug checker,
    ``/root/reference/src/maxflow.cpp:633``; cut-pursuit falls back to
    the host solver in that case, see ``solvers/cut_pursuit.py``).
    """
    w = np.asarray(w, np.float64)
    c = np.asarray(c, np.float64)
    big = 1.0 + 2.0 * (float(np.sum(w[np.isfinite(w)]))
                       + float(np.sum(np.abs(c[np.isfinite(c)]))))
    c = np.clip(c, -big, big)
    w = np.minimum(w, big)
    if graph is None:
        graph = GraphD1.create(eu, ev, w, num_vertices=num_vertices,
                               dtype=dtype)
    scale = max(big, 1.0)
    side, gap, it, _, _ = _pdhg_min_cut(graph, jnp.asarray(w, dtype),
                                        jnp.asarray(c, dtype),
                                        jnp.asarray(tol * scale, dtype),
                                        it_max, check_every)
    side = np.asarray(jax.device_get(side)).astype(np.uint8)
    gap = float(gap)
    certified = gap <= tol * scale
    if not certified:
        warnings.warn(
            f"device min-cut exited at it_max={it_max} with duality gap "
            f"{gap:.3g} > certificate {tol * scale:.3g}; the returned cut "
            "is not certified optimal", UserWarning, stacklevel=2)
    if return_gap:
        return side, gap, certified
    return side


def min_cut_device_with_fallback(num_vertices: int, eu, ev, w, c, *,
                                 tol: float = 1e-6,
                                 it_max: int = 200_000,
                                 check_every: int = 250) -> np.ndarray:
    """Device min-cut that falls back to the host push-relabel when the
    duality-gap certificate fails — cut-pursuit's steepest cut must be
    exact, so an uncertified relaxation result is never used silently."""
    side, _, certified = min_cut_device(num_vertices, eu, ev, w, c,
                                        tol=tol, it_max=it_max,
                                        check_every=min(check_every,
                                                        it_max),
                                        return_gap=True)
    if certified:
        return side
    warnings.warn("falling back to the host min-cut solver for this cut",
                  UserWarning, stacklevel=2)
    from . import min_cut
    return min_cut(num_vertices, eu, ev, w, c)


@partial(jax.jit, static_argnames=("it_max", "check_every"))
def _pdhg_min_cut_directed(graph: GraphD1, w_uv, w_vu, c, tol,
                           it_max: int, check_every: int):
    """Directed-capacity twin of :func:`_pdhg_min_cut`: minimizes
    ``sum_{v in U} c_v + sum_e w_uv [u in U, v not] + w_vu [v in U, u not]``
    via the tight LP relaxation with the one-sided (asymmetric) dual box
    ``z_e in [-w_vu, w_uv]`` — ``w_uv max(0,d) + w_vu max(0,-d) =
    max_{-w_vu<=z<=w_uv} z d``.  Same coarea tightness and duality-gap
    certificate as the undirected solver."""
    dtype = w_uv.dtype
    v = graph.num_vertices
    wbar = jnp.maximum(w_uv, w_vu)                     # K row scale
    lo = -jnp.where(wbar > 0, w_vu / jnp.maximum(wbar, 1e-30), 0.0)
    hi = jnp.where(wbar > 0, w_uv / jnp.maximum(wbar, 1e-30), 0.0)

    deg_w = graph.vertex_degree_weighted(wbar)
    tau = jnp.where(deg_w > 0, 1.0 / jnp.maximum(deg_w, 1e-30),
                    1.0 / jnp.maximum(jnp.abs(c), 1e-12))
    sigma = jnp.where(wbar > 0, 0.5 / jnp.maximum(wbar, 1e-30), 0.0)

    ts = jnp.linspace(0.03, 0.97, _THRESHOLDS, dtype=dtype)

    def cut_values(x):
        side = x[:, None] > ts[None, :]                # [V, T]
        lin = jnp.sum(jnp.where(side, c[:, None], 0), axis=0)
        su, sv = graph.gather_endpoints(side)          # [E, T]
        bnd = jnp.sum(jnp.where(su & ~sv, w_uv[:, None], 0)
                      + jnp.where(sv & ~su, w_vu[:, None], 0), axis=0)
        return lin + bnd

    def gap_state(x, z):
        ktz = graph.edge_to_vertex_sum(wbar * z, -(wbar * z))
        dual = jnp.sum(jnp.minimum(c + ktz, 0))
        vals = cut_values(x)
        best = jnp.argmin(vals)
        return vals[best], dual, ts[best]

    def pdhg_chunk(carry, _):
        x, xb, z = carry
        xbu, xbv = graph.gather_endpoints(xb)
        z = jnp.clip(z + sigma * wbar * (xbu - xbv), lo, hi)
        ktz = graph.edge_to_vertex_sum(wbar * z, -(wbar * z))
        x_new = jnp.clip(x - tau * (ktz + c), 0, 1)
        return (x_new, 2 * x_new - x, z), None

    def cond(state):
        x, xb, z, it, gap, _ = state
        return jnp.logical_and(it < it_max, gap > tol)

    def body(state):
        x, xb, z, it, _, _ = state
        (x, xb, z), _ = jax.lax.scan(pdhg_chunk, (x, xb, z), None,
                                     length=check_every)
        primal, dual, t_best = gap_state(x, z)
        return x, xb, z, it + check_every, primal - dual, t_best

    x0 = jnp.full((v,), 0.5, dtype)
    state = (x0, x0, jnp.zeros_like(w_uv), jnp.asarray(0),
             jnp.asarray(jnp.inf, dtype), ts[0])
    x, _, z, it, gap, t_best = jax.lax.while_loop(cond, body, state)
    return x > t_best, gap, it


def min_cut_directed_device(num_vertices: int, eu, ev, w_uv, w_vu, c, *,
                            tol: float = 1e-6, it_max: int = 200_000,
                            check_every: int = 250, dtype=jnp.float32,
                            return_gap: bool = False):
    """Device-resident drop-in for :func:`..maxflow.min_cut_directed`
    (per-direction arc capacities; the toolchain-free path for the duplex
    ternary cut, ``CP_PFDR_graph_quadratic_d1_l1_duplex.cpp:88-115``)."""
    w_uv = np.asarray(w_uv, np.float64)
    w_vu = np.asarray(w_vu, np.float64)
    c = np.asarray(c, np.float64)
    big = 1.0 + 2.0 * (float(np.sum(w_uv[np.isfinite(w_uv)]))
                       + float(np.sum(w_vu[np.isfinite(w_vu)]))
                       + float(np.sum(np.abs(c[np.isfinite(c)]))))
    c = np.clip(c, -big, big)
    w_uv = np.minimum(w_uv, big)
    w_vu = np.minimum(w_vu, big)
    graph = GraphD1.create(eu, ev, np.maximum(w_uv, w_vu),
                           num_vertices=num_vertices, dtype=dtype)
    scale = max(big, 1.0)
    side, gap, _ = _pdhg_min_cut_directed(
        graph, jnp.asarray(w_uv, dtype), jnp.asarray(w_vu, dtype),
        jnp.asarray(c, dtype), jnp.asarray(tol * scale, dtype),
        it_max, check_every)
    side = np.asarray(jax.device_get(side)).astype(np.uint8)
    gap = float(gap)
    certified = gap <= tol * scale
    if not certified:
        warnings.warn(
            f"device directed min-cut exited at it_max={it_max} with "
            f"duality gap {gap:.3g} > certificate {tol * scale:.3g}; the "
            "returned cut is not certified optimal", UserWarning,
            stacklevel=2)
    if return_gap:
        return side, gap, certified
    return side


@partial(jax.jit, static_argnames=("it_max", "check_every"))
def _pdhg_min_cut_duplex(graph: GraphD1, w, c1, c2, m, tol,
                         it_max: int, check_every: int,
                         x0=None, z0=None, zv0=None):
    """Container-aware two-layer (duplex) ternary cut: the relaxation of
    the reference's 2V-node graph (``CP_PFDR_graph_quadratic_d1_l1_duplex
    .cpp:88-115,470-545``) with the layers as a trailing axis — d1 weights
    ``w`` duplicated on both layers, a per-vertex inter-layer term
    ``m_v max(0, x2_v - x1_v)`` encoding the ternary direction, unary
    costs ``c1``/``c2`` per layer.  Thresholding BOTH layers at a common
    level is a valid cut by the coarea formula, so the duality-gap
    certificate carries over.  Returns (side [V, 2] bool, gap, it)."""
    dtype = w.dtype
    v = graph.num_vertices

    deg_w = graph.vertex_degree_weighted(w)
    den = deg_w + m
    cc = jnp.stack([c1, c2], axis=1)                   # [V, 2]
    tau = jnp.where(den > 0, 1.0 / jnp.maximum(den, 1e-30),
                    1.0 / jnp.maximum(jnp.max(jnp.abs(cc), axis=1), 1e-12))
    tau = tau[:, None]
    sigma_e = jnp.where(w > 0, 0.5 / jnp.maximum(w, 1e-30), 0.0)[:, None]
    sigma_v = jnp.where(m > 0, 0.5 / jnp.maximum(m, 1e-30), 0.0)

    ts = jnp.linspace(0.03, 0.97, _THRESHOLDS, dtype=dtype)

    def kt(z, zv):
        """Adjoint: d1 rows on both layers + the inter-layer rows."""
        wz = w[:, None] * z                            # [E, 2]
        out = graph.edge_to_vertex_sum(wz, -wz)        # [V, 2]
        inter = (m * zv)[:, None] * jnp.asarray([-1.0, 1.0], dtype)
        return out + inter

    def cut_values(x):
        side = x[:, :, None] > ts[None, None, :]       # [V, 2, T]
        lin = jnp.sum(jnp.where(side, cc[:, :, None], 0), axis=(0, 1))
        inter = jnp.sum(jnp.where(side[:, 1, :] & ~side[:, 0, :],
                                  m[:, None], 0), axis=0)
        su, sv = graph.gather_endpoints(side)          # [E, 2, T]
        bnd = jnp.sum(jnp.where(su != sv, w[:, None, None], 0),
                      axis=(0, 1))
        return lin + inter + bnd

    def gap_state(x, z, zv):
        g = cc + kt(z, zv)
        dual = jnp.sum(jnp.minimum(g, 0))
        vals = cut_values(x)
        best = jnp.argmin(vals)
        return vals[best], dual, ts[best]

    def pdhg_chunk(carry, _):
        x, xb, z, zv = carry
        xbu, xbv = graph.gather_endpoints(xb)          # [E, 2]
        z = jnp.clip(z + sigma_e * w[:, None] * (xbu - xbv), -1, 1)
        zv = jnp.clip(zv + sigma_v * m * (xb[:, 1] - xb[:, 0]), 0, 1)
        x_new = jnp.clip(x - tau * (kt(z, zv) + cc), 0, 1)
        return (x_new, 2 * x_new - x, z, zv), None

    def cond(state):
        x, xb, z, zv, it, gap, _ = state
        return jnp.logical_and(it < it_max, gap > tol)

    def body(state):
        x, xb, z, zv, it, _, _ = state
        (x, xb, z, zv), _ = jax.lax.scan(pdhg_chunk, (x, xb, z, zv), None,
                                         length=check_every)
        primal, dual, t_best = gap_state(x, z, zv)
        return x, xb, z, zv, it + check_every, primal - dual, t_best

    if x0 is None:
        x0 = jnp.full((v, 2), 0.5, dtype)
    if z0 is None:
        z0 = jnp.zeros((graph.num_edges, 2), dtype)
    if zv0 is None:
        zv0 = jnp.zeros((v,), dtype)
    state = (x0, x0, z0, zv0, jnp.asarray(0),
             jnp.asarray(jnp.inf, dtype), ts[0])
    x, _, z, zv, it, gap, t_best = jax.lax.while_loop(cond, body, state)
    return x > t_best, gap, it, x, z, zv


def cut_value(eu, ev, w, c, side) -> float:
    """Objective ``sum_{v in U} c_v + boundary weight`` of a given cut."""
    side = np.asarray(side, bool)
    w = np.asarray(w, np.float64)
    c = np.asarray(c, np.float64)
    fin_c = np.where(np.isfinite(c), c, 0)
    val = float(np.sum(fin_c[side]))
    val += float(np.sum(w[side[np.asarray(eu)] != side[np.asarray(ev)]]))
    return val
