"""Device-resident cut-pursuit iteration for quadratic + d1 (+l1/bounds).

The host solver (:mod:`.cut_pursuit`) round-trips O(E) arrays per CP
iteration — the gradient comes down for the min-cut, the active mask and
component labels live on host, the contraction runs in numpy.  This
module keeps the entire iteration device-resident, as SURVEY §7's hard
parts (1)-(2) prescribe:

* steepest cut: the certified binary-TV PDHG relaxation
  (:mod:`..maxflow.device`) on the standing full graph with active edges
  masked to zero weight (a zero-weight edge never constrains the cut);
* connected components: min-label propagation + pointer jumping
  (:func:`..ops.components.connected_components_device`), compacted to
  first-encounter order on device (matches the reference's DFS numbering,
  ``CP_PFDR_graph_quadratic_d1_l1.cpp:570-596``);
* reduced-graph contraction: sort + run-length segment sums over the
  active edges' component-pair keys (``:607-661``) — no scatters, static
  ``re_cap`` capacity, padded with inert zero-weight self-loops.  Every
  live component gets an ``eps`` self-loop (the reference adds them to
  isolated components only; an extra eps self-loop contributes
  ``eps * |x_c - x_c| = 0`` to the objective, so the minimizer is
  unchanged — only the preconditioner sees a negligible eps);
* merge and evolution tests: elementwise on device.

Host traffic per iteration: five scalars (new-edge count, component
count, reduced-edge count, duality gap, evolution) — o(E) — plus the
O(rV) reduced values only when the caller asks for them at the end.

Selected via ``cp_quadratic_d1(..., opt=CPOptions(cut="device"))`` for
non-duplex problems; an uncertified cut falls back to the host solver for
that iteration (with a warning), never silently.
"""
from __future__ import annotations

import os as _os
import time as _time
import warnings
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from .. import maxflow
from ..config import CPOptions, Lipsch
from ..graph import GraphD1
from ..maxflow.device import _pdhg_min_cut
from ..operators import DenseOp, DiagOp, GramOp, IdentityOp, QuadOp
from ..ops.components import connected_components_device
from .cut_pursuit import CPResult, CPState, _reduce_dense, _reduce_diag, \
    _reduce_gram
from .cut_pursuit_common import bucket, machine_eps, make_reduced_container
from .pfdr_quadratic import VertexProx, pfdr_quadratic_d1

# above this component count, one-hot [V, rV] contractions are replaced by
# sorted run-length segment sums (the one-hot selector matrix would cost
# O(V * rV) memory)
_ONEHOT_MAX = 4096
_INT_SENTINEL = np.int32(2**31 - 1)


@partial(jax.jit, static_argnames=("lo", "hi", "differentiable", "has_l1",
                                   "positivity"))
def _direction_costs(op: QuadOp, obs, graph: GraphD1, x, active, la_l1, *,
                     lo: float, hi: float, differentiable: bool,
                     has_l1: bool, positivity: bool):
    """Gradient of the smooth part + d1/l1 subgradient terms, then the one
    or two cut unary-cost vectors (``CP_PFDR_graph_quadratic_d1_l1.cpp:
    339-549``), entirely on device."""
    dfs = op.grad(x, obs)
    xu, xv = graph.gather_endpoints(x)
    s = jnp.sign(xu - xv) * graph.la_d1 * active
    dfs = dfs + graph.edge_to_vertex_sum(s, -s)
    if has_l1:
        dfs = dfs + jnp.sign(x) * la_l1
    if differentiable:
        return dfs, dfs
    zero = x == 0
    if has_l1:
        c1 = dfs + jnp.where(zero, la_l1, 0.0)
        if positivity:
            c2 = jnp.where(zero, jnp.inf, -dfs)
        else:
            c2 = -dfs + jnp.where(zero, la_l1, 0.0)
    else:
        c1 = jnp.where(x == hi, jnp.inf, dfs) if np.isfinite(hi) else dfs
        c2 = jnp.where(x == lo, jnp.inf, -dfs) if np.isfinite(lo) \
            else -dfs
    return c1, c2


@partial(jax.jit, static_argnames=("has_l1", "positivity"))
def _duplex_costs(op: QuadOp, obs, graph: GraphD1, x, active, la_l1, *,
                  has_l1: bool, positivity: bool):
    """Layer costs and inter-layer capacities of the duplex ternary cut
    (``CP_PFDR_graph_quadratic_d1_l1_duplex.cpp:470-511``), on device:
    ``up``/``do`` directional derivatives (+-la_l1 at zeros, -inf down
    under positivity), ``m = max(0, -up, do)``."""
    dfs = op.grad(x, obs)
    xu, xv = graph.gather_endpoints(x)
    s = jnp.sign(xu - xv) * graph.la_d1 * active
    dfs = dfs + graph.edge_to_vertex_sum(s, -s)
    if has_l1:
        dfs = dfs + jnp.sign(x) * la_l1
    zero = x == 0
    if has_l1:
        up = dfs + jnp.where(zero, la_l1, 0.0)
        do = dfs - jnp.where(zero, la_l1, 0.0)
    else:
        up = do = dfs
    if positivity:
        do = jnp.where(zero, -jnp.inf, do)
    m = jnp.maximum(0.0, jnp.maximum(-up, do))
    return -do + m, -(up + m), m


@partial(jax.jit, static_argnames=("it_max", "check_every"))
def _device_cut_duplex(graph: GraphD1, active, c1, c2, m, tol,
                       it_max: int, check_every: int,
                       x0=None, z0=None, zv0=None):
    """One duplex ternary cut on the standing graph; returns (separation
    mask over edges — separated on either layer —, duality gap, scale)."""
    from ..maxflow.device import _pdhg_min_cut_duplex
    w = jnp.where(active, 0.0, graph.la_d1)

    def finsum(arr):
        return jnp.sum(jnp.where(jnp.isfinite(arr), jnp.abs(arr), 0.0))

    big = 1.0 + 2.0 * (2.0 * jnp.sum(w) + finsum(c1) + finsum(c2)
                       + jnp.sum(m))
    c1c = jnp.clip(jnp.where(jnp.isfinite(c1), c1, big), -big, big)
    c2c = jnp.clip(jnp.where(jnp.isfinite(c2), c2, big), -big, big)
    side, gap, _, x, z, zv = _pdhg_min_cut_duplex(
        graph, w, c1c.astype(w.dtype), c2c.astype(w.dtype),
        m.astype(w.dtype), (tol * big).astype(w.dtype), it_max,
        check_every, x0, z0, zv0)
    su, sv = graph.gather_endpoints(side)              # [E, 2]
    sep = jnp.any(su != sv, axis=1) & ~active & (graph.la_d1 > 0)
    return sep, gap, big, x, z, zv


@partial(jax.jit, static_argnames=("it_max", "check_every"))
def _device_cut(graph: GraphD1, active, c, tol, it_max: int,
                check_every: int, x0=None, z0=None):
    """One steepest cut on the standing graph (active edges weight-masked
    out); returns (separation mask over edges, duality gap, scale, and the
    relaxed (x, z) state for warm-starting the next iteration's cut — the
    reference's analog is reusing its BK graph across CP iterations,
    ``/root/reference/include/graph.hpp:280``)."""
    w = jnp.where(active, 0.0, graph.la_d1)
    big = 1.0 + 2.0 * (jnp.sum(w) + jnp.sum(jnp.where(
        jnp.isfinite(c), jnp.abs(c), 0.0)))
    c_cl = jnp.clip(jnp.where(jnp.isfinite(c), c, big), -big, big)
    side, gap, _, x, z = _pdhg_min_cut(graph, w, c_cl.astype(w.dtype),
                                       (tol * big).astype(w.dtype), it_max,
                                       check_every, x0, z0)
    su, sv = graph.gather_endpoints(side)
    return (su != sv) & ~active & (graph.la_d1 > 0), gap, big, x, z


@jax.jit
def _device_components(graph: GraphD1, active):
    """Labels of the inactive-(nonzero)-edge components, compacted to
    first-encounter order on device; returns (cv, num_comp, firsts)."""
    mask = ~active & (graph.la_d1 > 0)
    roots = connected_components_device(graph, mask)
    firsts = roots == jnp.arange(graph.num_vertices, dtype=jnp.int32)
    mapping = jnp.cumsum(firsts.astype(jnp.int32)) - 1
    return mapping[roots], jnp.sum(firsts.astype(jnp.int32)), firsts


@jax.jit
def _contract_sort(cv, graph: GraphD1, active):
    """Phase A of the device contraction: component-pair-sorted edges and
    weights of the active nonzero edges, plus the unique-run count.  Pairs
    are lexsorted as (lo, hi) int32 columns — no packed-key overflow, any
    component count."""
    sel = active & (graph.la_d1 > 0)
    cu, cvv = graph.gather_endpoints(cv)
    lo = jnp.where(sel, jnp.minimum(cu, cvv), _INT_SENTINEL)
    hi = jnp.where(sel, jnp.maximum(cu, cvv), _INT_SENTINEL)
    order = jnp.lexsort((hi, lo))
    lo, hi = lo[order], hi[order]
    w = jnp.where(sel, graph.la_d1, 0.0)[order]
    prev_lo = jnp.concatenate([jnp.full((1,), -1, lo.dtype), lo[:-1]])
    prev_hi = jnp.concatenate([jnp.full((1,), -1, hi.dtype), hi[:-1]])
    flags = ((lo != prev_lo) | (hi != prev_hi)) & (lo != _INT_SENTINEL)
    return lo, hi, w, flags, jnp.sum(flags.astype(jnp.int32))


@partial(jax.jit, static_argnames=("dtype", "rv_cap", "re_cap"))
def _contract_pad(lo, hi, w, flags, num_comp, eps, dtype,
                  rv_cap: int, re_cap: int):
    """Phase B: run-length weight sums at static capacity, plus an eps
    self-loop for every live component (see module docstring)."""
    e = lo.shape[0]
    starts = jnp.nonzero(flags, size=re_cap, fill_value=e)[0]
    valid = starts < e
    nxt = jnp.concatenate([starts[1:], jnp.full((1,), e, starts.dtype)])
    # run i spans [starts[i], next start) in the sorted order; nxt for the
    # last valid run is a padded `e`, which the inclusive prefix handles
    prefix = jnp.concatenate([jnp.zeros((1,), w.dtype), jnp.cumsum(w)])
    nxt = jnp.where(valid, nxt, e)
    wsum = prefix[nxt] - prefix[jnp.where(valid, starts, e)]
    safe = jnp.where(valid, starts, 0)
    reu = jnp.where(valid, lo[safe], 0).astype(jnp.int32)
    rev = jnp.where(valid, hi[safe], 0).astype(jnp.int32)
    # inert padding: zero-weight self-loops spread over components
    spread = (jnp.arange(re_cap, dtype=jnp.int32) % rv_cap)
    reu = jnp.where(valid, reu, spread)
    rev = jnp.where(valid, rev, spread)
    rla = jnp.where(valid, wsum, 0.0).astype(dtype)
    # eps self-loop on every live component (inert beyond num_comp)
    iota = jnp.arange(rv_cap, dtype=jnp.int32)
    eps_la = jnp.where(iota < num_comp, eps, 0.0).astype(dtype)
    return (jnp.concatenate([reu, iota]), jnp.concatenate([rev, iota]),
            jnp.concatenate([rla, eps_la]))


@partial(jax.jit, static_argnames=("rv_cap",))
def _vertex_runs(cv, rv_cap: int):
    """Vertices sorted by component label; since labels are contiguous
    first-encounter ints, sorted run ``i`` IS component ``i``.  Returns
    (order, run starts [rv_cap], padded with V)."""
    v = cv.shape[0]
    order = jnp.argsort(cv)
    cs = cv[order]
    flags = cs != jnp.concatenate([jnp.full((1,), -1, cs.dtype), cs[:-1]])
    starts = jnp.nonzero(flags, size=rv_cap, fill_value=v)[0]
    return order, starts


@partial(jax.jit, static_argnames=("rv_cap",))
def _reduce_vertex_terms(cv, x, la_l1, firsts, rv_cap: int):
    """Reduced l1 weights (summed per component) and the warm-start values
    (any representative; components are constant), on device."""
    if rv_cap <= _ONEHOT_MAX:
        s = jax.nn.one_hot(cv, rv_cap, dtype=x.dtype)
        r_la_l1 = jnp.matmul(la_l1, s,
                             precision=jax.lax.Precision.HIGHEST)
    else:
        order, starts = _vertex_runs(cv, rv_cap)
        v = cv.shape[0]
        prefix = jnp.concatenate([jnp.zeros((1,), la_l1.dtype),
                                  jnp.cumsum(la_l1[order])])
        nxt = jnp.concatenate([starts[1:],
                               jnp.full((1,), v, starts.dtype)])
        r_la_l1 = prefix[jnp.where(starts < v, nxt, v)] - prefix[starts]
    reps = jnp.nonzero(firsts, size=rv_cap, fill_value=0)[0]
    rx0 = x[reps]
    return r_la_l1, rx0


@partial(jax.jit, static_argnames=("rv_cap", "pre_at"))
def _segment_reduce_dense(a, obs, cv, rv_cap: int, pre_at: bool):
    """Large-rV dense reduction: per-component column sums of ``A`` via
    sorted run-length segment sums — O(V N) memory, no [V, rV] one-hot
    (``CP_PFDR_graph_quadratic_d1_l1.cpp:663-836`` at scale).  ``pre_at``
    must be False (the [rV, rV] Gram would not fit anyway; the reference's
    premultiplication rule never selects it at rV >> N)."""
    from ..ops.power_iter import dense_operator_norm

    del pre_at  # always the direct (non-premultiplied) branch
    v = cv.shape[0]
    order, starts = _vertex_runs(cv, rv_cap)
    at_sorted = a.T[order]                         # [V, N]
    prefix = jnp.concatenate(
        [jnp.zeros((1, a.shape[0]), a.dtype),
         jnp.cumsum(at_sorted, axis=0)])           # [V+1, N]
    nxt = jnp.concatenate([starts[1:], jnp.full((1,), v, starts.dtype)])
    ra = (prefix[jnp.where(starts < v, nxt, v)] - prefix[starts]).T
    cn = jnp.sqrt(jnp.sum(ra * ra, axis=0))
    cn_safe = jnp.where(cn > 0, cn, 1)
    eq = ra / cn_safe
    # cost rule (operator_norm_matrix.cpp:116): at rV >> N this always
    # routes to the [N, N] Gram iteration
    c = dense_operator_norm(eq)
    return ra, obs, cn * cn * c


@partial(jax.jit, static_argnames=("rv_cap",))
def _segment_reduce_diag(diag, obs, cv, rv_cap: int):
    """Large-rV diagonal reduction via the same run-length machinery."""
    v = cv.shape[0]
    order, starts = _vertex_runs(cv, rv_cap)
    nxt = jnp.concatenate([starts[1:], jnp.full((1,), v, starts.dtype)])
    end = jnp.where(starts < v, nxt, v)

    def runsum(vec):
        prefix = jnp.concatenate([jnp.zeros((1,), vec.dtype),
                                  jnp.cumsum(vec[order])])
        return prefix[end] - prefix[starts]

    rdiag = runsum(diag)
    return rdiag, runsum(obs), rdiag


@jax.jit
def _device_merge(graph: GraphD1, x, active, eps, dif_tol):
    """Deactivates active edges whose endpoint components are relatively
    equal (``CP_PFDR_graph_quadratic_d1_l1.cpp:863-886``)."""
    xu, xv = graph.gather_endpoints(x)
    d = jnp.abs(xu - xv)
    amax = jnp.maximum(jnp.abs(xu), jnp.abs(xv))
    rel = jnp.where(amax > eps, d / jnp.maximum(amax, eps), d / eps)
    return active & ~(rel <= dif_tol)


@jax.jit
def _evolution(x, x_prev, eps):
    delta = x - x_prev
    num = jnp.vdot(delta, delta)
    den = jnp.vdot(x, x)
    return jnp.where(den > eps, num / den, num / eps)


_DEBUG = bool(_os.environ.get("CPDEV_DEBUG"))


def _dbg(label, *arrays):
    """Optional stage-by-stage sync + timestamped trace (CPDEV_DEBUG=1)."""
    if _DEBUG:
        for a in arrays:
            jax.block_until_ready(a)
        print(f"[cpdev {_time.monotonic():.1f}] {label}", flush=True)


def cp_quadratic_d1_device(op: QuadOp, obs, graph: GraphD1, *,
                           la_l1=None, positivity: bool = False,
                           bounds=None, duplex: bool = False,
                           opt: CPOptions = CPOptions(),
                           monitor: bool = False,
                           state: CPState | None = None) -> CPResult:
    """Device-resident cut-pursuit solve (same contract as
    :func:`.cut_pursuit.cp_quadratic_d1`); see module docstring."""
    t0 = _time.monotonic()
    num_v = graph.num_vertices
    dtype = np.asarray(obs).dtype
    obs_dev = jnp.asarray(obs)

    lo, hi = (-np.inf, np.inf) if bounds is None else (
        float(bounds[0]), float(bounds[1]))
    has_l1 = la_l1 is not None
    if has_l1:
        la_l1_dev = jnp.asarray(
            np.broadcast_to(np.asarray(la_l1, dtype), (num_v,)))
    elif positivity:
        has_l1 = True
        la_l1_dev = jnp.zeros((num_v,), dtype)
    else:
        la_l1_dev = jnp.zeros((num_v,), dtype)
    differentiable = (not has_l1
                      and not (np.isfinite(lo) or np.isfinite(hi)))
    if bounds is not None:
        vprox = VertexProx(kind="bounds", lo=lo, hi=hi)
    elif has_l1:
        vprox = VertexProx(kind="l1", positivity=positivity)
    else:
        vprox = VertexProx()

    eps = machine_eps(dtype, opt.dif_tol)
    dif_tol2 = opt.dif_tol * opt.dif_tol

    # -- initialization: single component, scalar prox (:66-175) -----------
    if state is None:
        ry1, raa1 = map(float, jax.device_get(
            jnp.stack(op.ones_image(num_v, obs_dev))))
        if bounds is not None:
            x1 = min(max(ry1 / raa1, lo), hi)
        else:
            rl1 = float(jnp.sum(la_l1_dev)) if has_l1 else 0.0
            if ry1 > rl1:
                x1 = (ry1 - rl1) / raa1
            elif not positivity and ry1 < -rl1:
                x1 = (ry1 + rl1) / raa1
            else:
                x1 = 0.0
        active = jnp.zeros((graph.num_edges,), bool)
        cv = jnp.zeros((num_v,), jnp.int32)
        x_full = jnp.full((num_v,), x1, dtype)
    else:
        active = jnp.asarray(state.active)
        cv = jnp.asarray(state.cv)
        x_full = jnp.asarray(state.rx[state.cv], dtype)

    times = [0.0]
    objs = []
    difs = []
    x_prev = x_full
    if monitor:
        from .cut_pursuit import _objective
        objs.append(float(_objective(
            op, obs_dev, x_full, graph, la_l1_dev,
            jnp.asarray(1.0 if has_l1 else 0.0, dtype))))

    pfdr_it_prev = opt.pfdr.it_max
    it = 0
    dif = max(dif_tol2, 1.0)
    num_comp = 1

    use_duplex = duplex and not differentiable and bounds is None
    # warm-start carries for the PDHG cuts (per direction / layer)
    cut1_x = cut1_z = cut2_x = cut2_z = dup_zv = None
    while it < opt.it_max and dif >= dif_tol2:
        # -- steepest cut, on device (:337-549; duplex :470-545) ------------
        chk = min(250, opt.cut_it_max)
        if use_duplex:
            d_c1, d_c2, d_m = _duplex_costs(
                op, obs_dev, graph, x_full, active, la_l1_dev,
                has_l1=has_l1, positivity=positivity)
            _dbg("duplex_costs", d_c1, d_c2)
            sep, gap1, big1, cut1_x, cut1_z, dup_zv = _device_cut_duplex(
                graph, active, d_c1, d_c2, d_m, opt.cut_tol,
                opt.cut_it_max, chk, cut1_x, cut1_z, dup_zv)
            certified = float(gap1) <= opt.cut_tol * float(big1)
            if not certified:
                warnings.warn("falling back to the host min-cut solver "
                              "for this duplex cut", UserWarning,
                              stacklevel=2)
                sep = _host_duplex_fallback(graph, active, d_c1, d_c2, d_m)
        else:
            c1, c2 = _direction_costs(
                op, obs_dev, graph, x_full, active, la_l1_dev, lo=lo,
                hi=hi, differentiable=differentiable, has_l1=has_l1,
                positivity=positivity)
            _dbg("direction_costs", c1, c2)
            sep, gap1, big1, cut1_x, cut1_z = _device_cut(
                graph, active, c1, opt.cut_tol, opt.cut_it_max, chk,
                cut1_x, cut1_z)
            certified = float(gap1) <= opt.cut_tol * float(big1)
            if not differentiable:
                sep2, gap2, big2, cut2_x, cut2_z = _device_cut(
                    graph, active, c2, opt.cut_tol, opt.cut_it_max, chk,
                    cut2_x, cut2_z)
                certified &= float(gap2) <= opt.cut_tol * float(big2)
                sep = sep | sep2
            if not certified:
                # exactness guard: redo this iteration's cuts on host
                warnings.warn("falling back to the host min-cut solver "
                              "for this cut", UserWarning, stacklevel=2)
                sep = _host_cut_fallback(graph, active, c1, c2 if not
                                         differentiable else None)
        _dbg("cuts")
        n_new = int(jnp.sum(sep))
        active = active | sep

        if n_new == 0:  # nothing to recompute (:556-563)
            difs.append(0.0)
            dif = 0.0
            it += 1
            times.append(_time.monotonic() - t0)
            if monitor:
                objs.append(objs[-1] if objs else float("nan"))
            continue

        # -- contraction, on device (:568-661) ------------------------------
        cv, num_comp_dev, firsts = _device_components(graph, active)
        num_comp = int(num_comp_dev)
        _dbg(f"components rv={num_comp}")
        lo_s, hi_s, w_sorted, flags, re_count = _contract_sort(cv, graph,
                                                               active)
        rv_cap = bucket(num_comp)
        re_cap = bucket(int(re_count))
        reu, rev, rla = _contract_pad(lo_s, hi_s, w_sorted, flags,
                                      num_comp_dev, eps, dtype, rv_cap,
                                      re_cap)
        rgraph = make_reduced_container(reu, rev, np.asarray(rla), rv_cap,
                                        obs_dev.dtype)
        _dbg(f"contraction re={int(re_count)} container="
             f"{type(rgraph).__name__}")
        r_la_l1_dev, rx0 = _reduce_vertex_terms(cv, x_full, la_l1_dev,
                                                firsts, rv_cap)
        _dbg("vertex_terms", r_la_l1_dev, rx0)

        # -- reduced operator + Lipschitz metric (:663-836) ------------------
        # beyond _ONEHOT_MAX components the [V, rV] one-hot contraction is
        # replaced by sorted run-length segment sums (O(V N) memory)
        if isinstance(op, DenseOp):
            n_obs = op.a.shape[0]
            pre_at = (rv_cap <= _ONEHOT_MAX
                      and num_comp < (2 * n_obs * pfdr_it_prev) // (
                          n_obs + pfdr_it_prev))
            if rv_cap <= _ONEHOT_MAX:
                mat, ry, lipsch = _reduce_dense(op.a, obs_dev, cv, rv_cap,
                                                pre_at)
            else:
                mat, ry, lipsch = _segment_reduce_dense(op.a, obs_dev, cv,
                                                        rv_cap, False)
            r_op = GramOp(mat) if pre_at else DenseOp(mat)
        elif isinstance(op, GramOp):
            if rv_cap > _ONEHOT_MAX:
                raise ValueError(
                    f"premultiplied (A^t A) mode cannot contract to "
                    f"{num_comp} components (the [rV, rV] reduced Gram "
                    "does not fit); pass the dense operator instead")
            mat, ry, lipsch = _reduce_gram(op.gram, obs_dev, cv, rv_cap)
            r_op = GramOp(mat)
        else:
            diag = (op.diag if isinstance(op, DiagOp)
                    else jnp.ones((num_v,), obs_dev.dtype))
            if rv_cap <= _ONEHOT_MAX:
                rdiag, ry, lipsch = _reduce_diag(diag, obs_dev, cv, rv_cap)
            else:
                rdiag, ry, lipsch = _segment_reduce_diag(diag, obs_dev, cv,
                                                         rv_cap)
            r_op = DiagOp(rdiag)

        # -- reduced PFDR solve (:842-859) -----------------------------------
        _dbg("reduce", lipsch)
        res = pfdr_quadratic_d1(
            r_op, ry, rgraph, la_l1=r_la_l1_dev if has_l1 else None,
            vprox=vprox, lipsch=lipsch, ltype=Lipsch.DIAG, x0=rx0,
            opt=opt.pfdr)
        _dbg(f"pfdr -> it={int(res.it)}")
        pfdr_it_prev = max(int(res.it), 1)
        x_full = res.x[cv]

        # -- merge + evolution (:863-975) ------------------------------------
        active = _device_merge(graph, x_full, active, eps, opt.dif_tol)
        dif = float(_evolution(x_full, x_prev, eps))
        difs.append(dif)
        x_prev = x_full
        it += 1
        times.append(_time.monotonic() - t0)
        if monitor:
            objs.append(float(_objective(
                op, obs_dev, x_full, graph, la_l1_dev,
                jnp.asarray(1.0 if has_l1 else 0.0, dtype))))
        if opt.verbose:
            print(f"CP it {it} (device): {num_comp} components, "
                  f"{int(jnp.sum(active))} active edges, dif {dif:.3g}, "
                  f"PFDR it {pfdr_it_prev}")

    # final host materialization: labels + per-component values (O(V + rV))
    cv_host = np.asarray(jax.device_get(cv))
    _, reps = np.unique(cv_host, return_index=True)
    rx_host = np.asarray(jax.device_get(x_full))[reps].astype(dtype)
    active_host = np.asarray(jax.device_get(active))
    return CPResult(
        cv=cv_host, rx=rx_host, it=it,
        time=np.asarray(times),
        obj=np.asarray(objs) if monitor else np.zeros(0, dtype),
        dif=np.asarray(difs),
        state=CPState(active=active_host, cv=cv_host, rx=rx_host))


def _host_duplex_fallback(graph: GraphD1, active, c1, c2, m):
    """Host directed min-cut (native push-relabel, or the directed Dinic
    fallback) for one duplex cut — the 2V-node two-layer construction of
    :func:`.cut_pursuit._duplex_cut`."""
    eu = np.asarray(graph.eu)
    ev = np.asarray(graph.ev)
    la = np.asarray(graph.la_d1)
    act = np.asarray(jax.device_get(active))
    num_v = graph.num_vertices
    inact = ~act & (la > 0)
    ieu, iev, ila = eu[inact], ev[inact], la[inact]
    c1h = np.asarray(jax.device_get(c1), np.float64)
    c2h = np.asarray(jax.device_get(c2), np.float64)
    mh = np.asarray(jax.device_get(m), np.float64)
    rng_v = np.arange(num_v, dtype=np.int32)
    eeu = np.concatenate([ieu, ieu + num_v, rng_v])
    eev = np.concatenate([iev, iev + num_v, rng_v + num_v])
    w_uv = np.concatenate([ila, ila, np.zeros(num_v)])
    w_vu = np.concatenate([ila, ila, mh])
    side = maxflow.min_cut_directed(2 * num_v, eeu, eev, w_uv, w_vu,
                                    np.concatenate([c1h, c2h]))
    sep_i = (side[ieu] != side[iev]) | (side[ieu + num_v]
                                        != side[iev + num_v])
    sep = np.zeros(graph.num_edges, bool)
    sep[np.nonzero(inact)[0][sep_i]] = True
    return jnp.asarray(sep)


def _host_cut_fallback(graph: GraphD1, active, c1, c2):
    """Host push-relabel cuts for one CP iteration (certificate failure)."""
    eu = np.asarray(graph.eu)
    ev = np.asarray(graph.ev)
    la = np.asarray(graph.la_d1)
    act = np.asarray(jax.device_get(active))
    inact = ~act & (la > 0)
    ieu, iev, ila = eu[inact], ev[inact], la[inact]

    def cut(c):
        side = maxflow.min_cut(graph.num_vertices, ieu, iev, ila,
                               np.asarray(jax.device_get(c), np.float64))
        return side[ieu] != side[iev]

    sep_i = cut(c1)
    if c2 is not None:
        sep_i = sep_i | cut(c2)
    sep = np.zeros(graph.num_edges, bool)
    sep[np.nonzero(inact)[0][sep_i]] = True
    return jnp.asarray(sep)
