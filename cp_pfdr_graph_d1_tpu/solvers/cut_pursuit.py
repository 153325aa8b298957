"""Cut-pursuit outer solver for quadratic + d1 (+ l1 / bounds) problems.

Minimizes ``1/2 ||y - A x||^2 + sum_e la_d1 |x_u - x_v| + g(x)`` (with ``g``
the l1(+positivity) or box term) by alternating steepest binary cuts on the
full graph with PFDR solves of the problem contracted onto the connected
components of inactive edges — the algorithm of
``/root/reference/src/CP_PFDR_graph_quadratic_d1_l1.cpp:212-1007`` and
``.../CP_PFDR_graph_quadratic_d1_bounds.cpp:207`` (unified here: only the
cut capacities and the scalar initialization differ between the two
families).

Device mapping: the FLOP-heavy stages — gradient of the smooth part, reduced
operator construction (one-hot matmuls instead of per-component column
sums), Jacobi-equilibrated power-method Lipschitz metric, and the reduced
PFDR solve — run jitted on device with reduced shapes padded to
power-of-two buckets.  The combinatorial stages — steepest cut (native
push-relabel min-cut), connected components, reduced-graph contraction —
run vectorized on host, where they are index manipulation, not FLOPs.
"""
from __future__ import annotations

import time as _time
from functools import partial
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

# reduced-operator products must be IEEE-f32 (not bf16-truncated): the
# reduced Gram/metric feed merge and cut decisions at ~1e-4 relative
_mm = partial(jnp.matmul, precision=jax.lax.Precision.HIGHEST)

from .. import maxflow, native
from ..config import CPOptions, Lipsch
from ..graph import GraphD1
from ..operators import DenseOp, DiagOp, GramOp, IdentityOp, QuadOp
from .cut_pursuit_common import (np64,
                                 bucket, build_reduced_graph,
                                 component_representatives,
                                 connected_components, host_reduce_dense,
                                 host_reduce_diag, host_reduce_gram,
                                 machine_eps, make_reduced_container,
                                 pad_reduced_graph)
from .pfdr_quadratic import VertexProx, pfdr_quadratic_d1

# dense/Gram operators larger than this stay on device even when the
# host-small path is active (the host gradient would be the bottleneck)
_HOST_OP_MAX_ELEMS = 32 * 1024 * 1024


class CPState(NamedTuple):
    """Warm-restart state: everything needed to resume the outer loop
    (the reference's ``CPql1_Restart`` — untested there, tested here)."""
    active: np.ndarray   # bool [E] cut-pursuit active-edge flags
    cv: np.ndarray       # int32 [V] component labels
    rx: np.ndarray       # [rV] component values


class CPResult(NamedTuple):
    cv: np.ndarray       # int32 [V]
    rx: np.ndarray       # [rV]
    it: int
    time: np.ndarray     # [it + 1] wall-clock seconds per CP iteration
    obj: np.ndarray      # [it + 1] objective trace (when monitored)
    dif: np.ndarray      # [it] iterate evolution
    state: CPState


# ---------------------------------------------------------------------------
# jitted device stages
# ---------------------------------------------------------------------------

@jax.jit
def _grad_smooth(op: QuadOp, obs, x_full):
    return op.grad(x_full, obs)


@jax.jit
def _objective(op: QuadOp, obs, x_full, graph: GraphD1, la_l1, la_l1_on):
    obj = op.quad_obj(x_full, obs)
    xu, xv = graph.gather_endpoints(x_full)
    obj = obj + jnp.sum(graph.la_d1 * jnp.abs(xu - xv))
    obj = obj + la_l1_on * jnp.sum(la_l1 * jnp.abs(x_full))
    return obj


@partial(jax.jit, static_argnames=("rv_cap", "pre_at"))
def _reduce_dense(a, obs, cv, rv_cap: int, pre_at: bool):
    """Reduced operator, observation and DIAG Lipschitz metric for the dense
    mode (``CP_PFDR_graph_quadratic_d1_l1.cpp:663-836``)."""
    from ..ops.power_iter import dense_operator_norm, operator_norm

    s = jax.nn.one_hot(cv, rv_cap, dtype=a.dtype)
    ra = _mm(a, s)  # [N, rv_cap] — component column sums as one matmul
    if pre_at:
        raa = _mm(ra.T, ra)
        ry = _mm(ra.T, obs)
        d = jnp.sqrt(jnp.diagonal(raa))
        d_safe = jnp.where(d > 0, d, 1)
        eq = raa / (d_safe[:, None] * d_safe[None, :])
        c = operator_norm(_MatApply(eq), rv_cap, a.dtype)
        lipsch = jnp.diagonal(raa) * c
        return raa, ry, lipsch
    else:
        cn = jnp.sqrt(jnp.sum(ra * ra, axis=0))
        cn_safe = jnp.where(cn > 0, cn, 1)
        eq = ra / cn_safe
        # pre-symmetrization cost rule (operator_norm_matrix.cpp:116): for
        # N_obs << rV the power method runs on the [N, N] Gram instead of
        # the two-sided [N, rV] apply
        c = dense_operator_norm(eq)
        lipsch = cn * cn * c
        return ra, obs, lipsch


@partial(jax.jit, static_argnames=("rv_cap",))
def _reduce_gram(gram, obs, cv, rv_cap: int):
    """Reduced quantities for the premultiplied (A^t A) mode."""
    from ..ops.power_iter import operator_norm

    s = jax.nn.one_hot(cv, rv_cap, dtype=gram.dtype)
    raa = _mm(s.T, _mm(gram, s))
    ry = _mm(obs, s)
    d = jnp.sqrt(jnp.maximum(jnp.diagonal(raa), 0))
    d_safe = jnp.where(d > 0, d, 1)
    eq = raa / (d_safe[:, None] * d_safe[None, :])
    c = operator_norm(_MatApply(eq), rv_cap, gram.dtype)
    lipsch = jnp.diagonal(raa) * c
    return raa, ry, lipsch


@partial(jax.jit, static_argnames=("rv_cap",))
def _reduce_diag(diag, obs, cv, rv_cap: int):
    """Reduced quantities for the diagonal/identity mode: the reduced Gram
    stays diagonal and is its own Lipschitz metric (``:774-776``)."""
    s = jax.nn.one_hot(cv, rv_cap, dtype=obs.dtype)
    rdiag = _mm(diag, s)
    ry = _mm(obs, s)
    return rdiag, ry, rdiag


from ..ops.power_iter import GramApply as _GramApply  # noqa: E402
from ..ops.power_iter import MatApply as _MatApply  # noqa: E402


# ---------------------------------------------------------------------------
# host-side steepest cut
# ---------------------------------------------------------------------------

def _steepest_cut(dfs, x_full, eu, ev, la_d1, active, la_l1, positivity,
                  lo, hi, differentiable, min_cut_fn=None):
    """Runs the one or two min-cuts of a CP iteration; returns the updated
    active mask and the number of newly activated edges
    (``CP_PFDR_graph_quadratic_d1_l1.cpp:410-549`` and the bounds analog
    ``CP_PFDR_graph_quadratic_d1_bounds.cpp:390-532``)."""
    if min_cut_fn is None:
        min_cut_fn = maxflow.min_cut
    inact = ~active
    ieu, iev, ila = eu[inact], ev[inact], la_d1[inact]
    num_v = len(dfs)

    def cut(c):
        side = min_cut_fn(num_v, ieu, iev, ila, c)
        return side[ieu] != side[iev]

    if differentiable:
        sep = cut(dfs)
    else:
        zero = x_full == 0
        if la_l1 is not None:
            c1 = dfs + np.where(zero, la_l1, 0.0)
            if positivity:
                c2 = np.where(zero, np.inf, -dfs)
            else:
                c2 = -dfs + np.where(zero, la_l1, 0.0)
        else:
            # bounds family: moves blocked where the bound binds
            c1 = np.where(x_full == hi, np.inf, dfs) if np.isfinite(hi) \
                else dfs
            c2 = np.where(x_full == lo, np.inf, -dfs) if np.isfinite(lo) \
                else -dfs
        # NOTE: running the two directional cuts on concurrent threads was
        # measured SLOWER on a 2-vCPU host (7.4 -> 9.4 ms/call: the native
        # push-relabel contends with XLA's host threads); they stay
        # sequential like the reference (:442-549)
        sep = cut(c1) | cut(c2)

    new_active = active.copy()
    idx = np.nonzero(inact)[0][sep]
    new_active[idx] = True
    return new_active, len(idx)


def _duplex_cut(dfs, x_full, eu, ev, la_d1, active, la_l1, positivity):
    """Single two-layer ternary cut replacing the two directional cuts
    (``CP_PFDR_graph_quadratic_d1_l1_duplex.cpp:468-549``): layer-1/layer-2
    nodes carry the downward/upward directional derivatives, an inter-layer
    arc of capacity ``m = max(0, -DfS_up, DfS_do)`` encodes the ternary
    direction {-1, 0, +1}; d1 capacities are duplicated on both layers and
    an edge activates when its endpoints separate on either layer."""
    num_v = len(dfs)
    zero = x_full == 0
    if la_l1 is not None:
        up = dfs + np.where(zero, la_l1, 0.0)
        do = dfs - np.where(zero, la_l1, 0.0)
    else:
        up = dfs.copy()
        do = dfs.copy()
    if positivity:
        do = np.where(zero, -np.inf, do)
    m = np.maximum(0.0, np.maximum(-up, do))
    c = np.concatenate([-do + m, -(up + m)])
    inact = ~active
    ieu, iev, ila = eu[inact], ev[inact], la_d1[inact]
    rng_v = np.arange(num_v, dtype=np.int32)
    eeu = np.concatenate([ieu, ieu + num_v, rng_v])
    eev = np.concatenate([iev, iev + num_v, rng_v + num_v])
    # the reference's BK arc v1->v2 (cap m) is paid when v1 keeps and v2
    # moves; in our U-membership convention that is the arc v2->v1
    w_uv = np.concatenate([ila, ila, np.zeros(num_v)])
    w_vu = np.concatenate([ila, ila, m])
    side = maxflow.min_cut_directed(2 * num_v, eeu, eev, w_uv, w_vu, c)
    sep = (side[ieu] != side[iev]) | (side[ieu + num_v] != side[iev + num_v])
    new_active = active.copy()
    idx = np.nonzero(inact)[0][sep]
    new_active[idx] = True
    return new_active, len(idx)


def _d1_sign_terms(dfs, x_full, eu, ev, la_d1, active):
    """Adds the differentiable d1 contribution of active edges
    (``CP_PFDR_graph_quadratic_d1_l1.cpp:376-391``), in place."""
    ae = np.nonzero(active)[0]
    if not len(ae):
        return
    d = x_full[eu[ae]] - x_full[ev[ae]]
    s = np.sign(d) * la_d1[ae]
    np.add.at(dfs, eu[ae], s)
    np.add.at(dfs, ev[ae], -s)


# ---------------------------------------------------------------------------
# main solver
# ---------------------------------------------------------------------------

def cp_quadratic_d1(op: QuadOp, obs, graph: GraphD1, *,
                    la_l1=None, positivity: bool = False,
                    bounds=None, duplex: bool = False,
                    opt: CPOptions = CPOptions(),
                    monitor: bool = False,
                    state: Optional[CPState] = None) -> CPResult:
    """Cut-pursuit solve; returns component labels ``cv`` and values ``rx``
    (full solution ``x = rx[cv]``), plus ``Time``/``Obj``/``Dif`` traces.

    Args:
      op: quadratic operator (Dense / Gram / Diag / Identity).
      obs: observation in the operator's convention.
      la_l1: optional [V] (or scalar) l1 weights — selects the l1 family.
      positivity: adds the nonnegativity constraint (l1 family).
      bounds: optional (lo, hi) scalars — selects the bounds family
        (mutually exclusive with la_l1/positivity).
      state: optional warm restart from a previous result's ``.state``.
    """
    t0 = _time.monotonic()
    from ..utils.monitor import StageProfiler
    prof = StageProfiler()
    host_coo = getattr(graph, "_host_coo", None)
    if host_coo is not None:
        eu, ev, la_d1 = host_coo
        la_d1 = np.asarray(la_d1)
    else:
        eu = np.asarray(graph.eu)
        ev = np.asarray(graph.ev)
        la_d1 = np.asarray(graph.la_d1)
    num_v = graph.num_vertices
    num_e = graph.num_edges
    # no np.asarray(obs) here: a process-spanning sharded observation
    # (multi-host cp_quadratic_d1_dist) cannot be fetched to one host
    dtype = np.dtype(obs.dtype) if hasattr(obs, "dtype") \
        else np.asarray(obs).dtype
    obs_dev = obs if isinstance(obs, jax.Array) else jnp.asarray(obs)

    if bounds is not None and (la_l1 is not None or positivity):
        raise ValueError("bounds is exclusive with la_l1/positivity")
    if opt.cut == "device":
        # fully device-resident iteration: cuts (two-directional or duplex
        # ternary), components, contraction, merge all on device; o(E)
        # host traffic per iteration
        from .cut_pursuit_device import cp_quadratic_d1_device
        return cp_quadratic_d1_device(op, obs, graph, la_l1=la_l1,
                                      positivity=positivity, bounds=bounds,
                                      duplex=duplex, opt=opt,
                                      monitor=monitor, state=state)
    lo, hi = (-np.inf, np.inf) if bounds is None else (
        float(bounds[0]), float(bounds[1]))
    if la_l1 is not None:
        la_l1 = np.broadcast_to(np.asarray(la_l1, dtype), (num_v,)).copy()
    differentiable = (la_l1 is None and not positivity
                      and not (np.isfinite(lo) or np.isfinite(hi)))
    if bounds is not None:
        vprox = VertexProx(kind="bounds", lo=lo, hi=hi)
    elif la_l1 is not None:
        vprox = VertexProx(kind="l1", positivity=positivity)
    elif positivity:
        vprox = VertexProx(kind="l1", positivity=True)
        la_l1 = np.zeros(num_v, dtype)
    else:
        vprox = VertexProx()

    eps = machine_eps(dtype, opt.dif_tol)
    dif_tol2 = opt.dif_tol * opt.dif_tol

    # cut == "device" already routed into cp_quadratic_d1_device above;
    # the host loop always uses the native push-relabel min-cut
    if opt.cut == "host":
        min_cut_fn = maxflow.min_cut
    else:
        raise ValueError(f"unknown cut backend {opt.cut!r}")

    # monitor-only device fields, built lazily (unmonitored solves upload
    # nothing they do not use)
    _mon = {}

    def _mon_objective(x_full_np):
        if not _mon:
            _mon["la_l1"] = jnp.asarray(la_l1 if la_l1 is not None
                                        else np.zeros(num_v, dtype))
            _mon["on"] = jnp.asarray(0.0 if la_l1 is None else 1.0, dtype)
        return float(_objective(op, obs_dev, jnp.asarray(x_full_np), graph,
                                _mon["la_l1"], _mon["on"]))

    # -- host-small routing: below the crossover, reduced problems solve on
    # the host (native C++ PFDR) and the cut gradient is a host matvec,
    # avoiding per-iteration device dispatch latency entirely
    if opt.host_small == "off":
        use_host = False
    elif opt.host_small == "on":
        use_host = native.available()
    else:
        use_host = (jax.default_backend() not in ("cpu",)
                    and native.available())
    a_np = gram_np = diag_np = a_t_np = None
    y_np = None
    if use_host:
        y_np = np64(obs)
        if isinstance(op, DenseOp) and op.a.size <= _HOST_OP_MAX_ELEMS:
            # prefer a caller-provided host copy (the api layer attaches
            # one) over a device download
            a_np = getattr(op, "_host_a", None)
            if a_np is None:
                a_np = np64(op.a)
            a_t_np = np.ascontiguousarray(a_np.T)
        elif isinstance(op, GramOp) and op.gram.size <= _HOST_OP_MAX_ELEMS:
            gram_np = getattr(op, "_host_gram", None)
            if gram_np is None:
                gram_np = np64(op.gram)
        elif isinstance(op, DiagOp):
            diag_np = np64(op.diag)
        elif isinstance(op, IdentityOp):
            diag_np = np.ones(num_v)
        la_l1_64 = (np.asarray(la_l1, np.float64)
                    if la_l1 is not None else None)

    # -- initialization: single component, scalar prox solve (:66-175) ------
    if state is None:
        if a_np is not None:
            a1 = a_np.sum(axis=1)
            ry1, raa1 = float(a1 @ y_np), float(a1 @ a1)
        elif gram_np is not None:
            ry1, raa1 = float(y_np.sum()), float(gram_np.sum())
        elif diag_np is not None:
            ry1, raa1 = float(y_np.sum()), float(diag_np.sum())
        else:
            ry1, raa1 = map(float, jax.device_get(
                jnp.stack(op.ones_image(num_v, obs_dev))))
        if bounds is not None:
            x1 = min(max(ry1 / raa1, lo), hi)
        else:
            rl1 = float(la_l1.sum()) if la_l1 is not None else 0.0
            if ry1 > rl1:
                x1 = (ry1 - rl1) / raa1
            elif not positivity and ry1 < -rl1:
                x1 = (ry1 + rl1) / raa1
            else:
                x1 = 0.0
        active = np.zeros(num_e, bool)
        cv = np.zeros(num_v, np.int32)
        rx = np.asarray([x1], dtype)
    else:
        active = state.active.copy()
        cv = state.cv.copy()
        rx = state.rx.copy()

    times = [0.0]
    objs = []
    difs = []
    x_prev = rx[cv]
    if monitor:
        objs.append(_mon_objective(x_prev))

    prof.tick("init")
    pfdr_it_prev = opt.pfdr.it_max
    it = 0
    dif = max(dif_tol2, 1.0)
    num_comp = len(rx)
    # inexact outer loop (SURVEY north star, beyond the reference): while
    # the partition is still changing, full-accuracy reduced solves are
    # wasted — intermediate solves are capped and a final full-accuracy
    # polish on the settled partition restores the caller's tolerance
    # (measured on the EEG-scale bench: ~60% of inner iterations saved at
    # equal final objective)
    inexact_on = (opt.inexact == "auto"
                  and opt.pfdr.it_max > opt.inexact_cap)
    last_capped = False
    x_prev2 = x_prev

    import dataclasses as _dc

    def _pfdr_opt(inner_it_max):
        if inner_it_max == opt.pfdr.it_max:
            return opt.pfdr
        return _dc.replace(opt.pfdr, it_max=inner_it_max)

    def solve_reduced(rg, cv, num_comp, rx0, inner_it_max):
        """Solves the reduced problem on the current partition, on the host
        (native f64 PFDR) below the host-small crossover and on device
        otherwise; returns the [rV] component values.  ``inner_it_max``
        caps the PFDR iterations (the inexact outer-loop schedule passes a
        cap for intermediate iterations, ``opt.pfdr.it_max`` for final
        accuracy)."""
        nonlocal pfdr_it_prev
        host_reduce = (use_host and num_comp <= opt.host_small_max
                       and (a_np is not None or gram_np is not None
                            or diag_np is not None))
        if host_reduce:
            # -- host pipeline: numpy reduce + native C++ PFDR ---------------
            if a_np is not None:
                n_obs = a_np.shape[0]
                pre_at = num_comp < (2 * n_obs * pfdr_it_prev) // (
                    n_obs + pfdr_it_prev)
                mode, mat, ry, lipsch = host_reduce_dense(
                    a_t_np, y_np, cv, num_comp, pre_at)
            elif gram_np is not None:
                mat, ry, lipsch = host_reduce_gram(gram_np, y_np, cv,
                                                   num_comp)
                mode = -1
            else:
                mat, ry, lipsch = host_reduce_diag(diag_np, y_np, cv,
                                                   num_comp)
                mode = 0
            r_la_l1 = None
            if la_l1 is not None:
                r_la_l1 = np.zeros(num_comp)
                np.add.at(r_la_l1, cv, la_l1_64)
            rx_new, pfdr_it = native.pfdr_quadratic_d1_host(
                mode, mat, ry, rg.eu, rg.ev,
                np.asarray(rg.la_d1, np.float64),
                la_l1=r_la_l1,
                positivity=vprox.positivity,
                bounds=(lo, hi) if bounds is not None else None,
                lip_diag=np.asarray(lipsch, np.float64),
                rho=opt.pfdr.rho, cond_min=opt.pfdr.cond_min,
                dif_rcd=opt.pfdr.dif_rcd, dif_tol=opt.pfdr.dif_tol,
                it_max=inner_it_max, x0=rx0)
            pfdr_it_prev = max(pfdr_it, 1)
            return rx_new.astype(dtype)

        rv_cap = bucket(num_comp)
        re_cap = bucket(len(rg.eu))
        reu, rev, rla = pad_reduced_graph(rg, rv_cap, re_cap)
        rgraph = make_reduced_container(reu, rev, rla, rv_cap,
                                        obs_dev.dtype)
        cv_dev = jnp.asarray(cv)

        # -- reduced operator + Lipschitz metric (:663-836) --------------
        if isinstance(op, DenseOp):
            n_obs = op.a.shape[0]
            pre_at = num_comp < (2 * n_obs * pfdr_it_prev) // (
                n_obs + pfdr_it_prev)
            mat, ry, lipsch = _reduce_dense(op.a, obs_dev, cv_dev,
                                            rv_cap, pre_at)
            r_op = GramOp(mat) if pre_at else DenseOp(mat)
        elif isinstance(op, GramOp):
            mat, ry, lipsch = _reduce_gram(op.gram, obs_dev, cv_dev,
                                           rv_cap)
            r_op = GramOp(mat)
        else:
            diag = (op.diag if isinstance(op, DiagOp)
                    else jnp.ones((num_v,), obs_dev.dtype))
            rdiag, ry, lipsch = _reduce_diag(diag, obs_dev, cv_dev,
                                             rv_cap)
            r_op = DiagOp(rdiag)

        # reduced l1 weights: summed per component
        if la_l1 is not None:
            r_la_l1 = np.zeros(rv_cap, dtype)
            np.add.at(r_la_l1, cv, la_l1)
            r_la_l1 = jnp.asarray(r_la_l1)
        else:
            r_la_l1 = None

        x0_pad = np.zeros(rv_cap, dtype)
        x0_pad[:num_comp] = rx0
        # -- reduced PFDR solve (:842-859) -------------------------------
        res = pfdr_quadratic_d1(
            r_op, ry, rgraph, la_l1=r_la_l1, vprox=vprox,
            lipsch=lipsch, ltype=Lipsch.DIAG,
            x0=jnp.asarray(x0_pad), opt=_pfdr_opt(inner_it_max))
        pfdr_it_prev = max(int(res.it), 1)
        return np.asarray(jax.device_get(res.x), dtype)[:num_comp]

    while it < opt.it_max and dif >= dif_tol2:
        x_full = rx[cv]

        # -- steepest cut (:337-549) ---------------------------------------
        if a_np is not None:
            dfs = (a_np.T @ (a_np @ x_full - y_np)).astype(dtype)
        elif gram_np is not None:
            dfs = (gram_np @ x_full - y_np).astype(dtype)
        elif diag_np is not None:
            dfs = (diag_np * x_full - y_np).astype(dtype)
        else:
            dfs = np.array(jax.device_get(
                _grad_smooth(op, obs_dev, jnp.asarray(x_full))), dtype)
        _d1_sign_terms(dfs, x_full, eu, ev, la_d1, active)
        if la_l1 is not None:
            dfs += np.sign(x_full) * la_l1
        prof.tick("gradient")
        if duplex and not differentiable and bounds is None:
            active, n_new = _duplex_cut(
                dfs, x_full, eu, ev, la_d1, active, la_l1, positivity)
        else:
            active, n_new = _steepest_cut(
                dfs, x_full, eu, ev, la_d1, active, la_l1, positivity, lo,
                hi, differentiable, min_cut_fn=min_cut_fn)

        prof.tick("cut")
        if n_new == 0:  # nothing to recompute (:556-563)
            difs.append(0.0)
            dif = 0.0
            it += 1
            times.append(_time.monotonic() - t0)
            if monitor:
                objs.append(objs[-1] if objs else float("nan"))
            continue

        # -- contraction (:568-661) ----------------------------------------
        # zero-weight edges (e.g. stencil padding) never join components
        num_comp, cv = connected_components(num_v, eu, ev,
                                            ~active & (la_d1 > 0))
        rg = build_reduced_graph(cv, num_comp, eu, ev, la_d1, active, eps)
        # warm start: every vertex of a component carries the same previous
        # value, so any representative seeds the reduced solve (the
        # reference also warm-starts PFDR with rX, :842-847)
        rx0 = x_full[component_representatives(cv)]
        prof.tick("contract")

        inner_cap = opt.inexact_cap if inexact_on else opt.pfdr.it_max
        rx = solve_reduced(rg, cv, num_comp, rx0, inner_cap)
        last_capped = inner_cap < opt.pfdr.it_max
        prof.tick("reduced-solve")
        # -- merge almost-equal neighboring components (:863-886) ----------
        x_full = rx[cv]
        ae = np.nonzero(active)[0]
        if len(ae):
            a = x_full[eu[ae]]
            b = x_full[ev[ae]]
            d = np.abs(a - b)
            amax = np.maximum(np.abs(a), np.abs(b))
            rel = np.where(amax > eps, d / np.maximum(amax, eps), d / eps)
            active[ae[rel <= opt.dif_tol]] = False

        # -- evolution + objective (:889-975) ------------------------------
        x_prev2 = x_prev
        delta = x_full - x_prev
        den = float(np.dot(x_full, x_full))
        dif = float(np.dot(delta, delta)) / (den if den > eps else eps)
        difs.append(dif)
        x_prev = x_full
        it += 1
        times.append(_time.monotonic() - t0)
        if monitor:
            objs.append(_mon_objective(x_full))
        prof.tick("merge+trace")
        if opt.verbose:
            print(f"CP it {it}: {num_comp} components, "
                  f"{int(active.sum())} active edges, dif {dif:.3g}, "
                  f"PFDR it {pfdr_it_prev}")

    if last_capped and num_comp == len(rx):
        # final full-accuracy solve on the settled partition (rx is
        # already per-component, so it is its own warm start); merge and
        # the last trace entries are recomputed from the polished values
        rx = solve_reduced(rg, cv, num_comp, rx, opt.pfdr.it_max)
        x_full = rx[cv]
        ae = np.nonzero(active)[0]
        if len(ae):
            a = x_full[eu[ae]]
            b = x_full[ev[ae]]
            d = np.abs(a - b)
            amax = np.maximum(np.abs(a), np.abs(b))
            rel = np.where(amax > eps, d / np.maximum(amax, eps), d / eps)
            active[ae[rel <= opt.dif_tol]] = False
        delta = x_full - x_prev2
        den = float(np.dot(x_full, x_full))
        difs[-1] = float(np.dot(delta, delta)) / (den if den > eps else eps)
        times[-1] = _time.monotonic() - t0
        if monitor:
            objs[-1] = _mon_objective(x_full)
        prof.tick("final-polish")
    prof.report()
    return CPResult(
        cv=cv, rx=rx, it=it,
        time=np.asarray(times),
        obj=np.asarray(objs) if monitor else np.zeros(0, dtype),
        dif=np.asarray(difs),
        state=CPState(active=active, cv=cv, rx=rx))
