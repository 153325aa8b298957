"""Reference-parity functional API.

One Python function per reference entry point, with the reference's argument
sets, semantics, and output conventions:

=====================================================  =======================
reference binding                                      here
=====================================================  =======================
``CP_PFDR_graph_quadratic_d1_l1_mex``                  :func:`cp_quadratic_d1_l1`
``CP_PFDR_graph_quadratic_d1_l1_AtA_mex``              :func:`cp_quadratic_d1_l1_AtA`
``CP_PFDR_graph_l22_d1_l1_mex``                        :func:`cp_l22_d1_l1`
``CP_PFDR_graph_quadratic_d1_l1_duplex_mex``           ``duplex=True``
``CP_PFDR_graph_l22_d1_l1_duplex_mex``                 ``duplex=True``
``CP_PFDR_graph_quadratic_d1_bounds_mex``              :func:`cp_quadratic_d1_bounds`
``CP_PFDR_graph_quadratic_d1_bounds_AtA_mex``          :func:`cp_quadratic_d1_bounds_AtA`
``CP_PFDR_graph_l22_d1_bounds_mex``                    :func:`cp_l22_d1_bounds`
``CP_PFDR_graph_loss_d1_simplex_mex``                  :func:`cp_loss_d1_simplex`
``PFDR_graph_quadratic_d1_l1_mex`` (+AtA, l22)         :func:`pfdr_quadratic_d1_l1` (...)
``PFDR_graph_quadratic_d1_bounds_mex`` (+AtA, l22)     :func:`pfdr_quadratic_d1_bounds` (...)
``PFDR_graph_loss_d1_simplex_mex``                     :func:`pfdr_loss_d1_simplex_api`
``libCP.CP_quadratic_l1`` (Boost.Python)               :func:`CP_quadratic_l1`
=====================================================  =======================

Outputs follow the MEX contract: cut-pursuit entries return
``(Cv, rX, it, Time, Obj, Dif)`` with the full solution ``x = rX[Cv]``
(``octave/doc/CP_PFDR_graph_quadratic_d1_l1_mex.m:59-64``); PFDR entries
return ``(X, it, Obj, Dif)``.
"""
from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp
import numpy as np

from .config import CPOptions, Lipsch, PFDROptions
from .graph import GraphD1
from .operators import DenseOp, DiagOp, GramOp, IdentityOp
from .solvers.cut_pursuit import cp_quadratic_d1
from .solvers.cut_pursuit_simplex import CPSimplexState, cp_loss_d1_simplex \
    as _cp_simplex
from .solvers.pfdr_quadratic import VertexProx, pfdr_quadratic_d1
from .solvers.pfdr_simplex import pfdr_loss_d1_simplex


class CPOutput(NamedTuple):
    Cv: np.ndarray
    rX: np.ndarray
    it: int
    Time: np.ndarray
    Obj: np.ndarray
    Dif: np.ndarray
    state: object


class PFDROutput(NamedTuple):
    X: np.ndarray
    it: int
    Obj: np.ndarray
    Dif: np.ndarray


def _cp_options(CP_difTol, CP_itMax, PFDR_rho, PFDR_condMin, PFDR_difRcd,
                PFDR_difTol, PFDR_itMax, verbose,
                inexact: str = "auto") -> CPOptions:
    """Cut-pursuit options for the compatibility wrappers.

    ``inexact``: with the default "auto" and ``PFDR_itMax > 3000``,
    *intermediate* reduced solves are iteration-capped and a final
    full-accuracy polish restores the caller's tolerance — the final
    objective matches the reference, but intermediate iterates/partitions
    can differ from the reference C++ trajectory for identical parameters.
    Pass ``inexact="off"`` to reproduce the reference trajectory exactly
    (every reduced solve at full accuracy,
    ``CP_PFDR_graph_quadratic_d1_l1.cpp:842-859``).
    """
    return CPOptions(
        dif_tol=float(CP_difTol), it_max=int(CP_itMax),
        pfdr=PFDROptions(rho=float(PFDR_rho), cond_min=float(PFDR_condMin),
                         dif_rcd=float(PFDR_difRcd),
                         dif_tol=float(PFDR_difTol), it_max=int(PFDR_itMax)),
        verbose=int(verbose), inexact=inexact)


def _graph(Eu, Ev, La_d1, num_vertices, dtype, container: str = "coo"):
    """Builds the graph container.

    ``container``: "coo" (or "auto") — plain :class:`GraphD1`;
    "circulant" — the shift-family decomposition
    (:class:`~..circulant.CirculantGraphD1`; relabel with
    :func:`~..circulant.strip_order` first for mesh problems).
    """
    if container == "circulant":
        from .circulant import CirculantGraphD1
        return CirculantGraphD1.create(Eu, Ev, La_d1,
                                       num_vertices=num_vertices,
                                       dtype=dtype)
    if container not in ("auto", "coo"):
        raise ValueError(f"unknown container {container!r}")
    return GraphD1.create(Eu, Ev, La_d1, num_vertices=num_vertices,
                          dtype=dtype)


def _dtype_of(*arrays):
    import jax

    if not jax.config.jax_enable_x64:
        return jnp.float32  # float64 would be silently truncated anyway
    for a in arrays:
        a = np.asarray(a)
        if a.dtype == np.float64:
            return jnp.float64
    return jnp.float32


def _cp_run(op, obs, graph, la_l1, positivity, bounds, duplex, opt,
            monitor, state):
    res = cp_quadratic_d1(op, obs, graph, la_l1=la_l1,
                          positivity=bool(positivity), bounds=bounds,
                          duplex=duplex, opt=opt, monitor=monitor,
                          state=state)
    return CPOutput(res.cv, res.rx, res.it, res.time, res.obj, res.dif,
                    res.state)


# ---------------------------------------------------------------------------
# cut-pursuit entries, l1 family
# ---------------------------------------------------------------------------

def cp_quadratic_d1_l1(Y, A, Eu, Ev, La_d1, La_l1=None, positivity=False,
                       CP_difTol=1e-3, CP_itMax=10, PFDR_rho=1.0,
                       PFDR_condMin=1e-3, PFDR_difRcd=0.0, PFDR_difTol=1e-4,
                       PFDR_itMax=10_000, verbose=0, duplex=False,
                       monitor=False, state=None, graph=None,
                       inexact="auto") -> CPOutput:
    """Fused LASSO ``1/2||y - A x||^2 + d1 + l1`` with dense N-by-V ``A``
    (``octave/mex/CP_PFDR_graph_quadratic_d1_l1_mex.cpp:12``; duplex=True
    selects the two-layer ternary-cut variant).  Pass a prebuilt ``graph``
    (e.g. a :class:`~cp_pfdr_graph_d1_tpu.stencil.StencilGraphD1`) to skip
    the COO construction and use its gather-free fast path; ``Eu``/``Ev``/
    ``La_d1`` are then ignored."""
    dtype = _dtype_of(Y, A)
    a_host = np.asarray(A)
    # numpy, not device, below the host-small crossover: when the whole
    # solve stays on the host, an eager device upload would be pure
    # overhead; larger operators upload once here and stay device-resident
    from .solvers.cut_pursuit import _HOST_OP_MAX_ELEMS
    if a_host.size <= _HOST_OP_MAX_ELEMS:
        a = np.asarray(a_host, dtype)
    else:
        a = jnp.asarray(a_host, dtype)
    g = graph if graph is not None else _graph(Eu, Ev, La_d1, a.shape[1],
                                               dtype)
    opt = _cp_options(CP_difTol, CP_itMax, PFDR_rho, PFDR_condMin,
                      PFDR_difRcd, PFDR_difTol, PFDR_itMax, verbose,
                      inexact)
    op = DenseOp(a)
    op._host_a = np.asarray(a_host, np.float64)  # spare host-small a pull
    return _cp_run(op, np.asarray(Y, dtype), g, La_l1,
                   positivity, None, duplex, opt, monitor, state)


def cp_quadratic_d1_l1_AtA(AtY, AtA, Eu, Ev, La_d1, La_l1=None,
                           positivity=False, CP_difTol=1e-3, CP_itMax=10,
                           PFDR_rho=1.0, PFDR_condMin=1e-3, PFDR_difRcd=0.0,
                           PFDR_difTol=1e-4, PFDR_itMax=10_000, verbose=0,
                           duplex=False, monitor=False, state=None,
                           inexact="auto") -> CPOutput:
    """Premultiplied variant: arguments are ``A^t Y`` and ``A^t A``
    (``octave/mex/CP_PFDR_graph_quadratic_d1_l1_AtA_mex.cpp:61`` passes
    ``N = -V``)."""
    dtype = _dtype_of(AtY, AtA)
    gram_host = np.asarray(AtA)
    gram = jnp.asarray(gram_host, dtype)
    g = _graph(Eu, Ev, La_d1, gram.shape[1], dtype)
    opt = _cp_options(CP_difTol, CP_itMax, PFDR_rho, PFDR_condMin,
                      PFDR_difRcd, PFDR_difTol, PFDR_itMax, verbose,
                      inexact)
    op = GramOp(gram)
    op._host_gram = np.asarray(gram_host, np.float64)
    return _cp_run(op, np.asarray(AtY, dtype), g,
                   La_l1, positivity, None, duplex, opt, monitor, state)


def cp_l22_d1_l1(Y, La_l2, Eu, Ev, La_d1, La_l1=None, positivity=False,
                 CP_difTol=1e-3, CP_itMax=10, PFDR_rho=1.0,
                 PFDR_condMin=1e-3, PFDR_difRcd=0.0, PFDR_difTol=1e-4,
                 PFDR_itMax=10_000, verbose=0, duplex=False, monitor=False,
                 state=None, inexact="auto") -> CPOutput:
    """Weighted-distance case ``1/2||y - x||^2_{La_l2} + d1 + l1``:
    premultiplies ``Y <- La_l2 * Y``, solves with the diagonal operator, and
    corrects the objective by the constant ``1/2 ||y||^2_{La_l2}``
    (``octave/mex/CP_PFDR_graph_l22_d1_l1_mex.cpp:65-94``).  ``La_l2=None``
    means the identity."""
    Y = np.asarray(Y)
    dtype = _dtype_of(Y, La_l2 if La_l2 is not None else Y)
    num_v = Y.shape[0]
    g = _graph(Eu, Ev, La_d1, num_v, dtype)
    opt = _cp_options(CP_difTol, CP_itMax, PFDR_rho, PFDR_condMin,
                      PFDR_difRcd, PFDR_difTol, PFDR_itMax, verbose,
                      inexact)
    if La_l2 is None:
        op = IdentityOp()
        obs = jnp.asarray(Y, dtype)
        y2 = 0.5 * float(np.dot(Y, Y))
    else:
        w = np.broadcast_to(np.asarray(La_l2), (num_v,))
        op = DiagOp(jnp.asarray(w, dtype))
        obs = jnp.asarray(w * Y, dtype)
        y2 = 0.5 * float(np.dot(w * Y, Y))
    out = _cp_run(op, obs, g, La_l1, positivity, None, duplex, opt, monitor,
                  state)
    if monitor and len(out.Obj):
        out = out._replace(Obj=out.Obj + y2)
    return out


# ---------------------------------------------------------------------------
# cut-pursuit entries, bounds family
# ---------------------------------------------------------------------------

def cp_quadratic_d1_bounds(Y, A, Eu, Ev, La_d1, m=-np.inf, M=np.inf,
                           CP_difTol=1e-3, CP_itMax=10, PFDR_rho=1.0,
                           PFDR_condMin=1e-3, PFDR_difRcd=0.0,
                           PFDR_difTol=1e-4, PFDR_itMax=10_000, verbose=0,
                           monitor=False, state=None,
                           inexact="auto") -> CPOutput:
    """Box-constrained variant
    (``octave/mex/CP_PFDR_graph_quadratic_d1_bounds_mex.cpp``)."""
    dtype = _dtype_of(Y, A)
    a = jnp.asarray(np.asarray(A), dtype)
    g = _graph(Eu, Ev, La_d1, a.shape[1], dtype)
    opt = _cp_options(CP_difTol, CP_itMax, PFDR_rho, PFDR_condMin,
                      PFDR_difRcd, PFDR_difTol, PFDR_itMax, verbose,
                      inexact)
    return _cp_run(DenseOp(a), np.asarray(Y, dtype), g, None,
                   False, (float(m), float(M)), False, opt, monitor, state)


def cp_quadratic_d1_bounds_AtA(AtY, AtA, Eu, Ev, La_d1, m=-np.inf,
                               M=np.inf, CP_difTol=1e-3, CP_itMax=10,
                               PFDR_rho=1.0, PFDR_condMin=1e-3,
                               PFDR_difRcd=0.0, PFDR_difTol=1e-4,
                               PFDR_itMax=10_000, verbose=0, monitor=False,
                               state=None, inexact="auto") -> CPOutput:
    dtype = _dtype_of(AtY, AtA)
    gram = jnp.asarray(np.asarray(AtA), dtype)
    g = _graph(Eu, Ev, La_d1, gram.shape[1], dtype)
    opt = _cp_options(CP_difTol, CP_itMax, PFDR_rho, PFDR_condMin,
                      PFDR_difRcd, PFDR_difTol, PFDR_itMax, verbose,
                      inexact)
    return _cp_run(GramOp(gram), np.asarray(AtY, dtype), g,
                   None, False, (float(m), float(M)), False, opt, monitor,
                   state)


def cp_l22_d1_bounds(Y, La_l2, Eu, Ev, La_d1, m=-np.inf, M=np.inf,
                     CP_difTol=1e-3, CP_itMax=10, PFDR_rho=1.0,
                     PFDR_condMin=1e-3, PFDR_difRcd=0.0, PFDR_difTol=1e-4,
                     PFDR_itMax=10_000, verbose=0, monitor=False,
                     state=None, inexact="auto") -> CPOutput:
    Y = np.asarray(Y)
    dtype = _dtype_of(Y, La_l2 if La_l2 is not None else Y)
    num_v = Y.shape[0]
    g = _graph(Eu, Ev, La_d1, num_v, dtype)
    opt = _cp_options(CP_difTol, CP_itMax, PFDR_rho, PFDR_condMin,
                      PFDR_difRcd, PFDR_difTol, PFDR_itMax, verbose,
                      inexact)
    if La_l2 is None:
        op = IdentityOp()
        obs = jnp.asarray(Y, dtype)
        y2 = 0.5 * float(np.dot(Y, Y))
    else:
        w = np.broadcast_to(np.asarray(La_l2), (num_v,))
        op = DiagOp(jnp.asarray(w, dtype))
        obs = jnp.asarray(w * Y, dtype)
        y2 = 0.5 * float(np.dot(w * Y, Y))
    out = _cp_run(op, obs, g, None, False, (float(m), float(M)), False, opt,
                  monitor, state)
    if monitor and len(out.Obj):
        out = out._replace(Obj=out.Obj + y2)
    return out


# ---------------------------------------------------------------------------
# cut-pursuit entry, simplex family
# ---------------------------------------------------------------------------

def cp_loss_d1_simplex(Q, al, Eu, Ev, La_d1, CP_difTol=1e-3, CP_itMax=10,
                       PFDR_rho=1.0, PFDR_condMin=1e-3, PFDR_difRcd=0.0,
                       PFDR_difTol=1e-4, PFDR_itMax=10_000, verbose=0,
                       monitor=False, state=None,
                       inexact="auto") -> CPOutput:
    """Multi-label solve
    (``octave/mex/CP_PFDR_graph_loss_d1_simplex_mex.cpp:12``); ``Q`` is
    [V, K] vertex-major; returns ``rX`` of shape [rV, K]."""
    Q = np.asarray(Q)
    dtype = _dtype_of(Q)
    g = _graph(Eu, Ev, La_d1, Q.shape[0], dtype)
    opt = _cp_options(CP_difTol, CP_itMax, PFDR_rho, PFDR_condMin,
                      PFDR_difRcd, PFDR_difTol, PFDR_itMax, verbose,
                      inexact)
    res = _cp_simplex(g, jnp.asarray(Q, dtype), al=float(al), opt=opt,
                      monitor=monitor, state=state)
    return CPOutput(res.cv, res.rp, res.it, res.time, res.obj, res.dif,
                    res.state)


# ---------------------------------------------------------------------------
# PFDR-only entries
# ---------------------------------------------------------------------------

def _pfdr_options(rho, condMin, difRcd, difTol, itMax, verbose=0):
    return PFDROptions(rho=float(rho), cond_min=float(condMin),
                       dif_rcd=float(difRcd), dif_tol=float(difTol),
                       it_max=int(itMax), verbose=int(verbose))


def _pfdr_run(op, obs, g, la_l1, vprox, L, rho, condMin, difRcd, difTol,
              itMax, monitor, x0=None, verbose=0):
    ltype = Lipsch.SCAL
    lipsch = None
    if L is not None:
        L = np.asarray(L)
        if L.ndim == 0 or L.size == 1:
            lipsch = float(L)
        else:
            lipsch = jnp.asarray(L, obs.dtype)
            ltype = Lipsch.DIAG
    res = pfdr_quadratic_d1(
        op, obs, g, la_l1=None if la_l1 is None else jnp.asarray(
            np.broadcast_to(np.asarray(la_l1), (g.num_vertices,)),
            obs.dtype),
        vprox=vprox, lipsch=lipsch, ltype=ltype, x0=x0,
        opt=_pfdr_options(rho, condMin, difRcd, difTol, itMax, verbose),
        monitor=monitor)
    it = int(res.it)
    return PFDROutput(np.asarray(res.x), it,
                      np.asarray(res.obj)[:it + 1] if monitor
                      else np.zeros(0),
                      np.asarray(res.dif)[:it] if monitor else np.zeros(0))


def pfdr_quadratic_d1_l1(Y, A, Eu, Ev, La_d1, La_l1=None, positivity=False,
                         L=None, PFDR_rho=1.0, PFDR_condMin=1e-3,
                         PFDR_difRcd=0.0, PFDR_difTol=1e-4,
                         PFDR_itMax=10_000, verbose=0, monitor=False,
                         x0=None, container="auto") -> PFDROutput:
    """Inner solver alone on the full graph
    (``octave/mex/PFDR_graph_quadratic_d1_l1_mex.cpp``).  ``L`` is the
    Lipschitz information: scalar = SCAL, [V] array = DIAG; ``container``
    selects the graph layout (see :func:`_graph`)."""
    dtype = _dtype_of(Y, A)
    a = jnp.asarray(np.asarray(A), dtype)
    g = _graph(Eu, Ev, La_d1, a.shape[1], dtype, container)
    vprox = VertexProx(kind="l1", positivity=bool(positivity)) \
        if La_l1 is not None else (
            VertexProx(kind="l1", positivity=True) if positivity
            else VertexProx())
    la_l1 = La_l1 if La_l1 is not None else (
        np.zeros(a.shape[1]) if positivity else None)
    return _pfdr_run(DenseOp(a), jnp.asarray(np.asarray(Y), dtype), g,
                     la_l1, vprox, L, PFDR_rho, PFDR_condMin, PFDR_difRcd,
                     PFDR_difTol, PFDR_itMax, monitor, x0, verbose)


def pfdr_quadratic_d1_l1_AtA(AtY, AtA, Eu, Ev, La_d1, La_l1=None,
                             positivity=False, L=None, PFDR_rho=1.0,
                             PFDR_condMin=1e-3, PFDR_difRcd=0.0,
                             PFDR_difTol=1e-4, PFDR_itMax=10_000,
                             verbose=0, monitor=False, x0=None,
                             container="auto") -> PFDROutput:
    dtype = _dtype_of(AtY, AtA)
    gram = jnp.asarray(np.asarray(AtA), dtype)
    g = _graph(Eu, Ev, La_d1, gram.shape[1], dtype, container)
    vprox = VertexProx(kind="l1", positivity=bool(positivity)) \
        if La_l1 is not None else (
            VertexProx(kind="l1", positivity=True) if positivity
            else VertexProx())
    la_l1 = La_l1 if La_l1 is not None else (
        np.zeros(gram.shape[1]) if positivity else None)
    return _pfdr_run(GramOp(gram), jnp.asarray(np.asarray(AtY), dtype), g,
                     la_l1, vprox, L, PFDR_rho, PFDR_condMin, PFDR_difRcd,
                     PFDR_difTol, PFDR_itMax, monitor, x0, verbose)


def pfdr_l22_d1_l1(Y, La_l2, Eu, Ev, La_d1, La_l1=None, positivity=False,
                   L=None, PFDR_rho=1.0, PFDR_condMin=1e-3, PFDR_difRcd=0.0,
                   PFDR_difTol=1e-4, PFDR_itMax=10_000, verbose=0,
                   monitor=False, x0=None, container="auto") -> PFDROutput:
    Y = np.asarray(Y)
    dtype = _dtype_of(Y, La_l2 if La_l2 is not None else Y)
    num_v = Y.shape[0]
    g = _graph(Eu, Ev, La_d1, num_v, dtype, container)
    vprox = VertexProx(kind="l1", positivity=bool(positivity)) \
        if La_l1 is not None else (
            VertexProx(kind="l1", positivity=True) if positivity
            else VertexProx())
    la_l1 = La_l1 if La_l1 is not None else (
        np.zeros(num_v) if positivity else None)
    if La_l2 is None:
        op, obs = IdentityOp(), jnp.asarray(Y, dtype)
    else:
        w = np.broadcast_to(np.asarray(La_l2), (num_v,))
        op, obs = DiagOp(jnp.asarray(w, dtype)), jnp.asarray(w * Y, dtype)
    return _pfdr_run(op, obs, g, la_l1, vprox, L, PFDR_rho, PFDR_condMin,
                     PFDR_difRcd, PFDR_difTol, PFDR_itMax, monitor, x0,
                     verbose)


def pfdr_quadratic_d1_bounds(Y, A, Eu, Ev, La_d1, m=-np.inf, M=np.inf,
                             L=None, PFDR_rho=1.0, PFDR_condMin=1e-3,
                             PFDR_difRcd=0.0, PFDR_difTol=1e-4,
                             PFDR_itMax=10_000, verbose=0, monitor=False,
                             x0=None, container="auto") -> PFDROutput:
    dtype = _dtype_of(Y, A)
    a = jnp.asarray(np.asarray(A), dtype)
    g = _graph(Eu, Ev, La_d1, a.shape[1], dtype, container)
    return _pfdr_run(DenseOp(a), jnp.asarray(np.asarray(Y), dtype), g, None,
                     VertexProx(kind="bounds", lo=float(m), hi=float(M)),
                     L, PFDR_rho, PFDR_condMin, PFDR_difRcd, PFDR_difTol,
                     PFDR_itMax, monitor, x0, verbose)


def pfdr_quadratic_d1_bounds_AtA(AtY, AtA, Eu, Ev, La_d1, m=-np.inf,
                                 M=np.inf, L=None, PFDR_rho=1.0,
                                 PFDR_condMin=1e-3, PFDR_difRcd=0.0,
                                 PFDR_difTol=1e-4, PFDR_itMax=10_000,
                                 verbose=0, monitor=False, x0=None,
                                 container="auto") -> PFDROutput:
    dtype = _dtype_of(AtY, AtA)
    gram = jnp.asarray(np.asarray(AtA), dtype)
    g = _graph(Eu, Ev, La_d1, gram.shape[1], dtype, container)
    return _pfdr_run(GramOp(gram), jnp.asarray(np.asarray(AtY), dtype), g,
                     None,
                     VertexProx(kind="bounds", lo=float(m), hi=float(M)),
                     L, PFDR_rho, PFDR_condMin, PFDR_difRcd, PFDR_difTol,
                     PFDR_itMax, monitor, x0, verbose)


def pfdr_l22_d1_bounds(Y, La_l2, Eu, Ev, La_d1, m=-np.inf, M=np.inf,
                       L=None, PFDR_rho=1.0, PFDR_condMin=1e-3,
                       PFDR_difRcd=0.0, PFDR_difTol=1e-4, PFDR_itMax=10_000,
                       verbose=0, monitor=False, x0=None,
                       container="auto") -> PFDROutput:
    Y = np.asarray(Y)
    dtype = _dtype_of(Y, La_l2 if La_l2 is not None else Y)
    num_v = Y.shape[0]
    g = _graph(Eu, Ev, La_d1, num_v, dtype, container)
    if La_l2 is None:
        op, obs = IdentityOp(), jnp.asarray(Y, dtype)
    else:
        w = np.broadcast_to(np.asarray(La_l2), (num_v,))
        op, obs = DiagOp(jnp.asarray(w, dtype)), jnp.asarray(w * Y, dtype)
    return _pfdr_run(op, obs, g, None,
                     VertexProx(kind="bounds", lo=float(m), hi=float(M)),
                     L, PFDR_rho, PFDR_condMin, PFDR_difRcd, PFDR_difTol,
                     PFDR_itMax, monitor, x0, verbose)


def pfdr_loss_d1_simplex_api(Q, al, Eu, Ev, La_d1, La_f=None, PFDR_rho=1.0,
                             PFDR_condMin=1e-3, PFDR_difRcd=0.0,
                             PFDR_difTol=1e-4, PFDR_itMax=10_000, verbose=0,
                             monitor=False, P0=None) -> PFDROutput:
    """Standalone multi-label inner solver
    (``octave/mex/PFDR_graph_loss_d1_simplex_mex.cpp``)."""
    Q = np.asarray(Q)
    dtype = _dtype_of(Q)
    g = _graph(Eu, Ev, La_d1, Q.shape[0], dtype)
    res = pfdr_loss_d1_simplex(
        g, jnp.asarray(Q, dtype), al=float(al),
        la_f=None if La_f is None else jnp.asarray(
            np.broadcast_to(np.asarray(La_f), (Q.shape[0],)), dtype),
        p0=None if P0 is None else jnp.asarray(np.asarray(P0), dtype),
        opt=_pfdr_options(PFDR_rho, PFDR_condMin, PFDR_difRcd, PFDR_difTol,
                          PFDR_itMax, verbose),
        monitor=monitor)
    it = int(res.it)
    return PFDROutput(np.asarray(res.p), it,
                      np.asarray(res.obj)[:it + 1] if monitor
                      else np.zeros(0),
                      np.asarray(res.dif)[:it] if monitor else np.zeros(0))


# ---------------------------------------------------------------------------
# Boost.Python-compatible entry
# ---------------------------------------------------------------------------

def CP_quadratic_l1(obs, source, target, edge_weight, A, l1_weight=0.0,
                    positivity=0, PFDR_rho=1.0, PFDR_condMin=1e-3,
                    CP_difTol=1e-3, PFDR_difRcd=0.0, PFDR_difTol=1e-4,
                    CP_itMax=10, PFDR_itMax=10_000, verbose=0,
                    inexact="auto"):
    """Drop-in analog of the reference Python binding
    (``python/CP_quadratic_l1_py.cpp:368-420``): infers the operator mode
    from the shape of ``A`` — scalar 1 = identity; length-N vector =
    diagonal (squares ``A`` and premultiplies ``obs``, ``:118-129``); (N, V)
    matrix = dense — and returns ``(Cv, rX)``.
    """
    obs = np.asarray(obs)
    a = np.asarray(A)
    n = obs.shape[0]
    if a.ndim == 0 or a.size == 1:
        num_v = n
        op = IdentityOp()
        obs_dev = obs
        scale = float(np.ravel(a)[0]) if a.size else 1.0
        if scale != 1.0:
            op = DiagOp(jnp.asarray(np.full(num_v, scale * scale)))
            obs_dev = scale * obs
    elif a.ndim == 1:
        if a.shape[0] != n:
            raise ValueError("A should be a scalar, a vector of size N, "
                             "or an N-by-V matrix")
        num_v = n
        op = DiagOp(jnp.asarray(a * a))
        obs_dev = a * obs
    else:
        if a.shape[0] != n:
            raise ValueError("A should be a scalar, a vector of size N, "
                             "or an N-by-V matrix")
        num_v = a.shape[1]
        op = DenseOp(jnp.asarray(a))
        obs_dev = obs
    dtype = _dtype_of(obs, a)
    g = _graph(np.asarray(source), np.asarray(target), edge_weight, num_v,
               dtype)
    la_l1 = np.broadcast_to(np.asarray(l1_weight), (num_v,))
    opt = _cp_options(CP_difTol, CP_itMax, PFDR_rho, PFDR_condMin,
                      PFDR_difRcd, PFDR_difTol, PFDR_itMax, verbose,
                      inexact)
    res = cp_quadratic_d1(op, jnp.asarray(obs_dev, dtype), g, la_l1=la_l1,
                          positivity=bool(positivity), opt=opt)
    return res.cv, res.rx
