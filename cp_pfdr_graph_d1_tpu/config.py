"""Typed solver configuration.

The reference passes every knob positionally (e.g.
``/root/reference/src/PFDR_graph_quadratic_d1_l1.cpp:270`` takes 22 positional
arguments); the only defaults live in the Python binding
(``/root/reference/python/CP_quadratic_l1_py.cpp:68-76``).  Here the knobs are
typed dataclasses carrying those same defaults.
"""
from __future__ import annotations

import dataclasses
import enum


class Lipsch(enum.Enum):
    """How the Lipschitz information ``L`` is interpreted.

    Mirrors the ``Lipschtype {SCAL, DIAG}`` enum of the reference
    (``/root/reference/include/PFDR_graph_quadratic_d1_l1.hpp:34``): ``SCAL``
    means ``L`` is a scalar bound on the operator norm of the Hessian, ``DIAG``
    means ``L`` is a per-vertex diagonal metric such that ``diag(L) - Hessian``
    is positive semi-definite.
    """

    SCAL = 0
    DIAG = 1


@dataclasses.dataclass(frozen=True)
class PFDROptions:
    """Options of the inner preconditioned forward-Douglas-Rachford solver.

    Defaults follow the reference Python binding
    (``/root/reference/python/CP_quadratic_l1_py.cpp:68-76``).

    Attributes:
      rho: relaxation parameter, in ]0, 2[.
      cond_min: small positive floor improving stability of the
        preconditioning (a typical value is 1e-3).
      dif_rcd: reconditioning threshold on the relative iterate evolution;
        a reconditioning is triggered (and the threshold divided by 100)
        whenever the evolution falls below it.  0 disables reconditioning.
      dif_tol: stopping threshold on the relative iterate evolution.
      it_max: maximum number of iterations.
      verbose: 0 silences the solver; a positive value prints an
        iteration/evolution progress line every ``verbose`` iterations
        from inside the jitted loop (host callback) — the analog of the
        reference's per-iteration printf
        (``PFDR_graph_quadratic_d1_l1.cpp:43-55``).
    """

    rho: float = 1.0
    cond_min: float = 1e-3
    dif_rcd: float = 0.0
    dif_tol: float = 1e-4
    it_max: int = 10_000
    verbose: int = 0


@dataclasses.dataclass(frozen=True)
class CPOptions:
    """Options of the outer cut-pursuit loop.

    Defaults follow ``/root/reference/python/CP_quadratic_l1_py.cpp:68-76``.

    Attributes:
      dif_tol: stopping threshold on relative iterate evolution between two
        cut-pursuit iterations.  For the multi-label (simplex) solver, a value
        >= 1 switches to counting changed maximum-likelihood labels instead.
      it_max: maximum number of cut-pursuit iterations (graph cuts).
      pfdr: options of the inner PFDR solver run on each reduced problem.
      verbose: 0 silences the solver, a positive value prints progress.
      host_small: "auto" routes reduced problems below ``host_small_max``
        components to the native C++ PFDR on the host whenever the main
        backend is an accelerator (per-dispatch latency dwarfs the math of
        a ~10..100-component solve); "on"/"off" force the choice.
      host_small_max: component-count crossover for the native path.
      cut: "host" solves the steepest binary cuts with the native
        push-relabel on the host; "device" solves them on the accelerator
        via the certified binary-TV relaxation
        (:mod:`..maxflow.device`) — no host round trip of the graph, for
        full graphs that live on device; applies to the quadratic
        steepest cuts, the duplex ternary cut (two-layer PDHG with the
        coarea certificate), and the multi-label alpha-expansion cuts.
      cut_tol: duality-gap certificate of the device min-cut (relative to
        the problem's cost scale); an uncertified cut triggers a warning
        and a fallback to the host solver.
      cut_it_max: iteration cap of the device min-cut's PDHG loop.
      inexact: "auto" caps the PFDR iterations of *intermediate* reduced
        solves at ``inexact_cap`` (full accuracy is wasted while cuts are
        still changing the partition) and finishes with one full-accuracy
        solve on the settled partition, so the returned solution meets the
        caller's ``pfdr.dif_tol``/``it_max`` contract; "off" runs every
        reduced solve at full accuracy (the reference's behavior,
        ``CP_PFDR_graph_quadratic_d1_l1.cpp:842-859``).
      inexact_cap: iteration cap for intermediate reduced solves.
    """

    dif_tol: float = 1e-3
    it_max: int = 10
    pfdr: PFDROptions = dataclasses.field(default_factory=PFDROptions)
    verbose: int = 0
    host_small: str = "auto"
    host_small_max: int = 1024
    cut: str = "host"
    cut_tol: float = 1e-6
    cut_it_max: int = 200_000
    inexact: str = "auto"
    inexact_cap: int = 3000


# Parameters used by the reference cut-pursuit solvers for the power-method
# estimation of the reduced operator norm
# (/root/reference/src/CP_PFDR_graph_quadratic_d1_l1.cpp:270-274).
OPERATOR_NORM_TOL = 1e-3
OPERATOR_NORM_IT_MAX = 100
OPERATOR_NORM_NB_INIT = 10
