"""Distributed cut-pursuit over a device mesh (GSPMD data placement).

The reference cut-pursuit is single-process OpenMP only
(``/root/reference/src/CP_PFDR_graph_quadratic_d1_l1.cpp:212``,
SURVEY §2.6); multi-device operation is a new capability, targeted at the
large-dense-operator / precomputed-``A^t A`` fused-LASSO configuration.

Design.  Every FLOP-heavy stage of the outer loop — the full-graph
gradient ``A^t (A x - y)`` (``CP_PFDR_graph_quadratic_d1_l1.cpp:339-374``),
the one-hot reduced-operator contraction (``:663-772``), the power-method
Lipschitz metric (``:774-836``) and the reduced PFDR solve — is already an
matmul pipeline under ``jax.jit``.  Distributing them is therefore a
*data placement* problem, solved the idiomatic XLA way: place the operator
with a :class:`~jax.sharding.NamedSharding` over the mesh and let the SPMD
partitioner insert the collectives.  Per CP iteration that is one [V]
all-reduce for the gradient and one [rV, rV] (or [N/P, rV]-local) reduction
for the reduced operator; the reduced PFDR solve keeps the reduced dense
operator observation-sharded, costing one [rV] all-reduce per inner
iteration.  The combinatorial stages — steepest min-cut, connected
components, contraction, merging — are O(E) index manipulation, not FLOPs;
they run on host on the replicated [V] arrays the collectives produce,
exactly as in the single-device solver (SURVEY §5's replicated-host
orchestration).

Shardings:

* dense mode (``DenseOp``): the observation axis N is sharded — each chip
  holds an [N/P, V] row block of A and the matching y block.  N is padded
  with zero rows (a zero observation row is inert in every product the
  solver forms: residual, gradient, objective, ones-image, column sums).
* gram mode (``GramOp``, the reference's premultiplied ``N < 0`` path):
  the V-by-V Gram is row-sharded — requires ``V %% mesh size == 0`` (pad
  the graph with isolated vertices upstream if needed).
* diag/identity modes: vertex work is O(V); the operator is replicated
  (cut-pursuit cost there is the min-cut, which is host-side anyway).

The full-graph *inner* PFDR solvers have their own explicitly
collective-programmed distributions (``parallel/dp.py`` edge/observation
sharding, ``parallel/halo.py`` vertex sharding with ring halo exchange);
this module distributes the outer loop, whose hot axis is the operator.
"""
from __future__ import annotations

import dataclasses

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding
from jax.sharding import PartitionSpec as P

from ..config import CPOptions
from ..graph import GraphD1
from ..operators import DenseOp, DiagOp, GramOp, IdentityOp, QuadOp
from ..solvers.cut_pursuit import CPResult, CPState, cp_quadratic_d1


def shard_cp_quadratic_problem(op: QuadOp, obs, mesh: Mesh,
                               axis: str = "dp"):
    """Places the quadratic operator and observation sharded over ``mesh``.

    Returns ``(op, obs)`` with device-resident, mesh-sharded arrays, ready
    for :func:`cp_quadratic_d1_dist`.  Dense operators are zero-padded
    along the observation axis to a multiple of the mesh size; Gram
    operators require the vertex count to divide evenly.
    """
    n_dev = int(np.prod([mesh.shape[a] for a in (axis,)]))
    if isinstance(op, DenseOp):
        a = np.asarray(op.a)
        obs = np.asarray(obs)
        n = a.shape[0]
        n_pad = -(-n // n_dev) * n_dev
        if n_pad != n:
            a = np.pad(a, ((0, n_pad - n), (0, 0)))
            obs = np.pad(obs, (0, n_pad - n))
        sh = NamedSharding(mesh, P(axis, None))
        return (DenseOp(jax.device_put(a, sh)),
                jax.device_put(obs, NamedSharding(mesh, P(axis))))
    if isinstance(op, GramOp):
        g = np.asarray(op.gram)
        v = g.shape[0]
        if v % n_dev:
            raise ValueError(
                f"gram mode needs num_vertices ({v}) divisible by the mesh "
                f"size ({n_dev}); pad the graph with isolated vertices")
        sh = NamedSharding(mesh, P(axis, None))
        return (GramOp(jax.device_put(g, sh)),
                jax.device_put(np.asarray(obs), NamedSharding(mesh, P())))
    if isinstance(op, (DiagOp, IdentityOp)):
        rep = NamedSharding(mesh, P())
        if isinstance(op, DiagOp):
            op = DiagOp(jax.device_put(np.asarray(op.diag), rep))
        return op, jax.device_put(np.asarray(obs), rep)
    raise TypeError(f"unsupported operator type {type(op).__name__}")


def cp_loss_d1_simplex_dist(graph: GraphD1, q, mesh: Mesh, *, al: float,
                            opt: CPOptions = CPOptions(),
                            monitor: bool = False,
                            state=None, axis: str = "dp"):
    """Multi-label cut-pursuit with the [V, K] observation sharded over the
    mesh's vertex axis.

    The O(V K) stages — the loss gradient
    (``CP_PFDR_graph_loss_d1_simplex.cpp:327-354``) and the reduced
    barycenter contraction (``:733-766``, a one-hot matmul) — run as
    jitted GSPMD ops on the sharded observation (each chip computes its
    row block; the contraction all-reduces [rV, K]); the combinatorial
    alpha-expansion cuts stay replicated on host, as in the quadratic
    distribution.  Same contract as
    :func:`~..solvers.cut_pursuit_simplex.cp_loss_d1_simplex`.
    """
    import dataclasses as _dc

    from ..solvers.cut_pursuit_simplex import cp_loss_d1_simplex
    q_np = np.asarray(q)
    n_dev = mesh.shape[axis]
    v_pad = -(-q_np.shape[0] // n_dev) * n_dev
    if v_pad != q_np.shape[0]:  # zero rows are inert in every stage
        q_np = np.pad(q_np, ((0, v_pad - q_np.shape[0]), (0, 0)))
    q_sh = jax.device_put(q_np, NamedSharding(mesh, P(axis, None)))
    opt = _dc.replace(opt, host_small="off")
    return cp_loss_d1_simplex(graph, q_sh, al=al, opt=opt, monitor=monitor,
                              state=state, device_obs=True)


def cp_quadratic_d1_dist(op: QuadOp, obs, graph: GraphD1, mesh: Mesh, *,
                         la_l1=None, positivity: bool = False,
                         bounds=None, duplex: bool = False,
                         opt: CPOptions = CPOptions(),
                         monitor: bool = False,
                         state: CPState | None = None,
                         axis: str = "dp") -> CPResult:
    """Cut-pursuit solve with the operator sharded across ``mesh``.

    Same contract as :func:`~..solvers.cut_pursuit.cp_quadratic_d1`
    (component labels ``cv``, values ``rx``, ``Time``/``Obj``/``Dif``
    traces, warm-restart ``state``); the operator/observation may be given
    as host arrays — they are placed via
    :func:`shard_cp_quadratic_problem` — or pre-sharded jax arrays, which
    pass through untouched.
    """
    a = getattr(op, "a", getattr(op, "gram", getattr(op, "diag", None)))
    presharded = (
        isinstance(a, jax.Array)
        and isinstance(a.sharding, NamedSharding)
        and a.sharding.mesh.shape == dict(mesh.shape))
    if not presharded:
        op, obs = shard_cp_quadratic_problem(op, obs, mesh, axis)
    # the host-small native route downloads the operator and runs the
    # gradient on one host — it would serialize exactly the stages this
    # mode distributes
    opt = dataclasses.replace(opt, host_small="off")
    return cp_quadratic_d1(op, obs, graph, la_l1=la_l1,
                           positivity=positivity, bounds=bounds,
                           duplex=duplex, opt=opt, monitor=monitor,
                           state=state)
