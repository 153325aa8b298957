"""Multi-chip PFDR: observation- and edge-sharded data parallelism.

The reference is single-process OpenMP only (SURVEY §2.6); distribution is a
new capability.  Partitioning chosen here for the full-graph PFDR solve:

* the observation axis ``N`` of the dense operator is sharded across the
  mesh (each chip holds a row block of ``A`` and of ``y``) — the gradient
  ``A^t r`` becomes one ``psum`` per iteration;
* the edge set is sharded (each chip holds an edge block plus its *local*
  incidence-gather table) — the edge prox is embarrassingly parallel and
  the edge->vertex averaging is a local gather-sum followed by a ``psum``;
* the iterate ``x`` ([V]) is replicated: vertex-wise work is tiny compared
  to the edge/observation work, and replication makes the two collectives
  above the *only* communication per iteration.

A vertex-block partition with halo exchange (for graphs too large to
replicate ``x``) is the natural extension of the same structure.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as P

from ..config import Lipsch, PFDROptions
from ..graph import GraphD1, _build_incidence
from ..operators import DenseOp, _mm
from ..solvers.pfdr_quadratic import (PFDRResult, VertexProx,
                                      pfdr_quadratic_d1)
from ..solvers.pfdr_simplex import SimplexResult, pfdr_loss_d1_simplex


@jax.tree_util.register_pytree_node_class
class DistDenseOp(DenseOp):
    """Dense operator whose N (observation) axis lives sharded across a
    mesh axis; adjoint applications and scalar reductions psum."""

    def __init__(self, a, axis_name: str):
        super().__init__(a)
        self.axis_name = axis_name

    def apply_t(self, r):
        return jax.lax.psum(_mm(self.a.T, r), self.axis_name)

    def gram_diag(self, num_vertices, dtype):
        return jax.lax.psum(jnp.sum(self.a * self.a, axis=0),
                            self.axis_name).astype(dtype)

    def quad_obj(self, x, obs):
        r = self.residual(x, obs)
        return 0.5 * jax.lax.psum(jnp.vdot(r, r), self.axis_name)

    def ones_image(self, num_vertices, obs):
        a1 = jnp.sum(self.a, axis=1)
        return (jax.lax.psum(jnp.vdot(a1, obs), self.axis_name),
                jax.lax.psum(jnp.vdot(a1, a1), self.axis_name))

    def tree_flatten(self):
        return (self.a,), self.axis_name

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(children[0], aux)


class ShardedQuadraticProblem(NamedTuple):
    """Host-prepared shards (leading axis = mesh axis)."""
    a: np.ndarray          # [P, N/P, V]
    obs: np.ndarray        # [P, N/P]
    eu: np.ndarray         # [P, E/P]
    ev: np.ndarray         # [P, E/P]
    la_d1: np.ndarray      # [P, E/P]
    incidence: np.ndarray  # [P, V, D] local slot tables
    num_vertices: int


def _pad_to(x, n, axis=0):
    pad = n - x.shape[axis]
    if pad <= 0:
        return x
    widths = [(0, 0)] * x.ndim
    widths[axis] = (0, pad)
    return np.pad(x, widths)


def _shard_edges(eu, ev, la_d1, num_shards: int, num_vertices: int,
                 dtype=np.float32):
    """Splits the edge set into ``num_shards`` balanced blocks and
    precomputes each block's local incidence table (padded to a common
    width).  Zero-weight spread self-loops pad the remainder — inert in
    the solvers."""
    eu = np.asarray(eu, np.int32)
    ev = np.asarray(ev, np.int32)
    la = np.asarray(np.broadcast_to(la_d1, eu.shape), dtype)
    v = num_vertices
    e = eu.shape[0]
    e_pad = -(-e // num_shards) * num_shards
    extra = e_pad - e
    if extra:
        spread = (np.arange(extra) % v).astype(np.int32)
        eu = np.concatenate([eu, spread])
        ev = np.concatenate([ev, spread])
        la = np.concatenate([la, np.zeros(extra, dtype)])

    e_loc = e_pad // num_shards
    eu_s = eu.reshape(num_shards, e_loc)
    ev_s = ev.reshape(num_shards, e_loc)
    la_s = la.reshape(num_shards, e_loc)
    incs = [_build_incidence(eu_s[p], ev_s[p], v) for p in range(num_shards)]
    d = max(i.shape[1] for i in incs)
    # width-pad with the local zero-slot sentinel 2*E_loc
    inc_s = np.stack([
        np.concatenate(
            [i, np.full((v, d - i.shape[1]), 2 * e_loc, np.int32)], axis=1)
        if i.shape[1] < d else i for i in incs])
    return eu_s, ev_s, la_s, inc_s


def shard_quadratic_problem(a, obs, eu, ev, la_d1, num_shards: int,
                            dtype=np.float32) -> ShardedQuadraticProblem:
    """Splits observations and edges into ``num_shards`` balanced blocks.
    Zero rows / zero-weight spread self-loops pad the remainders — both
    are inert in the solver."""
    a = np.asarray(a, dtype)
    obs = np.asarray(obs, dtype)
    n, v = a.shape

    n_pad = -(-n // num_shards) * num_shards
    a = _pad_to(a, n_pad)
    obs = _pad_to(obs, n_pad)
    eu_s, ev_s, la_s, inc_s = _shard_edges(eu, ev, la_d1, num_shards, v,
                                           dtype)
    return ShardedQuadraticProblem(
        a.reshape(num_shards, n_pad // num_shards, v),
        obs.reshape(num_shards, n_pad // num_shards),
        eu_s, ev_s, la_s, inc_s, v)


def pfdr_quadratic_d1_sharded(problem: ShardedQuadraticProblem, mesh: Mesh,
                              *, la_l1=None,
                              vprox: VertexProx = VertexProx(),
                              lipsch=None, ltype: Lipsch = Lipsch.SCAL,
                              opt: PFDROptions = PFDROptions(),
                              axis: str = "dp") -> PFDRResult:
    """Runs the full PFDR solve under ``shard_map`` on ``mesh``.

    Communication per iteration: one psum for the gradient adjoint, one for
    the edge->vertex averaging (plus scalar psums for the stopping test
    inputs computed from replicated vertex arrays, which are free).
    """
    num_v = problem.num_vertices
    dtype = problem.obs.dtype
    if la_l1 is not None:
        la_l1 = jnp.asarray(np.broadcast_to(la_l1, (num_v,)), dtype)

    def solve(a_loc, obs_loc, eu_loc, ev_loc, la_loc, inc_loc):
        op = DistDenseOp(a_loc[0], axis)
        graph = GraphD1(eu_loc[0], ev_loc[0], la_loc[0], num_v,
                        incidence=inc_loc[0], axis_name=axis)
        return pfdr_quadratic_d1(op, obs_loc[0], graph, la_l1=la_l1,
                                 vprox=vprox, lipsch=lipsch, ltype=ltype,
                                 opt=opt)

    sharded = jax.shard_map(
        solve, mesh=mesh,
        in_specs=(P(axis), P(axis), P(axis), P(axis), P(axis), P(axis)),
        out_specs=P(),
        check_vma=False)
    # device_put with a NamedSharding (not jnp.asarray): each process
    # uploads only its addressable shards, so the same call spans hosts
    from .mesh import put_sharded
    sh = P(axis)
    return sharded(put_sharded(problem.a, mesh, sh),
                   put_sharded(problem.obs, mesh, sh),
                   put_sharded(problem.eu, mesh, sh),
                   put_sharded(problem.ev, mesh, sh),
                   put_sharded(problem.la_d1, mesh, sh),
                   put_sharded(problem.incidence, mesh, sh))


class ShardedSimplexProblem(NamedTuple):
    """Host-prepared edge shards for the multi-label problem; the [V, K]
    observation (and iterate) stay replicated."""
    q: np.ndarray          # [V, K]
    eu: np.ndarray         # [P, E/P]
    ev: np.ndarray         # [P, E/P]
    la_d1: np.ndarray      # [P, E/P]
    incidence: np.ndarray  # [P, V, D]
    num_vertices: int


def shard_simplex_problem(q, eu, ev, la_d1, num_shards: int,
                          dtype=np.float32) -> ShardedSimplexProblem:
    """Edge partition of a loss+d1+simplex problem: per-(edge,label) prox
    work is split across the mesh; the [V, K] state is replicated (vertex
    work — loss gradient, simplex projection — is O(V K), small next to
    the O(E K / P) edge slabs)."""
    q = np.asarray(q, dtype)
    v = q.shape[0]
    eu_s, ev_s, la_s, inc_s = _shard_edges(eu, ev, la_d1, num_shards, v,
                                           dtype)
    return ShardedSimplexProblem(q, eu_s, ev_s, la_s, inc_s, v)


def pfdr_loss_d1_simplex_sharded(problem: ShardedSimplexProblem, mesh: Mesh,
                                 *, al: float, la_f=None,
                                 opt: PFDROptions = PFDROptions(),
                                 monitor: bool = False,
                                 axis: str = "dp") -> SimplexResult:
    """Runs the multi-label PFDR solve under ``shard_map``.

    Communication per iteration: one [V, K] psum for the edge->vertex
    averaging (the loss gradient and the simplex projection act on the
    replicated state and need none)."""
    num_v = problem.num_vertices
    dtype = problem.q.dtype
    if la_f is not None:
        la_f = jnp.asarray(np.broadcast_to(la_f, (num_v,)), dtype)

    def solve(q, eu_loc, ev_loc, la_loc, inc_loc):
        graph = GraphD1(eu_loc[0], ev_loc[0], la_loc[0], num_v,
                        incidence=inc_loc[0], axis_name=axis)
        return pfdr_loss_d1_simplex(graph, q, al=al, la_f=la_f, opt=opt,
                                    monitor=monitor)

    sharded = jax.shard_map(
        solve, mesh=mesh,
        in_specs=(P(), P(axis), P(axis), P(axis), P(axis)),
        out_specs=P(),
        check_vma=False)
    from .mesh import put_sharded
    sh = P(axis)
    return sharded(put_sharded(problem.q, mesh, P()),
                   put_sharded(problem.eu, mesh, sh),
                   put_sharded(problem.ev, mesh, sh),
                   put_sharded(problem.la_d1, mesh, sh),
                   put_sharded(problem.incidence, mesh, sh))
