"""Vertex-block (halo-exchange) distribution of stencil-graph PFDR.

The scaling story of SURVEY §5: partition the vertex field into contiguous
row blocks, one per device; per-edge work is local except at block
boundaries, where each device exchanges a halo of ``max |dy|`` rows with
its ring neighbors via ``lax.ppermute`` (NCCL between GPUs).  Unlike the
replicated-x data parallelism in :mod:`.dp`, the iterate itself is sharded,
so the graph can
exceed single-device memory; the only per-iteration communication is the
halo exchange (O(W) words) plus scalar psums for the stopping test.

The dense operator is column-sharded to match: each device holds the columns
of ``A`` for its vertex rows; ``A x`` is a local matmul + psum, the adjoint
and Gram diagonal are purely local.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as P

from ..config import Lipsch, PFDROptions
from ..operators import DenseOp, _mm
from ..solvers.pfdr_quadratic import (PFDRResult, VertexProx,
                                      pfdr_quadratic_d1)
from ..solvers.pfdr_simplex import SimplexResult, pfdr_loss_d1_simplex
from ..stencil import StencilGraphD1


@jax.tree_util.register_pytree_node_class
class HaloStencilGraphD1(StencilGraphD1):
    """One row-block shard of a stencil graph, used inside ``shard_map``.

    ``field_shape`` is the *local* block ``(H_loc, W)``; endpoint access
    and edge->vertex accumulation exchange ``halo`` boundary rows with ring
    neighbors.  The ring naturally realizes a wrapped global axis 0; for a
    non-wrapped global field the boundary families carry zero weight in
    the first/last blocks, making the wrapped halo inert.
    """

    def __init__(self, la_d1, field_shape, shifts, wrap, axis_name: str):
        super().__init__(la_d1, field_shape, shifts, wrap)
        self.shard_axis = axis_name
        self.halo = max((abs(dy) for dy, _ in self.shifts), default=0)

    # -- halo exchange ------------------------------------------------------

    def _extend_rows(self, x3):
        """Returns ``x3`` with ``halo`` rows from the ring neighbors
        prepended/appended along axis 0."""
        hd = self.halo
        if hd == 0:
            return x3
        n = jax.lax.psum(1, self.shard_axis)
        up = [(i, (i + 1) % n) for i in range(n)]    # dst p gets from p-1
        dn = [(i, (i - 1) % n) for i in range(n)]    # dst p gets from p+1
        top = jax.lax.ppermute(x3[-hd:], self.shard_axis, up)
        bot = jax.lax.ppermute(x3[:hd], self.shard_axis, dn)
        return jnp.concatenate([top, x3, bot], axis=0)

    def gather_endpoints(self, x):
        f = len(self.shifts)
        h, _ = self.field_shape
        x3 = self._fields(x)
        ext = self._extend_rows(x3)
        hd = self.halo
        xu = jnp.broadcast_to(x3[None], (f,) + x3.shape)
        xv = jnp.stack([
            jnp.roll(jax.lax.dynamic_slice_in_dim(ext, hd + dy, h, 0),
                     -dx, axis=1)
            for (dy, dx) in self.shifts])
        flat = (self.num_edges,) + x.shape[1:]
        return xu.reshape(flat), xv.reshape(flat)

    def edge_to_vertex_sum(self, vals_u, vals_v):
        f = len(self.shifts)
        h, w = self.field_shape
        hd = self.halo
        vu = vals_u.reshape((f, h, w) + vals_u.shape[1:])
        vv = vals_v.reshape((f, h, w) + vals_v.shape[1:])
        out = jnp.sum(vu, axis=0)
        # vv contributions land at (i+dy, j+dx): extend each family's field
        # and take the inversely shifted window
        ext = self._extend_rows(jnp.moveaxis(vv, 0, 1))  # rows axis first
        ext = jnp.moveaxis(ext, 1, 0)                    # back to [F, ...]
        for k, (dy, dx) in enumerate(self.shifts):
            win = jax.lax.dynamic_slice_in_dim(ext[k], hd - dy, h, 0)
            out = out + jnp.roll(win, dx, axis=1)
        return out.reshape((self.num_vertices,) + vals_u.shape[1:])

    def vertex_allsum(self, vals):
        return jax.lax.psum(jnp.sum(vals), self.shard_axis)

    def edge_allsum(self, vals):
        return jax.lax.psum(jnp.sum(vals), self.shard_axis)

    def vertex_count_global(self):
        return self.num_vertices * jax.lax.psum(1, self.shard_axis)

    def tree_flatten(self):
        return (self.la_d1,), (self.field_shape, self.shifts, self.wrap,
                               self.shard_axis)

    @classmethod
    def tree_unflatten(cls, aux, children):
        field_shape, shifts, wrap, axis_name = aux
        return cls(children[0], field_shape, shifts, wrap, axis_name)


@jax.tree_util.register_pytree_node_class
class ColShardDenseOp(DenseOp):
    """Dense operator with its V (column) axis sharded to match a
    vertex-sharded iterate: ``A x`` psums partial products; the adjoint and
    Gram diagonal are local."""

    def __init__(self, a, axis_name: str):
        super().__init__(a)
        self.axis_name = axis_name

    def apply(self, x):
        return jax.lax.psum(_mm(self.a, x), self.axis_name)

    def residual(self, x, obs):
        return obs - self.apply(x)

    def gram_apply(self, x):
        return _mm(self.a.T, self.apply(x))

    def ones_image(self, num_vertices, obs):
        a1 = jax.lax.psum(jnp.sum(self.a, axis=1), self.axis_name)
        return jnp.vdot(a1, obs), jnp.vdot(a1, a1)

    def tree_flatten(self):
        return (self.a,), self.axis_name

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(children[0], aux)


class HaloShardedProblem(NamedTuple):
    a: np.ndarray        # [P, N, V_loc] column blocks
    obs: np.ndarray      # [N]
    la_d1: np.ndarray    # [P, F * H_loc * W]
    field_shape: tuple   # global (H, W)
    shifts: tuple
    wrap: tuple


def shard_stencil_problem(a, obs, graph: StencilGraphD1,
                          num_shards: int) -> HaloShardedProblem:
    """Splits the field's rows (and the dense operator's columns) into
    ``num_shards`` blocks.  Requires H divisible by num_shards and block
    height >= the halo depth."""
    h, w = graph.field_shape
    if h % num_shards:
        raise ValueError(f"H={h} not divisible by {num_shards} shards")
    h_loc = h // num_shards
    hd = max((abs(dy) for dy, _ in graph.shifts), default=0)
    if h_loc < hd:
        raise ValueError(f"block height {h_loc} smaller than halo {hd}")
    f = len(graph.shifts)
    la = np.asarray(graph.la_d1).reshape(f, h, w)
    la_s = np.stack([la[:, p * h_loc:(p + 1) * h_loc, :].reshape(-1)
                     for p in range(num_shards)])
    a = np.asarray(a)
    a_s = np.stack([
        a.reshape(a.shape[0], h, w)[:, p * h_loc:(p + 1) * h_loc, :]
        .reshape(a.shape[0], -1) for p in range(num_shards)])
    return HaloShardedProblem(a_s, np.asarray(obs), la_s, (h, w),
                              graph.shifts, graph.wrap)


def pfdr_quadratic_d1_halo(problem: HaloShardedProblem, mesh: Mesh, *,
                           la_l1=None, vprox: VertexProx = VertexProx(),
                           lipsch=None, ltype: Lipsch = Lipsch.SCAL,
                           opt: PFDROptions = PFDROptions(),
                           axis: str = "dp"):
    """Runs the PFDR solve with a row-sharded iterate under shard_map;
    returns the result with ``x`` gathered back to the full [V]."""
    h, w = problem.field_shape
    num_shards = mesh.devices.size
    h_loc = h // num_shards
    dtype = problem.obs.dtype
    has_l1 = la_l1 is not None
    la_l1 = np.asarray(np.broadcast_to(
        la_l1 if has_l1 else 0.0, (h * w,)), dtype)
    la_l1_s = jnp.asarray(np.stack(
        [la_l1.reshape(h, w)[p * h_loc:(p + 1) * h_loc].reshape(-1)
         for p in range(num_shards)]))

    def solve(a_loc, la_loc, la_l1_loc, obs):
        op = ColShardDenseOp(a_loc[0], axis)
        graph = HaloStencilGraphD1(la_loc[0], (h_loc, w), problem.shifts,
                                   problem.wrap, axis)
        res = pfdr_quadratic_d1(op, obs, graph,
                                la_l1=la_l1_loc[0] if has_l1 else None,
                                vprox=vprox, lipsch=lipsch, ltype=ltype,
                                opt=opt)
        # x is row-sharded; expose it with a leading shard axis
        return res._replace(x=res.x[None])

    in_specs = (P(axis), P(axis), P(axis), P())
    out_specs = PFDRResult(x=P(axis), it=P(), obj=P(), dif=P())
    sharded = jax.shard_map(solve, mesh=mesh,
                            in_specs=in_specs, out_specs=out_specs,
                            check_vma=False)
    from .mesh import put_sharded
    res = sharded(put_sharded(problem.a, mesh, P(axis)),
                  put_sharded(problem.la_d1, mesh, P(axis)),
                  put_sharded(np.asarray(la_l1_s), mesh, P(axis)),
                  put_sharded(problem.obs, mesh, P()))
    return res._replace(x=res.x.reshape(-1))


class HaloSimplexProblem(NamedTuple):
    q: np.ndarray        # [P, H_loc * W, K] row blocks of the observation
    la_d1: np.ndarray    # [P, F * H_loc * W]
    la_f: np.ndarray     # [P, H_loc * W] or None
    field_shape: tuple   # global (H, W)
    shifts: tuple
    wrap: tuple


def shard_stencil_simplex_problem(q, graph: StencilGraphD1,
                                  num_shards: int,
                                  la_f=None) -> HaloSimplexProblem:
    """Row-block partition of a multi-label stencil problem: both the
    [V, K] observation/iterate and the per-(edge,label) work are sharded,
    so graphs can exceed single-device memory; per-iteration communication is
    the O(W K) halo exchange."""
    h, w = graph.field_shape
    if h % num_shards:
        raise ValueError(f"H={h} not divisible by {num_shards} shards")
    h_loc = h // num_shards
    hd = max((abs(dy) for dy, _ in graph.shifts), default=0)
    if h_loc < hd:
        raise ValueError(f"block height {h_loc} smaller than halo {hd}")
    f = len(graph.shifts)
    q = np.asarray(q)
    k = q.shape[-1]
    la = np.asarray(graph.la_d1).reshape(f, h, w)
    la_s = np.stack([la[:, p * h_loc:(p + 1) * h_loc, :].reshape(-1)
                     for p in range(num_shards)])
    q_s = q.reshape(h, w, k).reshape(num_shards, h_loc * w, k)
    if la_f is not None:
        la_f = np.asarray(np.broadcast_to(la_f, (h * w,)), q.dtype)
        la_f = la_f.reshape(num_shards, h_loc * w)
    return HaloSimplexProblem(q_s, la_s, la_f, (h, w), graph.shifts,
                              graph.wrap)


def pfdr_loss_d1_simplex_halo(problem: HaloSimplexProblem, mesh: Mesh, *,
                              al: float,
                              opt: PFDROptions = PFDROptions(),
                              monitor: bool = False,
                              axis: str = "dp") -> SimplexResult:
    """Runs the multi-label PFDR solve with a row-sharded [V, K] iterate
    under shard_map; returns the result with ``p`` gathered to [V, K]."""
    h, w = problem.field_shape
    num_shards = mesh.devices.size
    h_loc = h // num_shards
    has_laf = problem.la_f is not None

    def solve(q_loc, la_loc, la_f_loc):
        graph = HaloStencilGraphD1(la_loc[0], (h_loc, w), problem.shifts,
                                   problem.wrap, axis)
        res = pfdr_loss_d1_simplex(
            graph, q_loc[0], al=al,
            la_f=la_f_loc[0] if has_laf else None, opt=opt, monitor=monitor)
        return res._replace(p=res.p[None])

    la_f_s = (jnp.asarray(problem.la_f) if has_laf else
              jnp.zeros(problem.q.shape[:2], problem.q.dtype))
    out_specs = SimplexResult(p=P(axis), it=P(), obj=P(), dif=P())
    sharded = jax.shard_map(solve, mesh=mesh,
                            in_specs=(P(axis), P(axis), P(axis)),
                            out_specs=out_specs, check_vma=False)
    from .mesh import put_sharded
    res = sharded(put_sharded(problem.q, mesh, P(axis)),
                  put_sharded(problem.la_d1, mesh, P(axis)),
                  put_sharded(np.asarray(la_f_s), mesh, P(axis)))
    return res._replace(p=res.p.reshape(h * w, -1))
