"""Device-resident graph container.

The reference encodes the graph as two int arrays ``Eu``/``Ev`` plus per-edge
weights ``La_d1`` (``/root/reference/include/PFDR_graph_quadratic_d1_l1.hpp:62``)
and accumulates edge quantities into vertices with a serial scatter loop
(``/root/reference/src/PFDR_graph_quadratic_d1_l1.cpp:492-497`` — "this task
cannot be easily parallelized").

Device mapping: the edge->vertex accumulation is expressed as pure
*gathers*, which keeps it deterministic: at graph construction we build,
once, a padded incidence table ``inc[v, d]``
listing the edge-endpoint slots incident to each vertex (slot ``e`` is edge
``e``'s u-endpoint, slot ``E + e`` its v-endpoint; the sentinel ``2E`` points
at a zero pad).  The accumulation is then ``take`` + row-sum — fully
parallel, deterministic, and compiler-friendly.  Cost is O(V * max_degree),
which is tight for the mesh/grid graphs this library targets;
:class:`ScatterGraphD1` accumulates with a scatter-add instead, for graphs
whose maximum degree would make that table degenerate.
"""
from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np


def _build_incidence(eu: np.ndarray, ev: np.ndarray, num_vertices: int):
    """Returns int32 [V, D] slot indices (sentinel = 2E) sorted per vertex."""
    num_edges = eu.shape[0]
    slots_vertex = np.concatenate([eu, ev])
    order = np.argsort(slots_vertex, kind="stable")
    degrees = np.bincount(slots_vertex, minlength=num_vertices)
    max_deg = int(degrees.max(initial=0))
    max_deg = max(max_deg, 1)
    inc = np.full((num_vertices, max_deg), 2 * num_edges, dtype=np.int32)
    # positions of each vertex's slots in the sorted order
    offsets = np.zeros(num_vertices + 1, dtype=np.int64)
    np.cumsum(degrees, out=offsets[1:])
    within = np.arange(2 * num_edges, dtype=np.int64) - offsets[
        slots_vertex[order]]
    inc[slots_vertex[order], within] = order.astype(np.int32)
    return inc


@jax.tree_util.register_pytree_node_class
class GraphD1:
    """Static undirected graph with per-edge d1 (total-variation) weights.

    Attributes:
      eu, ev: int32 [E] endpoints of each undirected edge (0-based).
      la_d1: [E] nonnegative edge weights.
      num_vertices, num_edges: static Python ints (shape metadata).
      incidence: int32 [V, D] endpoint-slot indices per vertex
        (D = max degree; sentinel 2E selects a zero pad).
    """

    def __init__(self, eu, ev, la_d1, num_vertices: int, incidence=None,
                 axis_name=None):
        self.eu = eu
        self.ev = ev
        self.la_d1 = la_d1
        self.num_vertices = int(num_vertices)
        self.num_edges = int(eu.shape[0])
        # lazy: the [V, max_degree] incidence table costs an O(E) host sort
        # + a device upload, and the host-orchestrated cut-pursuit path
        # never touches it — built on first transfer use (it must exist
        # before the graph is passed INTO a jit, which the solvers satisfy
        # by calling a transfer method during tracing)
        self._incidence = incidence
        # when set, this graph holds one shard of an edge-partitioned graph
        # inside shard_map: edge->vertex reductions psum over this mesh axis
        self.axis_name = axis_name

    @property
    def incidence(self):
        if self._incidence is None:
            self._incidence = jnp.asarray(_build_incidence(
                np.asarray(self.eu), np.asarray(self.ev),
                self.num_vertices))
        return self._incidence

    @incidence.setter
    def incidence(self, value):
        self._incidence = value

    @classmethod
    def create(cls, eu, ev, la_d1, num_vertices: Optional[int] = None,
               dtype=jnp.float32) -> "GraphD1":
        """Builds a graph from host arrays, validating shapes."""
        # own the host copies: np.asarray is a no-copy for already-matching
        # inputs, and the retained _host_coo must not silently track caller
        # mutations (the device arrays are immutable snapshots)
        eu_in, ev_in, la_in = eu, ev, la_d1
        eu = np.asarray(eu, dtype=np.int32)
        ev = np.asarray(ev, dtype=np.int32)
        la = np.asarray(la_d1, dtype=dtype)
        if eu is eu_in or eu.base is not None:
            eu = eu.copy()
        if ev is ev_in or ev.base is not None:
            ev = ev.copy()
        if la is la_in or la.base is not None:
            la = la.copy()
        if la.ndim == 0:
            la = np.full(eu.shape, la, dtype=la.dtype)
        if eu.shape != ev.shape or eu.shape != la.shape:
            raise ValueError(
                f"edge arrays disagree: eu{eu.shape} ev{ev.shape} la{la.shape}")
        if num_vertices is None:
            num_vertices = int(max(eu.max(initial=-1), ev.max(initial=-1)) + 1)
        if eu.size and (eu.min() < 0 or ev.min() < 0
                        or max(eu.max(), ev.max()) >= num_vertices):
            raise ValueError("edge endpoint out of range")
        g = cls(jnp.asarray(eu), jnp.asarray(ev), jnp.asarray(la),
                num_vertices)
        # the host originals are free here; cut-pursuit's combinatorial
        # stages would otherwise fetch them back from device
        g._host_coo = (eu, ev, la)
        return g

    # -- edge <-> vertex transfer ------------------------------------------

    def gather(self, x):
        """Per-edge endpoint values ``(x[eu], x[ev])``; x is [V] or [V, K]."""
        return x[self.eu], x[self.ev]

    def gather_endpoints(self, x):
        """Per-edge endpoint values; structured subclasses override this
        with gather-free implementations (shifts/rolls)."""
        return x[self.eu], x[self.ev]

    def edge_to_vertex_sum(self, vals_u, vals_v):
        """Accumulates per-edge endpoint contributions into vertices.

        Returns ``out[v] = sum_{e: eu[e]==v} vals_u[e] + sum_{e: ev[e]==v}
        vals_v[e]`` — the deterministic, gather-based equivalent of the
        reference's serial scatter (``PFDR_graph_quadratic_d1_l1.cpp:
        492-497``).  Supports an optional trailing label axis ([E] or [E, K]
        inputs).
        """
        pad_shape = (1,) + vals_u.shape[1:]
        vals = jnp.concatenate(
            [vals_u, vals_v, jnp.zeros(pad_shape, vals_u.dtype)], axis=0)
        gathered = jnp.take(vals, self.incidence, axis=0)  # [V, D, ...]
        out = jnp.sum(gathered, axis=1)
        if self.axis_name is not None:
            out = jax.lax.psum(out, self.axis_name)
        return out

    def edge_to_vertex_min(self, vals_u, vals_v, init):
        """Per-vertex minimum of incident edge-endpoint values.

        Returns ``out[v] = min(init, min_{e: eu[e]==v} vals_u[e],
        min_{e: ev[e]==v} vals_v[e])`` — the min-reduction twin of
        :meth:`edge_to_vertex_sum`, used by the device connected-components
        label propagation (:mod:`.ops.components`).  Entries the caller
        wants ignored (masked edges) must carry ``init``.
        """
        pad = jnp.full((1,) + vals_u.shape[1:], init, vals_u.dtype)
        vals = jnp.concatenate([vals_u, vals_v, pad], axis=0)
        out = jnp.min(jnp.take(vals, self.incidence, axis=0), axis=1)
        out = jnp.minimum(out, jnp.asarray(init, vals_u.dtype))
        if self.axis_name is not None:
            out = jax.lax.pmin(out, self.axis_name)
        return out

    def edge_allsum(self, vals):
        """Global sum of a per-edge quantity (psum across shards when this
        graph is one shard of an edge partition)."""
        out = jnp.sum(vals)
        if self.axis_name is not None:
            out = jax.lax.psum(out, self.axis_name)
        return out

    def vertex_allsum(self, vals):
        """Global sum of a per-vertex quantity; vertex-sharded subclasses
        psum across the mesh axis."""
        return jnp.sum(vals)

    def vertex_count_global(self):
        """Global vertex count (== ``num_vertices`` here; vertex-sharded
        subclasses multiply by the mesh axis size)."""
        return self.num_vertices

    def vertex_degree_weighted(self, edge_w):
        """``out[v] = sum of edge_w over edges incident to v`` (self-loops
        count twice, matching the reference's +=-both-endpoints loops)."""
        return self.edge_to_vertex_sum(edge_w, edge_w)

    # -- pytree protocol ----------------------------------------------------

    def tree_flatten(self):
        children = (self.eu, self.ev, self.la_d1, self.incidence)
        return children, (self.num_vertices, self.axis_name)

    @classmethod
    def tree_unflatten(cls, aux, children):
        eu, ev, la_d1, incidence = children
        num_vertices, axis_name = aux
        return cls(eu, ev, la_d1, num_vertices, incidence, axis_name)


@jax.tree_util.register_pytree_node_class
class ScatterGraphD1(GraphD1):
    """COO graph whose edge->vertex transfers are scatter reductions.

    Same math as :class:`GraphD1` (summation order aside); its cost is
    O(E) whatever the degree distribution, where the incidence table costs
    O(V * max_degree) — the container for contracted graphs with hub
    components."""

    def edge_to_vertex_sum(self, vals_u, vals_v):
        out = jnp.zeros((self.num_vertices,) + vals_u.shape[1:],
                        vals_u.dtype)
        out = out.at[self.eu].add(vals_u).at[self.ev].add(vals_v)
        if self.axis_name is not None:
            out = jax.lax.psum(out, self.axis_name)
        return out

    def edge_to_vertex_min(self, vals_u, vals_v, init):
        out = jnp.full((self.num_vertices,) + vals_u.shape[1:], init,
                       vals_u.dtype)
        out = out.at[self.eu].min(vals_u).at[self.ev].min(vals_v)
        if self.axis_name is not None:
            out = jax.lax.pmin(out, self.axis_name)
        return out

    def tree_flatten(self):
        return (self.eu, self.ev, self.la_d1), (self.num_vertices,
                                                self.axis_name)

    @classmethod
    def tree_unflatten(cls, aux, children):
        eu, ev, la_d1 = children
        num_vertices, axis_name = aux
        return cls(eu, ev, la_d1, num_vertices, axis_name=axis_name)
