"""Device-resident connected components (min-label propagation + jumping).

The reference finds the components of the inactive-edge subgraph with a
serial DFS (``/root/reference/src/CP_PFDR_graph_quadratic_d1_l1.cpp:
570-596``); the host path here uses scipy for the same result.  This is
the device alternative: bulk-synchronous *minimum-label propagation*
(each vertex adopts the smallest label among itself and its neighbors
across unmasked edges) accelerated by *pointer jumping*
(``l <- l[l]``), converging in O(log V) rounds — the classic
Shiloach-Vishkin structure expressed as gathers and incidence reductions,
the same primitives the PFDR iteration runs at full speed.

Labels converge to the smallest vertex index in each component, which is
exactly the reference's DFS numbering order after compaction
(components numbered by first-encountered vertex); use
:func:`compact_labels` for the 0..rV-1 renumbering.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..graph import GraphD1


@partial(jax.jit, static_argnames=("it_max",))
def connected_components_device(graph: GraphD1, edge_mask,
                                it_max: int | None = None):
    """Returns int32 [V] labels: the smallest vertex index reachable from
    each vertex across edges where ``edge_mask`` is True.

    Args:
      graph: the full graph (its incidence table drives the reduction).
      edge_mask: bool [E]; masked-out edges do not connect.
      it_max: optional round cap.  Defaults to V: the early-exit
        ``changed`` test makes typical runs stop after O(log V)-ish
        rounds, but the doubling from pointer jumping is NOT a star
        contraction per round — snake-shaped components at high cut
        densities were measured to need more than the former
        ``2 log2(V) + 8`` bound (560 instead of the true 558 components
        on a 96x96 grid at 45% active edges), and an under-converged
        labeling is silently wrong.  Propagation alone converges within
        the component diameter <= V, so V is a hard guarantee.
    """
    v = graph.num_vertices
    if it_max is None:
        it_max = v
    sentinel = jnp.asarray(v, jnp.int32)  # > every real label

    def propagate(l):
        # container-aware transfers: rolls on stencil graphs, incidence
        # gathers on COO graphs (no per-element gathers in the hot loop)
        lu, lv = graph.gather_endpoints(l)
        m = jnp.where(edge_mask, jnp.minimum(lu, lv), sentinel)
        neigh = graph.edge_to_vertex_min(m, m, v)
        l = jnp.minimum(l, neigh)
        # pointer jumping: follow labels-of-labels until stable this round
        l = jnp.minimum(l, l[l])
        l = jnp.minimum(l, l[l])
        return l

    def cond(state):
        l, changed, it = state
        return jnp.logical_and(changed, it < it_max)

    def body(state):
        l, _, it = state
        l_new = propagate(l)
        return l_new, jnp.any(l_new != l), it + 1

    l0 = jnp.arange(v, dtype=jnp.int32)
    l, _, _ = jax.lax.while_loop(cond, body, (l0, jnp.asarray(True), 0))
    return l


def compact_labels(roots) -> tuple[int, np.ndarray]:
    """Renumbers root labels to 0..rV-1 in order of first occurrence —
    the reference's DFS component numbering.  Host-side O(V)."""
    roots = np.asarray(roots)
    v = roots.shape[0]
    # a component's root is its smallest vertex, so ascending root order
    # IS first-encounter order over the 0..V-1 vertex scan
    mapping = np.full(v, -1, np.int32)
    firsts = roots == np.arange(v)
    num = int(firsts.sum())
    mapping[firsts] = np.arange(num, dtype=np.int32)
    return num, mapping[roots]
