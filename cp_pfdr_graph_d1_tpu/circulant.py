"""Circulant-decomposition graph container: unstructured graphs as shifts.

After a locality-preserving vertex ordering (:func:`strip_order` on mesh
coordinates, or :func:`rcm_order`), most edges of a mesh fall on a few
dozen distinct index offsets ``d = ev - eu``.  This container buckets edges
per offset into dense *shift families* — family ``f`` owns one slot per
vertex ``u`` for the potential edge ``(u, u + d_f)`` — so an endpoint
gather of a family is a flat circular shift of the vertex field.  Offsets
too rare to justify a dense family go to a COO *remainder* (measured ~96%
family coverage at 64 families on a Delaunay mesh under
:func:`strip_order`).

This is the unstructured generalization of the stencil container
(:mod:`.stencil`): a stencil IS the special case where the offset set is
the grid's shift families.  The solvers run it through the plain
:class:`.graph.GraphD1` transfers (endpoint gathers, incidence-table
accumulation) over the family-major edge order.

Edge order contract: edge ``e = f * V + u`` is family ``f``'s slot ``u``
(empty slots are inert weight-0 edges ``(0, 0)``), followed by the
remainder edges.  Per-edge solver quantities (preconditioner arrays,
``zu``/``zv``) follow this order.

No reference counterpart: the reference reads scattered memory directly
(``/root/reference/src/PFDR_graph_quadratic_d1_l1.cpp:466-497``).
"""
from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from .graph import GraphD1


def rcm_order(eu, ev, num_vertices: int):
    """Bandwidth-reducing vertex permutation (reverse Cuthill-McKee).

    Returns ``order`` such that relabeling ``v -> inv[v]`` (with
    ``inv = argsort(order)``) makes ``|eu - ev|`` small, which concentrates
    the edge offsets.  Callers must permute every per-vertex quantity
    (operator columns, weights) consistently.
    """
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import reverse_cuthill_mckee
    e = np.ones(len(eu), np.int8)
    adj = coo_matrix((e, (eu, ev)), shape=(num_vertices, num_vertices))
    adj = (adj + adj.T).tocsr()
    return np.asarray(reverse_cuthill_mckee(adj, symmetric_mode=True))


def strip_order(coords, nstrips: Optional[int] = None):
    """Locality-preserving vertex order from mesh coordinates.

    Rotates to principal axes, cuts the first axis into *equal-population*
    strips (``~sqrt(V)/2`` of them), and orders vertices strip-major
    (within-strip by the second axis), so mesh neighbors land a
    near-constant index offset apart: within-strip neighbors at +-1,
    cross-strip neighbors at ~one strip population — which equal
    population makes exactly constant up to within-strip jitter (measured
    97% of Delaunay-mesh edges on the top-64 offsets, vs 79% for
    equal-width strips; a serpentine within-strip direction *spreads* the
    cross-strip offsets — keep all strips same-direction).  Returns
    ``order`` (position -> old vertex index); relabel with
    ``inv[order] = arange(V)`` and permute every per-vertex quantity, as
    with :func:`rcm_order`.
    """
    c = np.asarray(coords, np.float64)
    if c.ndim != 2 or c.shape[0] < 2:
        raise ValueError("coords must be [V, dim] with V >= 2")
    c = c - c.mean(axis=0)
    _, _, vt = np.linalg.svd(c, full_matrices=False)
    proj = c @ vt.T
    v = c.shape[0]
    if nstrips is None:
        nstrips = max(1, int(round(np.sqrt(v) / 2)))
    rank = np.argsort(np.argsort(proj[:, 0], kind="stable"), kind="stable")
    strip = np.minimum(rank // max(v // nstrips, 1), nstrips - 1)
    b = proj[:, 1] if proj.shape[1] > 1 else np.zeros(v)
    return np.lexsort((b, strip))


def _masked_incidence(eu, ev, real, num_vertices: int):
    """Incidence table over the real edges only (virtual padding slots are
    excluded; every per-edge quantity accumulated through it is zero there
    by construction).  Layout as :func:`.graph._build_incidence`."""
    e = len(eu)
    slots_vertex = np.concatenate([eu, ev]).astype(np.int64)
    realm = np.concatenate([real, real])
    idx = np.nonzero(realm)[0]
    sv = slots_vertex[idx]
    order = np.argsort(sv, kind="stable")
    degrees = np.bincount(sv, minlength=num_vertices)
    max_deg = max(int(degrees.max(initial=0)), 1)
    inc = np.full((num_vertices, max_deg), 2 * e, dtype=np.int32)
    offsets = np.zeros(num_vertices + 1, dtype=np.int64)
    np.cumsum(degrees, out=offsets[1:])
    within = np.arange(len(idx), dtype=np.int64) - offsets[sv[order]]
    inc[sv[order], within] = idx[order].astype(np.int32)
    return inc


@jax.tree_util.register_pytree_node_class
class CirculantGraphD1(GraphD1):
    """d1 graph decomposed into dense shift families + COO remainder."""

    def __init__(self, eu, ev, la_d1, num_vertices: int, incidence,
                 offsets, num_rem: int, axis_name=None):
        self.eu = eu
        self.ev = ev
        self.la_d1 = la_d1
        self.num_vertices = int(num_vertices)
        self.num_edges = int(eu.shape[0])
        self.incidence = incidence
        self.offsets = tuple(int(d) for d in offsets)
        self.num_rem = int(num_rem)
        self.axis_name = axis_name

    @classmethod
    def create(cls, eu, ev, la_d1, num_vertices: Optional[int] = None,
               dtype=jnp.float32, max_families: int = 64,
               min_count: Optional[int] = None) -> "CirculantGraphD1":
        """Builds the decomposition from host edge arrays.

        Args:
          max_families: cap on dense shift families (most-frequent offsets
            first).
          min_count: offsets with fewer edges than this stay in the COO
            remainder (default ``max(16, V // 512)`` — a dense family costs
            O(V) per iteration regardless of how many edges it holds).
        """
        eu = np.asarray(eu, np.int64)
        ev = np.asarray(ev, np.int64)
        la = np.asarray(la_d1)
        if la.ndim == 0:
            la = np.full(eu.shape, la)
        la = la.astype(np.dtype(dtype))
        if num_vertices is None:
            num_vertices = int(max(eu.max(initial=-1), ev.max(initial=-1))
                               + 1)
        v = int(num_vertices)
        if min_count is None:
            min_count = max(16, v // 512)
        # orient every edge toward the positive offset
        flip = ev < eu
        eu2 = np.where(flip, ev, eu)
        ev2 = np.where(flip, eu, ev)
        d = ev2 - eu2
        offs, counts = np.unique(d, return_counts=True)
        # at-least-one-family fallback: when even the most frequent offset
        # is rarer than min_count (unordered/shuffled labelings), the floor
        # is relaxed to keep the densest offset rather than erroring —
        # the coverage warning below is the user's signal to reorder
        keep = counts >= min(min_count, int(counts.max(initial=1)))
        offs, counts = offs[keep], counts[keep]
        top = np.argsort(counts, kind="stable")[::-1][:max_families]
        fam_offsets = offs[top]
        nf = len(fam_offsets)
        if nf == 0:
            raise ValueError("empty edge set")

        la_f = np.zeros((nf, v), la.dtype)
        assigned = np.zeros((nf, v), bool)
        rem_mask = np.ones(len(eu2), bool)
        for f, dd in enumerate(fam_offsets):
            sel = np.nonzero(d == dd)[0]
            uniq, first = np.unique(eu2[sel], return_index=True)
            la_f[f, uniq] = la[sel[first]]
            assigned[f, uniq] = True
            rem_mask[sel[first]] = False
        eu_r = eu2[rem_mask]
        ev_r = ev2[rem_mask]
        la_r = la[rem_mask]
        coverage = 1.0 - len(eu_r) / max(len(eu2), 1)
        if coverage < 0.5:
            import warnings
            warnings.warn(
                f"circulant decomposition covers only {coverage:.0%} of "
                f"edges with dense families ({len(eu_r)} of {len(eu2)} "
                "edges fall to the COO remainder); relabel vertices with "
                "a locality-preserving order (strip_order on coordinates, "
                "or rcm_order) before building the graph",
                stacklevel=2)

        u_grid = np.broadcast_to(np.arange(v, dtype=np.int64), (nf, v))
        eu_fam = np.where(assigned, u_grid, 0)
        ev_fam = np.where(assigned, u_grid + fam_offsets[:, None], 0)
        eu_full = np.concatenate([eu_fam.ravel(), eu_r]).astype(np.int32)
        ev_full = np.concatenate([ev_fam.ravel(), ev_r]).astype(np.int32)
        la_full = np.concatenate([la_f.ravel(), la_r])
        real = np.concatenate([assigned.ravel(), np.ones(len(eu_r), bool)])
        incidence = _masked_incidence(eu_full, ev_full, real, v)
        return cls(jnp.asarray(eu_full), jnp.asarray(ev_full),
                   jnp.asarray(la_full), v, jnp.asarray(incidence),
                   fam_offsets, len(eu_r))

    # -- pytree protocol -----------------------------------------------------

    def tree_flatten(self):
        children = (self.eu, self.ev, self.la_d1, self.incidence)
        aux = (self.num_vertices, self.offsets, self.num_rem,
               self.axis_name)
        return children, aux

    @classmethod
    def tree_unflatten(cls, aux, children):
        eu, ev, la_d1, incidence = children
        num_vertices, offsets, num_rem, axis_name = aux
        return cls(eu, ev, la_d1, num_vertices, incidence, offsets,
                   num_rem, axis_name)
