"""Shared host-side machinery of the cut-pursuit outer solvers.

Cut-pursuit alternates graph cuts on the full graph with solves of a reduced
problem whose size shrinks/grows dynamically.  The XLA model wants static
shapes, so the host orchestrates: connected components and reduced-graph
contraction run vectorized in numpy/scipy (they are O(E) index manipulation,
not FLOP-bound), while every FLOP-heavy piece (gradients, reduced operators,
Lipschitz metrics, the PFDR solve) runs jitted on device with reduced shapes
padded to power-of-two buckets to bound recompilation.

Reference structures reproduced: DFS connected components over inactive
edges (``/root/reference/src/CP_PFDR_graph_quadratic_d1_l1.cpp:570-596``),
reduced connectivity with parallel-edge merging, self-loops for
same-component active edges, and eps self-loops for isolated components
(``:607-661``).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import scipy.sparse as sp
from scipy.sparse import csgraph


def bucket(n: int, minimum: int = 8) -> int:
    """Next power-of-two capacity >= n (bounds jit recompilation count)."""
    b = minimum
    while b < n:
        b *= 2
    return b


def connected_components(num_vertices: int, eu, ev, inactive_mask):
    """Labels vertices by connectivity over inactive edges.

    Matches the reference's DFS labeling order (components numbered by their
    smallest vertex, ``CP_PFDR_graph_quadratic_d1_l1.cpp:570-596``) because
    scipy also assigns labels in order of first encounter over 0..V-1.

    Returns (num_components, labels[V] int32).
    """
    iu = eu[inactive_mask]
    iv = ev[inactive_mask]
    m = sp.coo_matrix(
        (np.ones(len(iu), np.int8), (iu, iv)),
        shape=(num_vertices, num_vertices))
    n, labels = csgraph.connected_components(m, directed=False)
    return int(n), labels.astype(np.int32)


@dataclasses.dataclass
class ReducedGraph:
    """Contracted graph over components (host arrays)."""
    num_components: int
    eu: np.ndarray        # int32 [rE]
    ev: np.ndarray        # int32 [rE]
    la_d1: np.ndarray     # [rE]


def build_reduced_graph(labels: np.ndarray, num_components: int,
                        eu: np.ndarray, ev: np.ndarray, la_d1: np.ndarray,
                        active_mask: np.ndarray, eps: float) -> ReducedGraph:
    """Contracts active nonzero-weight edges onto components.

    Parallel edges merge with summed weights; active edges internal to one
    component become self-loops; components touched by no nonzero active
    edge get an ``eps`` self-loop so PFDR's preconditioner stays definite
    (``CP_PFDR_graph_quadratic_d1_l1.cpp:607-661``).
    """
    sel = active_mask & (la_d1 > 0)
    ru = labels[eu[sel]]
    rv = labels[ev[sel]]
    w = la_d1[sel]
    lo = np.minimum(ru, rv)
    hi = np.maximum(ru, rv)
    keys = lo.astype(np.int64) * num_components + hi
    uniq, inv = np.unique(keys, return_inverse=True)
    wsum = np.bincount(inv, weights=w, minlength=len(uniq))
    r_eu = (uniq // num_components).astype(np.int32)
    r_ev = (uniq % num_components).astype(np.int32)
    # isolated components: incident to no nonzero active edge
    touched = np.zeros(num_components, bool)
    touched[r_eu] = True
    touched[r_ev] = True
    iso = np.nonzero(~touched)[0].astype(np.int32)
    if len(iso):
        r_eu = np.concatenate([r_eu, iso])
        r_ev = np.concatenate([r_ev, iso])
        wsum = np.concatenate([wsum, np.full(len(iso), eps)])
    return ReducedGraph(num_components, r_eu, r_ev,
                        wsum.astype(la_d1.dtype))


def pad_reduced_graph(rg: ReducedGraph, rv_cap: int, re_cap: int):
    """Pads the reduced edge set to capacity with inert zero-weight
    self-loops — spread across vertices so the incidence table's max degree
    stays flat.  The PFDR solvers treat zero-weight edges as absent."""
    pad = re_cap - len(rg.eu)
    spread = (np.arange(pad, dtype=np.int32) % rv_cap).astype(np.int32)
    eu = np.concatenate([rg.eu, spread])
    ev = np.concatenate([rg.ev, spread])
    la = np.concatenate([rg.la_d1, np.zeros(pad, rg.la_d1.dtype)])
    return eu, ev, la


def make_reduced_container(reu, rev, rla, rv_cap: int, dtype):
    """Graph container for the reduced PFDR solve.

    The incidence-gather :class:`~..graph.GraphD1` scans [rV, max_deg]
    per edge->vertex transfer — degenerate when the contracted graph has
    hub components (one component adjacent to thousands): the table can
    exceed memory, and even a moderate max degree makes each PFDR
    iteration scan rV * max_deg entries.  When that scan would exceed a
    few times the edge count, the degree-agnostic scatter container wins.
    """
    from ..graph import GraphD1, ScatterGraphD1
    reu = np.asarray(reu)
    rev = np.asarray(rev)
    deg = np.bincount(np.concatenate([reu, rev]), minlength=rv_cap)
    scan = rv_cap * max(int(deg.max(initial=1)), 1)
    if scan <= max(4 * len(reu), 1 << 16):
        return GraphD1.create(reu, rev, rla, num_vertices=rv_cap,
                              dtype=dtype)
    return ScatterGraphD1.create(reu, rev, rla, num_vertices=rv_cap,
                                 dtype=dtype)


def machine_eps(dtype, dif_tol: float) -> float:
    """Reference epsilon rule (``CP_PFDR_graph_quadratic_d1_l1.cpp:235-252``):
    the machine epsilon, or dif_tol when it is a smaller positive value."""
    m = float(np.finfo(dtype).eps)
    return dif_tol if 0 < dif_tol < m else m


# ---------------------------------------------------------------------------
# host-side reduced pipeline (used below the native-solver crossover)
# ---------------------------------------------------------------------------

def host_operator_norm(gram_apply, dim: int, *, tol: float = 1e-3,
                       it_max: int = 100, nb_init: int = 10) -> float:
    """Numpy twin of ``ops.power_iter.operator_norm`` (same semantics:
    batched restarts, relative convergence test, fixed seed)."""
    rng = np.random.default_rng(0)
    x = rng.uniform(-1.0, 1.0, (dim, nb_init))
    b = np.sqrt(np.sum(x * x, axis=0))
    x = gram_apply(x / b)
    b = np.sqrt(np.sum(x * x, axis=0))
    for _ in range(it_max):
        safe_b = np.where(b > 0, b, 1.0)
        x = gram_apply(x / safe_b)
        a = np.sqrt(np.sum(x * x, axis=0))
        done = np.all((a - b) < tol * safe_b)
        b = np.where(b > 0, a, 0.0)
        if done:
            break
    return float(b.max())


def host_reduce_dense(a_t, y_np, cv, num_comp: int, pre_at: bool):
    """Numpy twin of the device ``_reduce_dense``: reduced operator,
    observation and DIAG Lipschitz metric (Jacobi-equilibrated power
    method), unpadded.  ``a_t`` is the CONTIGUOUS [V, N] transpose of the
    design matrix (scipy copies non-contiguous operands on every call)."""
    s = sp.csr_matrix(
        (np.ones(len(cv)), (np.arange(len(cv)), cv)),
        shape=(len(cv), num_comp))
    ra = np.asarray(s.T @ a_t).T  # [N, rV] component column sums
    if pre_at:
        raa = ra.T @ ra
        ry = ra.T @ y_np
        d = np.sqrt(np.diagonal(raa))
        d_safe = np.where(d > 0, d, 1.0)
        eq = raa / (d_safe[:, None] * d_safe[None, :])
        c = host_operator_norm(lambda x: eq @ x, num_comp)
        return -1, raa, ry, np.diagonal(raa) * c
    cn = np.sqrt(np.sum(ra * ra, axis=0))
    cn_safe = np.where(cn > 0, cn, 1.0)
    eq = ra / cn_safe
    # pre-symmetrization cost rule (operator_norm_matrix.cpp:116): iterate
    # the smaller precomputed Gram when it beats the two-sided apply
    from ..ops.power_iter import presymmetrize_wins
    m, n = eq.shape
    if presymmetrize_wins(m, n):
        if m <= n:
            gram = eq @ eq.T
            c = host_operator_norm(lambda x: gram @ x, m)
        else:
            gram = eq.T @ eq
            c = host_operator_norm(lambda x: gram @ x, n)
    else:
        c = host_operator_norm(lambda x: eq.T @ (eq @ x), num_comp)
    return ra.shape[0], ra, y_np, cn * cn * c


def host_reduce_gram(gram_np, y_np, cv, num_comp: int):
    s = sp.csr_matrix(
        (np.ones(len(cv)), (np.arange(len(cv)), cv)),
        shape=(len(cv), num_comp))
    raa = np.asarray(s.T @ (s.T @ gram_np.T).T)
    ry = np.asarray(s.T @ y_np)
    d = np.sqrt(np.maximum(np.diagonal(raa), 0.0))
    d_safe = np.where(d > 0, d, 1.0)
    eq = raa / (d_safe[:, None] * d_safe[None, :])
    c = host_operator_norm(lambda x: eq @ x, num_comp)
    return raa, ry, np.diagonal(raa) * c


def host_reduce_diag(diag_np, y_np, cv, num_comp: int):
    rdiag = np.bincount(cv, weights=diag_np, minlength=num_comp)
    ry = np.bincount(cv, weights=y_np, minlength=num_comp)
    return rdiag, ry, rdiag


def component_representatives(cv: np.ndarray):
    """First-occurrence vertex index of each component label (labels are
    assigned in first-encounter order, so unique() is aligned)."""
    _, first = np.unique(cv, return_index=True)
    return first


def np64(x):
    """Host float64 copy of ``x``, fetched in one bulk transfer before the
    dtype conversion."""
    import jax
    return np.asarray(jax.device_get(x), np.float64)
