"""Proximal operators (vertex-wise backward steps).

Reference behaviors reproduced:

* soft-thresholding with optional positivity
  (``/root/reference/src/PFDR_graph_quadratic_d1_l1.cpp:499-512``),
* box clamp with infinite-bound sentinels
  (``/root/reference/src/PFDR_graph_quadratic_d1_bounds.cpp:472-489``),
* batched simplex projection in a diagonal metric
  (``/root/reference/src/proj_simplex_metric.cpp:19-83``) — the reference uses
  iterative active-set thresholding; here we use the exact sort-based
  algorithm, which is branch-free and fully vectorized over vertices (K is
  small, so the per-vertex work is a few elementwise passes).
"""
from __future__ import annotations

import jax.numpy as jnp


def soft_threshold(x, thresh, positivity: bool = False):
    """``prox`` of ``thresh * |.|`` (+ indicator of R+ when ``positivity``).

    With positivity, negative inputs map to zero and the positive branch is
    unchanged — matching ``PFDR_graph_quadratic_d1_l1.cpp:503-507``.
    """
    pos = jnp.maximum(x - thresh, 0)
    if positivity:
        return pos
    neg = jnp.minimum(x + thresh, 0)
    return pos + neg


def box_clamp(x, lo, hi):
    """Projection onto ``[lo, hi]``; infinite bounds are no-ops."""
    return jnp.clip(x, lo, hi)


def proj_simplex_metric(x, metric, target=1.0):
    """Projects rows of ``x`` [..., K] onto ``{p >= 0, sum(p) = target}`` in
    the diagonal metric ``diag(1/metric)``.

    Solves ``min_p 1/2 sum_k (p_k - x_k)^2 / m_k  s.t.  p >= 0, sum p = a``.
    KKT gives ``p_k = max(0, x_k - la * m_k)`` with ``la`` the unique root of
    ``sum_k max(0, x_k - la*m_k) = a``.  Computed by the exact Michelot
    active-set iteration — start all-active, repeatedly recompute
    ``la = (sum_active x - a) / sum_active m`` and drop coordinates with
    ``x - la*m <= 0`` — which converges in at most K-1 removals, so K
    unrolled passes are exact.  This is the same scheme as the reference
    (``proj_simplex_metric.cpp:46-72``) and, unlike a sort-based
    formulation, uses only elementwise ops and K-axis reductions (sorts and
    ``take_along_axis`` add a per-row gather).
    """
    x = jnp.asarray(x)
    m = jnp.broadcast_to(jnp.asarray(metric, x.dtype), x.shape)
    k = x.shape[-1]
    active = jnp.ones(x.shape, bool)
    la = jnp.zeros(x.shape[:-1] + (1,), x.dtype)
    for _ in range(k):
        sx = jnp.sum(jnp.where(active, x, 0), axis=-1, keepdims=True)
        sm = jnp.sum(jnp.where(active, m, 0), axis=-1, keepdims=True)
        la = (sx - target) / jnp.where(sm > 0, sm, 1)
        active = active & (x - la * m > 0)
    return jnp.maximum(x - la * m, 0)


def d1_pair_prox(pu, pv, w_u, w_v, thresh):
    """Backward step of the pairwise d1 (TV) term on a coupled pair.

    Given forward values ``(pu, pv)`` and normalized weights
    ``w_u + w_v == 1``, returns the pair prox: the weighted average plus a
    soft-thresholded share of the difference
    (``PFDR_graph_quadratic_d1_l1.cpp:466-489``).
    """
    avg = w_u * pu + w_v * pv
    diff = pu - pv
    shrunk = jnp.sign(diff) * jnp.maximum(jnp.abs(diff) - thresh, 0)
    return avg + w_v * shrunk, avg - w_u * shrunk
