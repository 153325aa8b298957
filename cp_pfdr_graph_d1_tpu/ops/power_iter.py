"""Squared operator norm by batched power iteration.

Reference: ``/root/reference/src/operator_norm_matrix.cpp:85-212`` runs
``nbInit`` independent random power iterations (one per OpenMP thread) on
``A^t A`` and returns the largest limit.  Here all restarts run as
*columns of one matrix*, so every iteration is a single matmul; the
PRNG is a fixed, explicit JAX key so results are reproducible.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

# IEEE-f32 products: a reduced-precision (TF32) matmul perturbs the
# estimated norm (and hence the PFDR step sizes) at ~1e-3 relative
_mm = partial(jnp.matmul, precision=jax.lax.Precision.HIGHEST)

from ..config import (OPERATOR_NORM_IT_MAX, OPERATOR_NORM_NB_INIT,
                      OPERATOR_NORM_TOL)


@partial(jax.jit, static_argnames=("gram_apply", "dim", "dtype", "tol",
                                   "it_max", "nb_init"))
def operator_norm(gram_apply, dim: int, dtype=jnp.float32, *,
                  tol: float = OPERATOR_NORM_TOL,
                  it_max: int = OPERATOR_NORM_IT_MAX,
                  nb_init: int = OPERATOR_NORM_NB_INIT,
                  key=None):
    """Returns ``||A||^2`` (largest eigenvalue of ``A^t A``).

    Args:
      gram_apply: callable mapping [dim, B] -> [dim, B], applying ``A^t A``
        columnwise (hashable/static, e.g. a module-level function or a
        ``functools.partial`` of one).
      dim: dimension of the domain of ``A^t A``.
      tol: per-restart relative convergence tolerance ``(a - b)/b < tol``
        (``operator_norm_matrix.cpp:200``).
      key: optional PRNG key; defaults to a fixed seed for reproducibility.
    """
    if key is None:
        key = jax.random.PRNGKey(0)
    x = jax.random.uniform(key, (dim, nb_init), dtype, minval=-1.0, maxval=1.0)

    def norm(z):
        return jnp.sqrt(jnp.sum(z * z, axis=0))

    # one warm-up application, as in the reference (:192-194)
    b = norm(x)
    x = gram_apply(x / b)
    b = norm(x)

    def cond(state):
        x, b, it, done = state
        return jnp.logical_and(it < it_max, jnp.logical_not(done))

    def body(state):
        x, b, it, _ = state
        safe_b = jnp.where(b > 0, b, 1)
        x = gram_apply(x / safe_b)
        a = norm(x)
        done = jnp.all((a - b) < tol * safe_b)
        return x, jnp.where(b > 0, a, 0), it + 1, done

    _, b, _, _ = jax.lax.while_loop(
        cond, body, (x, b, jnp.asarray(0), jnp.asarray(False)))
    return jnp.max(b)


class MatApply:
    """Hashable symmetric-matrix application for :func:`operator_norm`."""

    def __init__(self, m):
        self.m = m

    def __call__(self, x):
        return _mm(self.m, x)


class GramApply:
    """Hashable ``A^t A`` application for :func:`operator_norm`."""

    def __init__(self, a):
        self.a = a

    def __call__(self, x):
        return _mm(self.a.T, _mm(self.a, x))


def presymmetrize_wins(m: int, n: int,
                       it_max: int = OPERATOR_NORM_IT_MAX) -> bool:
    """The reference's pre-symmetrization cost rule
    (``/root/reference/src/operator_norm_matrix.cpp:116``): True when
    ``2 M N it > M N P + P^2 it`` with ``P = min(M, N)`` — i.e. when
    precomputing the smaller Gram matrix (``A A^t`` or ``A^t A``) once and
    power-iterating on it beats applying ``A`` twice per iteration."""
    p = min(m, n)
    return 2 * m * n * it_max > m * n * p + p * p * it_max


def dense_operator_norm(a, *, tol: float = OPERATOR_NORM_TOL,
                        it_max: int = OPERATOR_NORM_IT_MAX,
                        nb_init: int = OPERATOR_NORM_NB_INIT, key=None):
    """``||A||^2`` for a dense [M, N] matrix, routing through the smaller
    precomputed Gram matrix whenever :func:`presymmetrize_wins` says so —
    the rule of ``/root/reference/src/operator_norm_matrix.cpp:116-168``.
    Called from every reduced-metric path of the cut-pursuit solvers (the
    reduced design matrix has N_obs rows and rV columns, so for N_obs <<
    rV the [N_obs, N_obs] Gram iteration wins decisively)."""
    m, n = a.shape
    if presymmetrize_wins(m, n, it_max):
        p = min(m, n)
        gram = _mm(a, a.T) if m <= n else _mm(a.T, a)
        return operator_norm(MatApply(gram), p, a.dtype, tol=tol,
                             it_max=it_max, nb_init=nb_init, key=key)
    return operator_norm(GramApply(a), n, a.dtype, tol=tol, it_max=it_max,
                         nb_init=nb_init, key=key)
