"""Linear-operator ADT for the quadratic data term ``1/2 ||y - A x||^2``.

The reference encodes the operator mode in the *sign* of ``N``
(``/root/reference/include/PFDR_graph_quadratic_d1_l1.hpp:44-59``):

* ``N > 0`` — ``A`` is the dense N-by-V matrix, ``obs`` the N-vector ``y``;
  gradients go through the residual ``r = y - A x``.
* ``N < 0`` — ``A`` is the Gram matrix ``A^t A`` (V-by-V) and ``obs = A^t y``.
* ``N == 0`` — ``A`` is ``diag(A^t A)`` (length V), or the identity when
  absent; ``obs = A^t y``.  This is the "l22" weighted-distance case.

Here each mode is an explicit operator class with one shared interface; all
heavy products are matmuls under jit.  ``obs`` keeps the reference's
mode-dependent meaning (``y`` for :class:`DenseOp`, ``A^t y`` otherwise).
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

# Solver math is convergent optimization, not NN training: f32 inputs must
# get IEEE-f32 products.  DEFAULT matmul precision lets the accelerator
# round f32 operands (TF32 on GPU tensor cores, ~10 mantissa bits), which
# caps solve accuracy at ~1e-3 relative — enough to break cut-pursuit
# partition quality (the merge/cut decisions feed on ~1e-4-relative value
# differences).  All operator products therefore run at HIGHEST
# precision.
_mm = partial(jnp.matmul, precision=jax.lax.Precision.HIGHEST)
_vdot = partial(jnp.vdot, precision=jax.lax.Precision.HIGHEST)


def _register(cls):
    jax.tree_util.register_pytree_node_class(cls)
    return cls


class QuadOp:
    """Interface of the quadratic-term operator.

    ``obs`` below always denotes the observation in this operator's
    convention: the raw ``y`` for :class:`DenseOp`, the premultiplied
    ``A^t y`` for the Gram/diagonal/identity modes.
    """

    #: True when gradients are computed through the N-dim residual.
    uses_residual: bool = False

    def gram_apply(self, x):
        """``(A^t A) x``."""
        raise NotImplementedError

    def gram_diag(self, num_vertices: int, dtype):
        """``diag(A^t A)`` as a [V] vector."""
        raise NotImplementedError

    def grad(self, x, obs):
        """Gradient ``A^t(A x) - A^t y`` of the quadratic term."""
        raise NotImplementedError

    def quad_obj(self, x, obs):
        """``1/2 ||y - A x||^2`` — up to the constant ``1/2||y||^2`` for the
        premultiplied modes, matching the reference
        (``PFDR_graph_quadratic_d1_l1.cpp:388-399``)."""
        raise NotImplementedError

    def ones_image(self, num_vertices: int, obs):
        """``(<A 1, y>, ||A 1||^2)`` for the all-ones direction — used by the
        cut-pursuit scalar initialization
        (``CP_PFDR_graph_quadratic_d1_l1.cpp:94-140``)."""
        raise NotImplementedError

    def reduce(self, assign_onehot):
        """Reduced operator for component matrix ``S`` ([V, rV] one-hot):
        columns of A summed within each component."""
        raise NotImplementedError


@_register
class DenseOp(QuadOp):
    """Dense N-by-V design matrix (reference ``N > 0`` mode)."""

    uses_residual = True

    def __init__(self, a):
        self.a = a  # [N, V]

    @property
    def n_obs(self):
        return self.a.shape[0]

    def apply(self, x):
        return _mm(self.a, x)

    def apply_t(self, r):
        return _mm(self.a.T, r)

    def residual(self, x, obs):
        return obs - _mm(self.a, x)

    def gram_apply(self, x):
        return _mm(self.a.T, _mm(self.a, x))

    def gram_diag(self, num_vertices, dtype):
        return jnp.sum(self.a * self.a, axis=0).astype(dtype)

    def grad(self, x, obs):
        return -self.apply_t(self.residual(x, obs))

    def quad_obj(self, x, obs):
        r = self.residual(x, obs)
        return 0.5 * _vdot(r, r)

    def ones_image(self, num_vertices, obs):
        a1 = jnp.sum(self.a, axis=1)
        return _vdot(a1, obs), _vdot(a1, a1)

    def reduce(self, assign_onehot):
        return DenseOp(_mm(self.a, assign_onehot))

    def tree_flatten(self):
        return (self.a,), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(children[0])


@_register
class GramOp(QuadOp):
    """Premultiplied V-by-V Gram matrix ``A^t A`` (reference ``N < 0``)."""

    def __init__(self, gram):
        self.gram = gram  # [V, V]

    def gram_apply(self, x):
        return _mm(self.gram, x)

    def gram_diag(self, num_vertices, dtype):
        return jnp.diagonal(self.gram).astype(dtype)

    def grad(self, x, obs):
        return _mm(self.gram, x) - obs

    def quad_obj(self, x, obs):
        return _vdot(x, 0.5 * _mm(self.gram, x) - obs)

    def ones_image(self, num_vertices, obs):
        return jnp.sum(obs), jnp.sum(self.gram)

    def reduce(self, assign_onehot):
        return GramOp(_mm(assign_onehot.T, _mm(self.gram, assign_onehot)))

    def tree_flatten(self):
        return (self.gram,), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(children[0])


@_register
class DiagOp(QuadOp):
    """Diagonal ``A^t A`` (reference ``N == 0`` with non-null ``A``)."""

    def __init__(self, diag):
        self.diag = diag  # [V]

    def gram_apply(self, x):
        if x.ndim > 1:
            return self.diag[:, None] * x
        return self.diag * x

    def gram_diag(self, num_vertices, dtype):
        return self.diag.astype(dtype)

    def grad(self, x, obs):
        return self.diag * x - obs

    def quad_obj(self, x, obs):
        return _vdot(x, 0.5 * self.diag * x - obs)

    def ones_image(self, num_vertices, obs):
        return jnp.sum(obs), jnp.sum(self.diag)

    def reduce(self, assign_onehot):
        return DiagOp(_mm(self.diag, assign_onehot))

    def tree_flatten(self):
        return (self.diag,), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(children[0])


@_register
class IdentityOp(QuadOp):
    """Identity ``A`` (reference ``N == 0`` with ``A == NULL``)."""

    def gram_apply(self, x):
        return x

    def gram_diag(self, num_vertices, dtype):
        return jnp.ones((num_vertices,), dtype)

    def grad(self, x, obs):
        return x - obs

    def quad_obj(self, x, obs):
        return _vdot(x, 0.5 * x - obs)

    def ones_image(self, num_vertices, obs):
        return jnp.sum(obs), jnp.asarray(float(num_vertices), obs.dtype)

    def reduce(self, assign_onehot):
        return DiagOp(jnp.sum(assign_onehot, axis=0))

    def tree_flatten(self):
        return (), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls()


def make_operator(a, num_vertices: int, dtype=None) -> QuadOp:
    """Infers the operator mode from the shape of ``a``.

    Mirrors the reference Python binding's inference
    (``/root/reference/python/CP_quadratic_l1_py.cpp:118-129,205-222``):
    ``None``/scalar 1 -> identity; 1-D of length V -> diagonal; (V, V) square
    -> Gram; otherwise dense (N, V).
    """
    if a is None:
        return IdentityOp()
    a = jnp.asarray(a, dtype=dtype)
    if a.ndim == 0:
        return IdentityOp() if a == 1 else DiagOp(jnp.full((num_vertices,), a))
    if a.ndim == 1:
        if a.shape[0] != num_vertices:
            raise ValueError(f"diagonal operator has length {a.shape[0]}, "
                             f"expected V={num_vertices}")
        return DiagOp(a)
    if a.ndim == 2:
        if a.shape[1] != num_vertices:
            raise ValueError(f"operator has {a.shape[1]} columns, "
                             f"expected V={num_vertices}")
        if a.shape[0] == num_vertices:
            # Ambiguous square case: the reference's AtA entry points declare
            # the premultiplied meaning explicitly; callers wanting a dense
            # square design matrix should construct DenseOp directly.
            return GramOp(a)
        return DenseOp(a)
    raise ValueError(f"operator must have ndim <= 2, got {a.ndim}")
