"""Stencil (structured-grid) graph container: gather-free edge access.

Many graphs this library targets are structured — image grids, theta-phi
sphere meshes (the EEG example), video volumes — with edge sets that are
unions of constant-offset *shift families* over a field.
:class:`StencilGraphD1` represents such graphs explicitly: every endpoint
gather becomes a ``jnp.roll`` and the edge->vertex accumulation becomes the
inverse roll plus adds — contiguous reads with no index arrays to load.

Layout: vertices are the row-major cells of a ``(H, W)`` field; family
``f`` with offset ``(dy, dx)`` contributes one edge per cell ``(i, j)``
towards ``(i+dy, j+dx)``, giving flat per-edge arrays of length
``F * H * W`` (family-major).  Edges whose head falls outside a non-wrap
axis carry weight zero, which the PFDR solvers already treat as absent.
The COO view (``eu``/``ev`` numpy arrays) is materialized lazily for the
host-side cut-pursuit stages, which are layout-agnostic.
"""
from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .graph import GraphD1


@jax.tree_util.register_pytree_node_class
class StencilGraphD1(GraphD1):
    """d1 graph whose edges are shift families over a 2-D field."""

    def __init__(self, la_d1, field_shape: Tuple[int, int],
                 shifts: Tuple[Tuple[int, int], ...],
                 wrap: Tuple[bool, bool] = (False, False)):
        h, w = field_shape
        self.field_shape = (int(h), int(w))
        self.shifts = tuple((int(dy), int(dx)) for dy, dx in shifts)
        self.wrap = (bool(wrap[0]), bool(wrap[1]))
        self.la_d1 = la_d1
        self.num_vertices = h * w
        self.num_edges = len(self.shifts) * h * w
        self.axis_name = None
        self._coo = None

    @classmethod
    def create(cls, field_shape, shift_weights, wrap=(False, False),
               dtype=jnp.float32):
        """Builds a stencil graph from ``{(dy, dx): weight}`` where weight
        is a scalar or an (H, W) array; out-of-range positions on non-wrap
        axes are zeroed automatically."""
        h, w = field_shape
        shifts = tuple(shift_weights.keys())
        las = []
        for (dy, dx) in shifts:
            la = np.broadcast_to(
                np.asarray(shift_weights[(dy, dx)], dtype), (h, w)).copy()
            if not wrap[0]:
                if dy > 0:
                    la[h - dy:, :] = 0
                elif dy < 0:
                    la[:-dy, :] = 0
            if not wrap[1]:
                if dx > 0:
                    la[:, w - dx:] = 0
                elif dx < 0:
                    la[:, :-dx] = 0
            las.append(la)
        flat = jnp.asarray(np.stack(las).reshape(-1))
        return cls(flat, (h, w), shifts, wrap)

    # -- COO view for host-side stages -------------------------------------

    def _coo_arrays(self):
        if self._coo is None:
            h, w = self.field_shape
            idx = np.arange(h * w, dtype=np.int32).reshape(h, w)
            eus, evs = [], []
            for (dy, dx) in self.shifts:
                eus.append(idx.ravel())
                evs.append(np.roll(idx, (-dy, -dx), axis=(0, 1)).ravel())
            self._coo = (np.concatenate(eus), np.concatenate(evs))
        return self._coo

    @property
    def eu(self):
        return self._coo_arrays()[0]

    @property
    def ev(self):
        return self._coo_arrays()[1]

    # -- gather-free edge access -------------------------------------------

    def _fields(self, x):
        h, w = self.field_shape
        return x.reshape((h, w) + x.shape[1:])

    def gather_endpoints(self, x):
        f = len(self.shifts)
        x3 = self._fields(x)
        xu = jnp.broadcast_to(x3[None], (f,) + x3.shape)
        xv = jnp.stack([jnp.roll(x3, (-dy, -dx), axis=(0, 1))
                        for (dy, dx) in self.shifts])
        flat = (self.num_edges,) + x.shape[1:]
        return xu.reshape(flat), xv.reshape(flat)

    def edge_to_vertex_sum(self, vals_u, vals_v):
        f = len(self.shifts)
        h, w = self.field_shape
        vu = vals_u.reshape((f, h, w) + vals_u.shape[1:])
        vv = vals_v.reshape((f, h, w) + vals_v.shape[1:])
        out = jnp.sum(vu, axis=0)
        for k, (dy, dx) in enumerate(self.shifts):
            out = out + jnp.roll(vv[k], (dy, dx), axis=(0, 1))
        return out.reshape((self.num_vertices,) + vals_u.shape[1:])

    def edge_to_vertex_min(self, vals_u, vals_v, init):
        """Roll-based min-reduction twin of :meth:`edge_to_vertex_sum`.
        Masked edges (including the zero-weight out-of-range slots on
        non-wrap axes) must carry ``init`` so their wrapped-around roll
        positions are inert."""
        f = len(self.shifts)
        h, w = self.field_shape
        vu = vals_u.reshape((f, h, w) + vals_u.shape[1:])
        vv = vals_v.reshape((f, h, w) + vals_v.shape[1:])
        out = jnp.minimum(jnp.min(vu, axis=0),
                          jnp.asarray(init, vals_u.dtype))
        for k, (dy, dx) in enumerate(self.shifts):
            out = jnp.minimum(out, jnp.roll(vv[k], (dy, dx), axis=(0, 1)))
        return out.reshape((self.num_vertices,) + vals_u.shape[1:])

    # -- pytree protocol ----------------------------------------------------

    def tree_flatten(self):
        return (self.la_d1,), (self.field_shape, self.shifts, self.wrap)

    @classmethod
    def tree_unflatten(cls, aux, children):
        field_shape, shifts, wrap = aux
        return cls(children[0], field_shape, shifts, wrap)
