"""Irregular (unstructured) graphs on the COO containers.

A grid plus random chords with shuffled labels: degrees vary, no stencil
structure.  The incidence-gather :class:`GraphD1` and the scatter-add
:class:`ScatterGraphD1` must move values exactly as numpy indexing and
``np.add.at`` do, and a full PFDR solve on them must equal the float64
native twin.
"""
import jax.numpy as jnp
import numpy as np
import pytest

from cp_pfdr_graph_d1_tpu import (DenseOp, GraphD1, PFDROptions,
                                  pfdr_quadratic_d1, native)
from cp_pfdr_graph_d1_tpu.circulant import rcm_order
from cp_pfdr_graph_d1_tpu.graph import ScatterGraphD1

from ._twins import VPROX_IDS, VPROXES, vprox_kwargs
from .conftest import make_grid_graph


def irregular_graph(v=500, seed=0):
    """Random planar-ish mesh: grid plus random chords, shuffled labels."""
    r = np.random.default_rng(seed)
    eu, ev, la = make_grid_graph(25, v // 25, seed=seed)
    extra = 60
    ceu = r.integers(0, v, extra).astype(np.int32)
    cev = ((ceu + r.integers(1, 40, extra)) % v).astype(np.int32)
    eu = np.concatenate([eu, ceu])
    ev = np.concatenate([ev, cev])
    la = np.concatenate([la, 0.5 + r.random(extra)])
    shuf = r.permutation(v).astype(np.int32)
    return shuf[eu], shuf[ev], la


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.float64])
def test_gather_matches_numpy(dtype):
    eu, ev, la = irregular_graph()
    v = 500
    r = np.random.default_rng(1)
    x = r.normal(size=(v, 3)).astype(dtype)
    for cls in (GraphD1, ScatterGraphD1):
        g = cls.create(eu, ev, la, num_vertices=v, dtype=dtype)
        for xx in (x[:, 0], x):
            gu, gv = g.gather_endpoints(jnp.asarray(xx))
            np.testing.assert_array_equal(np.asarray(gu), xx[eu])
            np.testing.assert_array_equal(np.asarray(gv), xx[ev])


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.float64])
def test_scatter_matches_add_at(dtype):
    eu, ev, la = irregular_graph(seed=2)
    v = 500
    r = np.random.default_rng(3)
    e = len(eu)
    vu = r.normal(size=e).astype(dtype)
    vv = r.normal(size=e).astype(dtype)
    ref = np.zeros(v, np.float64)
    np.add.at(ref, eu, vu.astype(np.float64))
    np.add.at(ref, ev, vv.astype(np.float64))
    tol = 1e-12 if dtype == jnp.float64 else 1e-5
    for cls in (GraphD1, ScatterGraphD1):
        g = cls.create(eu, ev, la, num_vertices=v, dtype=dtype)
        out = np.asarray(g.edge_to_vertex_sum(jnp.asarray(vu),
                                              jnp.asarray(vv)))
        np.testing.assert_allclose(out, ref, rtol=tol, atol=tol)


def test_pfdr_matches_native_twin():
    """Full PFDR solve on both containers == the f64 native twin."""
    eu, ev, la = irregular_graph(seed=4)
    v = 500
    la = 0.15 * la
    r = np.random.default_rng(5)
    a = r.normal(size=(40, v)) / np.sqrt(40)
    x_true = np.zeros(v)
    x_true[r.integers(0, v, 12)] = 2.0
    y = a @ x_true + 0.02 * r.normal(size=40)
    lip = float(np.linalg.svd(a, compute_uv=False)[0] ** 2)
    la_l1 = np.full(v, 0.03)
    x_ref, it_ref = native.pfdr_quadratic_d1_host(
        40, a, y, eu, ev, la, la_l1=la_l1, lip_scal=lip, rho=1.3,
        dif_tol=1e-8, it_max=500)
    for cls in (GraphD1, ScatterGraphD1):
        res = pfdr_quadratic_d1(
            DenseOp(jnp.asarray(a)), jnp.asarray(y),
            cls.create(eu, ev, la, num_vertices=v, dtype=jnp.float64),
            la_l1=jnp.asarray(la_l1), vprox=VPROXES[0], lipsch=lip,
            opt=PFDROptions(rho=1.3, dif_tol=1e-8, it_max=500))
        assert int(res.it) == it_ref
        np.testing.assert_allclose(np.asarray(res.x), x_ref, atol=1e-10)


def test_rcm_reduces_bandwidth():
    eu, ev, la = irregular_graph(seed=6)
    v = 500
    r = np.random.default_rng(7)
    shuf = r.permutation(v).astype(np.int32)
    eu_s, ev_s = shuf[eu], shuf[ev]
    order = rcm_order(eu_s, ev_s, v)
    inv = np.argsort(order)
    bw_before = np.abs(eu_s.astype(int) - ev_s).max()
    bw_after = np.abs(inv[eu_s].astype(int) - inv[ev_s]).max()
    assert bw_after < bw_before


@pytest.mark.parametrize("vprox", VPROXES, ids=VPROX_IDS)
def test_irregular_pfdr_vertex_prox_matches_native(vprox):
    """Every vertex-prox kind on the irregular graph == native twin."""
    eu, ev, la = irregular_graph(seed=8)
    v = 500
    la = 0.15 * la
    r = np.random.default_rng(9)
    a = r.normal(size=(32, v)) / np.sqrt(32)
    y = a @ r.normal(size=v)
    lip = float(np.linalg.svd(a, compute_uv=False)[0] ** 2)
    la_l1 = np.full(v, 0.03) if vprox.kind == "l1" else None
    res = pfdr_quadratic_d1(
        DenseOp(jnp.asarray(a)), jnp.asarray(y),
        GraphD1.create(eu, ev, la, num_vertices=v, dtype=jnp.float64),
        la_l1=None if la_l1 is None else jnp.asarray(la_l1), vprox=vprox,
        lipsch=lip, opt=PFDROptions(rho=1.4, dif_tol=1e-8, it_max=400))
    x_ref, it_ref = native.pfdr_quadratic_d1_host(
        32, a, y, eu, ev, la, lip_scal=lip, rho=1.4, dif_tol=1e-8,
        it_max=400, **vprox_kwargs(vprox, la_l1))
    assert int(res.it) == it_ref
    np.testing.assert_allclose(np.asarray(res.x), x_ref, atol=1e-10)
