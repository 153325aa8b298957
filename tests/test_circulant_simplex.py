"""Multi-label PFDR on the circulant container vs the plain COO container.

The circulant container reorders the edges into shift families plus a COO
remainder; the multi-label solve must match the plain container to float64
rounding — same math, different edge order.  Reference iteration:
``/root/reference/src/PFDR_graph_loss_d1_simplex.cpp:567-691``.
"""
import jax.numpy as jnp
import numpy as np
import pytest

from cp_pfdr_graph_d1_tpu import GraphD1, PFDROptions, pfdr_loss_d1_simplex
from cp_pfdr_graph_d1_tpu.circulant import CirculantGraphD1

from .conftest import make_grid_graph


def mesh_problem(v=600, k=4, seed=0):
    """Grid plus random chords (families + a COO remainder), piecewise-
    constant label field with noise."""
    r = np.random.default_rng(seed)
    eu, ev, la = make_grid_graph(24, v // 24, seed=seed)
    extra = 40
    ceu = r.integers(0, v, extra).astype(np.int32)
    cev = ((ceu + r.integers(1, v // 2, extra)) % v).astype(np.int32)
    keep = ceu != cev
    eu = np.concatenate([eu, ceu[keep]])
    ev = np.concatenate([ev, cev[keep]])
    la = np.concatenate([la, 0.4 + r.random(keep.sum())])
    labels = r.integers(0, k, size=v)
    q = np.full((v, k), 0.1 / (k - 1))
    q[np.arange(v), labels] = 0.9
    q += 0.05 * r.random((v, k))
    q /= q.sum(axis=1, keepdims=True)
    return eu, ev, 0.15 * la, q


def run_pair(al, k=4, la_f=None, dif_tol=1e-7, it_max=300, rho=1.2,
             seed=0):
    eu, ev, la, q = mesh_problem(k=k, seed=seed)
    v = q.shape[0]
    opt = PFDROptions(rho=rho, dif_tol=dif_tol, it_max=it_max)
    kw = dict(al=al,
              la_f=None if la_f is None else jnp.asarray(la_f, jnp.float64))
    base = pfdr_loss_d1_simplex(
        GraphD1.create(eu, ev, la, num_vertices=v, dtype=jnp.float64),
        jnp.asarray(q, jnp.float64), opt=opt, **kw)
    circ = CirculantGraphD1.create(eu, ev, la, num_vertices=v,
                                   dtype=jnp.float64, max_families=8,
                                   min_count=4)
    assert circ.num_rem > 0
    circ_res = pfdr_loss_d1_simplex(circ, jnp.asarray(q, jnp.float64),
                                 opt=opt, **kw)
    return base, circ_res


@pytest.mark.parametrize("al", [0.0, 1.0, 0.2])
def test_circulant_simplex_matches_coo(al):
    base, circ_res = run_pair(al)
    assert int(circ_res.it) == int(base.it)
    np.testing.assert_allclose(np.asarray(circ_res.p), np.asarray(base.p),
                               atol=1e-9)
    p = np.asarray(circ_res.p)
    np.testing.assert_allclose(p.sum(axis=1), 1.0, atol=1e-9)
    assert p.min() >= -1e-12


def test_circulant_simplex_vertex_weights():
    r = np.random.default_rng(3)
    la_f = r.uniform(0.5, 3.0, size=600)
    base, circ_res = run_pair(1.0, la_f=la_f, seed=2)
    assert int(circ_res.it) == int(base.it)
    np.testing.assert_allclose(np.asarray(circ_res.p), np.asarray(base.p),
                               atol=1e-9)


def test_circulant_simplex_label_mode():
    """dif_tol >= 1 switches to changed-ML-label stopping; counts must
    agree between the two containers."""
    base, circ_res = run_pair(0.2, k=3, dif_tol=1.0, it_max=150, seed=4)
    assert int(circ_res.it) == int(base.it)
    np.testing.assert_allclose(np.asarray(circ_res.p), np.asarray(base.p),
                               atol=1e-9)


def test_circulant_simplex_no_remainder():
    """Pure-grid offsets decompose remainder-free and agree with COO."""
    eu, ev, la = make_grid_graph(16, 16, seed=6)
    v, k = 256, 4
    r = np.random.default_rng(7)
    q = r.random((v, k))
    q /= q.sum(axis=1, keepdims=True)
    circ = CirculantGraphD1.create(eu, ev, 0.1 * la, num_vertices=v,
                                   dtype=jnp.float64, max_families=4,
                                   min_count=2)
    assert circ.num_rem == 0
    base = pfdr_loss_d1_simplex(
        GraphD1.create(eu, ev, 0.1 * la, num_vertices=v,
                       dtype=jnp.float64),
        jnp.asarray(q, jnp.float64), al=0.5,
        opt=PFDROptions(dif_tol=1e-7, it_max=200))
    circ_res = pfdr_loss_d1_simplex(
        circ, jnp.asarray(q, jnp.float64), al=0.5,
        opt=PFDROptions(dif_tol=1e-7, it_max=200))
    assert int(circ_res.it) == int(base.it)
    np.testing.assert_allclose(np.asarray(circ_res.p), np.asarray(base.p),
                               atol=1e-9)


def test_circulant_simplex_resume():
    """Kill/resume on the circulant container is trajectory-exact."""
    eu, ev, la, q = mesh_problem(seed=8)
    v = q.shape[0]
    circ = CirculantGraphD1.create(eu, ev, la, num_vertices=v,
                                   dtype=jnp.float64, max_families=8,
                                   min_count=4)
    qd = jnp.asarray(q, jnp.float64)
    full = pfdr_loss_d1_simplex(
        circ, qd, al=1.0,
        opt=PFDROptions(dif_tol=0.0, it_max=120))
    res1, st = pfdr_loss_d1_simplex(
        circ, qd, al=1.0,
        opt=PFDROptions(dif_tol=0.0, it_max=60), return_state=True)
    assert int(res1.it) == 60
    res2 = pfdr_loss_d1_simplex(
        circ, qd, al=1.0,
        opt=PFDROptions(dif_tol=0.0, it_max=120), state0=st)
    assert int(res2.it) == 120
    np.testing.assert_allclose(np.asarray(res2.p), np.asarray(full.p),
                               atol=1e-12)
