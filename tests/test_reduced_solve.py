"""Cut-pursuit reduced solves on device vs the float64 native twin.

A reduced solve is the one-hot contraction of the operator onto the
current partition (``_reduce_dense``/``_reduce_gram``/``_reduce_diag``)
followed by the staged PFDR loop on the contracted graph.  The contraction
must equal its numpy twin, and the solve must equal the native C++ PFDR
(``native.pfdr_quadratic_d1_host``) fed the same reduced quantities: same
iterate to float64 rounding, same iteration count.
"""
import jax.numpy as jnp
import numpy as np
import pytest

from cp_pfdr_graph_d1_tpu import (DenseOp, DiagOp, GramOp, GraphD1,
                                  IdentityOp, PFDROptions, VertexProx,
                                  native, pfdr_quadratic_d1)
from cp_pfdr_graph_d1_tpu.config import Lipsch
from cp_pfdr_graph_d1_tpu.solvers.cut_pursuit import (_reduce_dense,
                                                      _reduce_diag,
                                                      _reduce_gram)
from cp_pfdr_graph_d1_tpu.solvers.cut_pursuit_common import (
    host_reduce_dense, host_reduce_diag, host_reduce_gram)

from ._twins import VPROX_IDS, VPROXES, vprox_kwargs
from .conftest import make_grid_graph


def ring_problem(v=128, n=24, seed=0):
    r = np.random.default_rng(seed)
    a = r.standard_normal((n, v)) / np.sqrt(n)
    x_true = (r.random(v) > 0.7).astype(np.float64)
    y = a @ x_true + 0.01 * r.standard_normal(n)
    return a, y


def grid_problem(v=300, n=24, seed=0):
    r = np.random.default_rng(seed)
    eu, ev, la = make_grid_graph(15, v // 15, seed=seed)
    a = r.standard_normal((n, v)) / np.sqrt(n)
    x_true = np.zeros(v)
    x_true[r.integers(0, v, 30)] = 1.0
    y = a @ x_true + 0.01 * r.standard_normal(n)
    return eu, ev, la, a, y


def l1_weights(vprox, v):
    return np.full(v, 0.02) if vprox.kind == "l1" else None


@pytest.mark.parametrize("vprox", VPROXES, ids=VPROX_IDS)
@pytest.mark.parametrize("mode", ["dense", "pre_at", "gram", "diag"])
def test_reduced_solve_matches_native(mode, vprox):
    a, y = ring_problem()
    v = a.shape[1]
    rv = v // 2
    cv = (np.arange(v) // 2).astype(np.int32)  # pairs of vertices
    reu = np.arange(rv, dtype=np.int32)
    rev = ((np.arange(rv) + 1) % rv).astype(np.int32)
    rla = np.full(rv, 0.3)
    if mode == "gram":
        op_arr, obs = a.T @ a, a.T @ y
        mat, ry, lip = _reduce_gram(jnp.asarray(op_arr), jnp.asarray(obs),
                                    jnp.asarray(cv), rv)
        h_mat, h_ry, h_lip = host_reduce_gram(op_arr, obs, cv, rv)
        r_op, n_mode = GramOp(mat), -1
    elif mode == "diag":
        op_arr, obs = np.sum(a * a, axis=0), a.T @ y
        mat, ry, lip = _reduce_diag(jnp.asarray(op_arr), jnp.asarray(obs),
                                    jnp.asarray(cv), rv)
        h_mat, h_ry, h_lip = host_reduce_diag(op_arr, obs, cv, rv)
        r_op, n_mode = DiagOp(mat), 0
    else:
        pre_at = mode == "pre_at"
        mat, ry, lip = _reduce_dense(jnp.asarray(a), jnp.asarray(y),
                                     jnp.asarray(cv), rv, pre_at)
        n_mode, h_mat, h_ry, h_lip = host_reduce_dense(
            np.ascontiguousarray(a.T), y, cv, rv, pre_at)
        r_op = GramOp(mat) if pre_at else DenseOp(mat)
        n_mode = -1 if pre_at else a.shape[0]
    # the contraction equals its numpy twin; the power-method metric
    # agrees to its own convergence tolerance
    np.testing.assert_allclose(np.asarray(mat), h_mat, rtol=1e-12,
                               atol=1e-12)
    np.testing.assert_allclose(np.asarray(ry), h_ry, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(np.asarray(lip), h_lip, rtol=2e-2)

    la_l1 = l1_weights(vprox, rv)
    res = pfdr_quadratic_d1(
        r_op, ry, GraphD1.create(reu, rev, rla, num_vertices=rv,
                                      dtype=jnp.float64),
        la_l1=None if la_l1 is None else jnp.asarray(la_l1), vprox=vprox,
        lipsch=lip, ltype=Lipsch.DIAG,
        opt=PFDROptions(rho=1.4, dif_tol=0.0, it_max=120))
    x_ref, it_ref = native.pfdr_quadratic_d1_host(
        n_mode, np.asarray(mat), np.asarray(ry), reu, rev, rla,
        lip_diag=np.asarray(lip), rho=1.4, dif_tol=0.0, it_max=120,
        **vprox_kwargs(vprox, la_l1))
    assert int(res.it) == it_ref == 120
    np.testing.assert_allclose(np.asarray(res.x), x_ref, rtol=0,
                               atol=1e-10)


def test_reduced_solve_early_stop_and_padding():
    """Early exit on the evolution test, with rv < rv_cap and padded
    zero-weight edges (the cut-pursuit calling convention): the padded
    components stay zero and the live ones equal the unpadded twin."""
    a, y = ring_problem(seed=5)
    v = a.shape[1]
    rv, rv_cap, e_cap = 100, 128, 128
    r = np.random.default_rng(7)
    cv = np.sort(np.concatenate([np.arange(rv),
                                 r.integers(0, rv, v - rv)])).astype(np.int32)
    reu = np.arange(rv, dtype=np.int32)
    rev = ((np.arange(rv) + 1) % rv).astype(np.int32)
    rla = np.full(rv, 0.3)
    pad = e_cap - rv
    reu_p = np.concatenate([reu, np.arange(pad, dtype=np.int32) + rv])
    rev_p = np.concatenate([rev, np.arange(pad, dtype=np.int32) + rv])
    rla_p = np.concatenate([rla, np.zeros(pad)])
    vprox = VertexProx(kind="l1", positivity=True)
    mat, ry, lip = _reduce_dense(jnp.asarray(a), jnp.asarray(y),
                                 jnp.asarray(cv), rv_cap, False)
    res = pfdr_quadratic_d1(
        DenseOp(mat), ry, GraphD1.create(reu_p, rev_p, rla_p,
                                         num_vertices=rv_cap,
                                         dtype=jnp.float64),
        la_l1=jnp.full((rv_cap,), 0.02), vprox=vprox, lipsch=lip,
        ltype=Lipsch.DIAG, opt=PFDROptions(rho=1.4, dif_tol=1e-4,
                                           it_max=2000))
    assert int(res.it) < 2000  # the evolution test fired
    x = np.asarray(res.x)
    assert np.all(x[rv:] == 0)  # padded components stay zero
    x_ref, it_ref = native.pfdr_quadratic_d1_host(
        a.shape[0], np.asarray(mat)[:, :rv], y, reu, rev, rla,
        la_l1=np.full(rv, 0.02), positivity=True,
        lip_diag=np.asarray(lip)[:rv], rho=1.4, dif_tol=1e-4, it_max=2000)
    assert int(res.it) == it_ref
    np.testing.assert_allclose(x[:rv], x_ref, rtol=0, atol=1e-10)


@pytest.mark.parametrize("vprox", VPROXES, ids=VPROX_IDS)
def test_staged_solve_matches_native(vprox):
    eu, ev, la, a, y = grid_problem()
    v = a.shape[1]
    lip = float(np.linalg.eigvalsh(a @ a.T)[-1])
    la_l1 = np.full(v, 0.05) if vprox.kind == "l1" else None
    res = pfdr_quadratic_d1(
        DenseOp(jnp.asarray(a)), jnp.asarray(y),
        GraphD1.create(eu, ev, la, num_vertices=v, dtype=jnp.float64),
        la_l1=None if la_l1 is None else jnp.asarray(la_l1), vprox=vprox,
        lipsch=lip, opt=PFDROptions(rho=1.4, dif_tol=0.0, it_max=60))
    x_ref, it_ref = native.pfdr_quadratic_d1_host(
        a.shape[0], a, y, eu, ev, la, lip_scal=lip, rho=1.4, dif_tol=0.0,
        it_max=60, **vprox_kwargs(vprox, la_l1))
    assert int(res.it) == it_ref == 60
    np.testing.assert_allclose(np.asarray(res.x), x_ref, rtol=0,
                               atol=1e-10)


def test_staged_solve_early_stop_matches_native():
    eu, ev, la, a, y = grid_problem(seed=3)
    v = a.shape[1]
    lip = float(np.linalg.eigvalsh(a @ a.T)[-1])
    la_l1 = np.full(v, 0.05)
    res = pfdr_quadratic_d1(
        DenseOp(jnp.asarray(a)), jnp.asarray(y),
        GraphD1.create(eu, ev, la, num_vertices=v, dtype=jnp.float64),
        la_l1=jnp.asarray(la_l1), vprox=VertexProx(kind="l1"), lipsch=lip,
        opt=PFDROptions(rho=1.4, dif_tol=1e-3, it_max=4000))
    x_ref, it_ref = native.pfdr_quadratic_d1_host(
        a.shape[0], a, y, eu, ev, la, la_l1=la_l1, lip_scal=lip, rho=1.4,
        dif_tol=1e-3, it_max=4000)
    assert int(res.it) < 4000  # the tolerance actually fires
    assert int(res.it) == it_ref
    np.testing.assert_allclose(np.asarray(res.x), x_ref, rtol=0,
                               atol=1e-10)


def test_staged_solve_gram_and_diag_modes():
    eu, ev, la, a, y = grid_problem(v=225, n=16, seed=5)
    v = a.shape[1]
    g = GraphD1.create(eu, ev, la, num_vertices=v, dtype=jnp.float64)
    la_l1 = np.full(v, 0.03)
    kw = dict(la_l1=jnp.asarray(la_l1), vprox=VertexProx(kind="l1"))
    opt = PFDROptions(rho=1.4, dif_tol=0.0, it_max=60)
    nkw = dict(la_l1=la_l1, rho=1.4, dif_tol=0.0, it_max=60)
    gram, aty = a.T @ a, a.T @ y
    lipg = float(np.linalg.eigvalsh(gram)[-1])
    r = np.random.default_rng(7)
    d = 0.5 + r.random(v)
    obs_d = d * r.standard_normal(v)
    obs_i = r.standard_normal(v)
    cases = [
        (GramOp(jnp.asarray(gram)), aty, lipg,
         (-1, gram, aty, dict(lip_scal=lipg))),
        (DiagOp(jnp.asarray(d)), obs_d, None, (0, d, obs_d, {})),
        (IdentityOp(), obs_i, None, (0, None, obs_i, {})),
    ]
    for op, obs, lip, (n_mode, n_a, n_y, lkw) in cases:
        res = pfdr_quadratic_d1(op, jnp.asarray(obs), g, lipsch=lip,
                                opt=opt, **kw)
        x_ref, it_ref = native.pfdr_quadratic_d1_host(
            n_mode, n_a, n_y, eu, ev, la, **lkw, **nkw)
        assert int(res.it) == it_ref
        np.testing.assert_allclose(np.asarray(res.x), x_ref, rtol=0,
                                   atol=1e-10)


def test_staged_solve_warm_start_and_state():
    eu, ev, la, a, y = grid_problem(seed=11)
    v = a.shape[1]
    lip = float(np.linalg.eigvalsh(a @ a.T)[-1])
    g = GraphD1.create(eu, ev, la, num_vertices=v, dtype=jnp.float64)
    x0 = np.random.default_rng(1).standard_normal(v)
    la_l1 = np.full(v, 0.05)
    kw = dict(la_l1=jnp.asarray(la_l1), vprox=VertexProx(kind="l1"),
              lipsch=lip)
    op = DenseOp(jnp.asarray(a))
    full = pfdr_quadratic_d1(op, jnp.asarray(y), g, x0=jnp.asarray(x0),
                             opt=PFDROptions(rho=1.4, dif_tol=0.0,
                                             it_max=60), **kw)
    x_ref, _ = native.pfdr_quadratic_d1_host(
        a.shape[0], a, y, eu, ev, la, la_l1=la_l1, lip_scal=lip, rho=1.4,
        dif_tol=0.0, it_max=60, x0=x0)
    np.testing.assert_allclose(np.asarray(full.x), x_ref, rtol=0,
                               atol=1e-10)
    # a solve stopped at 30 iterations resumes to the uninterrupted result
    _, st = pfdr_quadratic_d1(op, jnp.asarray(y), g, x0=jnp.asarray(x0),
                              opt=PFDROptions(rho=1.4, dif_tol=0.0,
                                              it_max=30),
                              return_state=True, **kw)
    rest = pfdr_quadratic_d1(op, jnp.asarray(y), g, state0=st,
                             opt=PFDROptions(rho=1.4, dif_tol=0.0,
                                             it_max=60), **kw)
    assert int(rest.it) == 60
    np.testing.assert_array_equal(np.asarray(rest.x), np.asarray(full.x))


def test_cut_pursuit_device_route_matches_host_route():
    """Reduced solves staged on device (host_small="off") and on the host
    native twin (host_small="on") land on the same partition/values."""
    from cp_pfdr_graph_d1_tpu import CPOptions
    from cp_pfdr_graph_d1_tpu.solvers.cut_pursuit import cp_quadratic_d1

    h = w = 8
    v = h * w
    idx = np.arange(v).reshape(h, w)
    eu = np.concatenate([idx[:, :-1].ravel(), idx[:-1, :].ravel()])
    ev = np.concatenate([idx[:, 1:].ravel(), idx[1:, :].ravel()])
    r = np.random.default_rng(3)
    la = (0.3 * (0.5 + r.random(eu.shape[0]))).astype(np.float32)
    n = 30
    a = (r.normal(size=(n, v)) / np.sqrt(n)).astype(np.float32)
    x_true = np.zeros((h, w), np.float32)
    x_true[1:4, 1:4] = 1.5
    x_true[5:7, 4:7] = -2.0
    y = (a @ x_true.ravel() + 0.02 * r.normal(size=n)).astype(np.float32)
    la_l1 = np.full(v, 0.02, np.float32)
    g = GraphD1.create(eu, ev, la, dtype=jnp.float32)

    def solve(host_small):
        opt = CPOptions(dif_tol=1e-5, it_max=12, host_small=host_small,
                        pfdr=PFDROptions(rho=1.5, dif_tol=1e-6,
                                         it_max=3000))
        return cp_quadratic_d1(DenseOp(jnp.asarray(a)), jnp.asarray(y), g,
                               la_l1=la_l1, opt=opt)

    res_dev = solve("off")
    res_host = solve("on")
    x_dev = np.asarray(res_dev.rx)[np.asarray(res_dev.cv)]
    x_host = np.asarray(res_host.rx)[np.asarray(res_host.cv)]
    np.testing.assert_allclose(x_dev, x_host, rtol=0, atol=5e-4)
