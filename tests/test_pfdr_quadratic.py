"""PFDR quadratic+d1 inner solver vs the compiled reference oracle.

Reference entry points exercised: ``PFDR_graph_quadratic_d1_l1``
(``/root/reference/src/PFDR_graph_quadratic_d1_l1.cpp:270``) and
``PFDR_graph_quadratic_d1_bounds`` (``.../PFDR_graph_quadratic_d1_bounds.cpp:245``)
across all three operator modes (sign-of-N convention).
"""
import jax.numpy as jnp
import numpy as np
import pytest

from cp_pfdr_graph_d1_tpu import (DenseOp, DiagOp, GramOp, GraphD1,
                                  IdentityOp, Lipsch, PFDROptions, VertexProx,
                                  pfdr_quadratic_d1)

from . import _oracle
from .conftest import make_grid_graph


def make_problem(v=49, n=20, seed=0):
    eu, ev, la = make_grid_graph(7, v // 7, seed=seed)
    r = np.random.default_rng(seed + 100)
    a = r.normal(size=(n, v)) / np.sqrt(n)
    x_true = np.zeros(v)
    x_true[r.integers(0, v, 5)] = r.normal(size=5) * 3
    y = a @ x_true + 0.05 * r.normal(size=n)
    return eu, ev, la * 0.1, a, y


def run_ours(op, obs, eu, ev, la, *, la_l1=None, vprox=VertexProx(),
             lipsch=None, ltype=Lipsch.SCAL, opt=PFDROptions(),
             v=None, monitor=False):
    g = GraphD1.create(eu, ev, la, num_vertices=v, dtype=jnp.float64)
    obs = jnp.asarray(obs, jnp.float64)
    res = pfdr_quadratic_d1(op, obs, g, la_l1=la_l1, vprox=vprox,
                            lipsch=lipsch, ltype=ltype, opt=opt,
                            monitor=monitor)
    return res


@pytest.mark.oracle
@pytest.mark.parametrize("positivity", [0, 1])
def test_dense_l1_matches_reference(positivity):
    eu, ev, la, a, y = make_problem()
    v = a.shape[1]
    la_l1 = np.full(v, 0.05)
    lip = np.linalg.svd(a, compute_uv=False)[0] ** 2
    opt = PFDROptions(rho=1.0, cond_min=1e-3, dif_rcd=0.0, dif_tol=1e-8,
                      it_max=3000)
    res = run_ours(DenseOp(jnp.asarray(a)), y, eu, ev, la,
                   la_l1=jnp.asarray(la_l1),
                   vprox=VertexProx(kind="l1", positivity=bool(positivity)),
                   lipsch=lip, opt=opt)
    x_ref, it_ref, _, _ = _oracle.pfdr_ql1(
        y, a, eu, ev, la, la_l1, positivity, L=lip, difTol=1e-8, itMax=3000)
    np.testing.assert_allclose(np.asarray(res.x), x_ref, atol=1e-6)


@pytest.mark.oracle
def test_dense_l1_iteration_trace_matches_reference():
    """Near-bitwise agreement of iterates and objective trace over a fixed
    number of iterations — the strongest check that each update matches the
    reference.  Uses positivity=1 so the reference's out-of-bounds l1
    objective bug (``PFDR_graph_quadratic_d1_l1.cpp:417``, SURVEY defect 1,
    which we do not reproduce) can never trigger."""
    eu, ev, la, a, y = make_problem(seed=3)
    v = a.shape[1]
    la_l1 = np.full(v, 0.03)
    opt = PFDROptions(rho=1.3, cond_min=1e-3, dif_rcd=0.0, dif_tol=0.0,
                      it_max=25)
    res = run_ours(DenseOp(jnp.asarray(a)), y, eu, ev, la,
                   la_l1=jnp.asarray(la_l1),
                   vprox=VertexProx(kind="l1", positivity=True),
                   opt=opt, monitor=True)
    x_ref, it_ref, obj_ref, _ = _oracle.pfdr_ql1(
        y, a, eu, ev, la, la_l1, 1, rho=1.3, difTol=0.0, itMax=25,
        monitor=True)
    assert int(res.it) == it_ref == 25
    np.testing.assert_allclose(np.asarray(res.obj), obj_ref, rtol=1e-10)
    np.testing.assert_allclose(np.asarray(res.x), x_ref, atol=1e-12)


@pytest.mark.oracle
def test_gram_mode_matches_reference():
    eu, ev, la, a, y = make_problem(seed=1)
    v = a.shape[1]
    gram = a.T @ a
    aty = a.T @ y
    la_l1 = np.full(v, 0.05)
    opt = PFDROptions(dif_tol=1e-8, it_max=3000)
    lip = np.linalg.eigvalsh(gram)[-1]
    res = run_ours(GramOp(jnp.asarray(gram)), aty, eu, ev, la,
                   la_l1=jnp.asarray(la_l1), vprox=VertexProx(kind="l1"),
                   lipsch=lip, opt=opt)
    x_ref, _, _, _ = _oracle.pfdr_ql1(
        aty, gram, eu, ev, la, la_l1, 0, N=-v, L=lip, difTol=1e-8,
        itMax=3000)
    np.testing.assert_allclose(np.asarray(res.x), x_ref, atol=1e-6)


@pytest.mark.oracle
def test_diag_and_identity_modes_match_reference():
    eu, ev, la, _, _ = make_problem(seed=2)
    v = 49
    r = np.random.default_rng(7)
    y = r.normal(size=v)
    d = r.uniform(0.5, 2.0, size=v)
    la_l1 = np.full(v, 0.1)
    opt = PFDROptions(dif_tol=1e-9, it_max=3000)
    # diagonal mode
    res = run_ours(DiagOp(jnp.asarray(d)), d * y, eu, ev, la,
                   la_l1=jnp.asarray(la_l1), vprox=VertexProx(kind="l1"),
                   opt=opt)
    x_ref, _, _, _ = _oracle.pfdr_ql1(
        d * y, d, eu, ev, la, la_l1, 0, N=0, difTol=1e-9, itMax=3000)
    np.testing.assert_allclose(np.asarray(res.x), x_ref, atol=1e-6)
    # identity mode (1-D fused LASSO-like denoising)
    res = run_ours(IdentityOp(), y, eu, ev, la,
                   la_l1=jnp.asarray(la_l1), vprox=VertexProx(kind="l1"),
                   opt=opt, v=v)
    x_ref, _, _, _ = _oracle.pfdr_ql1(
        y, None, eu, ev, la, la_l1, 0, N=0, difTol=1e-9, itMax=3000)
    np.testing.assert_allclose(np.asarray(res.x), x_ref, atol=1e-6)


@pytest.mark.oracle
def test_bounds_matches_reference():
    eu, ev, la, a, y = make_problem(seed=4)
    opt = PFDROptions(dif_tol=1e-9, it_max=3000)
    lip = np.linalg.svd(a, compute_uv=False)[0] ** 2
    res = run_ours(DenseOp(jnp.asarray(a)), y, eu, ev, la,
                   vprox=VertexProx(kind="bounds", lo=-0.5, hi=1.0),
                   lipsch=lip, opt=opt)
    x_ref, _ = _oracle.pfdr_qbounds(
        y, a, eu, ev, la, -0.5, 1.0, L=lip, difTol=1e-9, itMax=3000)
    np.testing.assert_allclose(np.asarray(res.x), x_ref, atol=1e-6)
    assert float(jnp.min(res.x)) >= -0.5 - 1e-12
    assert float(jnp.max(res.x)) <= 1.0 + 1e-12


@pytest.mark.oracle
def test_reconditioning_matches_reference():
    eu, ev, la, a, y = make_problem(seed=5)
    v = a.shape[1]
    la_l1 = np.full(v, 0.05)
    lip = np.linalg.svd(a, compute_uv=False)[0] ** 2
    opt = PFDROptions(rho=1.5, dif_rcd=1e-3, dif_tol=1e-10, it_max=2000)
    res = run_ours(DenseOp(jnp.asarray(a)), y, eu, ev, la,
                   la_l1=jnp.asarray(la_l1), vprox=VertexProx(kind="l1"),
                   lipsch=lip, opt=opt)
    x_ref, it_ref, _, _ = _oracle.pfdr_ql1(
        y, a, eu, ev, la, la_l1, 0, rho=1.5, L=lip, difRcd=1e-3,
        difTol=1e-10, itMax=2000)
    np.testing.assert_allclose(np.asarray(res.x), x_ref, atol=1e-6)
    assert int(res.it) == it_ref


@pytest.mark.oracle
def test_diag_lipschitz_matches_reference():
    eu, ev, la, a, y = make_problem(seed=6)
    v = a.shape[1]
    la_l1 = np.full(v, 0.02)
    ata = a.T @ a
    lipsch = np.sum(np.abs(ata), axis=1)  # Gershgorin diagonal majorant
    opt = PFDROptions(dif_tol=1e-8, it_max=2000)
    res = run_ours(DenseOp(jnp.asarray(a)), y, eu, ev, la,
                   la_l1=jnp.asarray(la_l1), vprox=VertexProx(kind="l1"),
                   lipsch=jnp.asarray(lipsch), ltype=Lipsch.DIAG, opt=opt)
    x_ref, _, _, _ = _oracle.pfdr_ql1(
        y, a, eu, ev, la, la_l1, 0, Ltype=1, L=lipsch, difTol=1e-8,
        itMax=2000)
    np.testing.assert_allclose(np.asarray(res.x), x_ref, atol=1e-6)


def test_objective_decreases():
    eu, ev, la, a, y = make_problem(seed=8)
    v = a.shape[1]
    lip = np.linalg.svd(a, compute_uv=False)[0] ** 2
    opt = PFDROptions(dif_tol=0.0, it_max=60)
    res = run_ours(DenseOp(jnp.asarray(a)), y, eu, ev, la,
                   la_l1=jnp.full((v,), 0.05), vprox=VertexProx(kind="l1"),
                   lipsch=lip, opt=opt, monitor=True)
    obj = np.asarray(res.obj)
    # PFDR is not strictly monotone, but must be decreasing overall
    assert obj[-1] < obj[0]
    assert obj[-1] == min(obj)


def test_padded_problem_matches_unpadded():
    """Zero-weight padding edges/vertices must not change the solution —
    this is what lets cut-pursuit bucket reduced-problem shapes."""
    eu, ev, la, a, y = make_problem(seed=9)
    v = a.shape[1]
    la_l1 = jnp.full((v,), 0.05)
    lip = np.linalg.svd(a, compute_uv=False)[0] ** 2
    opt = PFDROptions(dif_tol=1e-9, it_max=2000)
    base = run_ours(DenseOp(jnp.asarray(a)), y, eu, ev, la,
                    la_l1=la_l1, vprox=VertexProx(kind="l1"), lipsch=lip,
                    opt=opt)
    # pad: 8 extra vertices, 16 zero-weight edges pointing at vertex 0
    vp = v + 8
    eu_p = np.concatenate([eu, np.zeros(16, np.int32)])
    ev_p = np.concatenate([ev, np.zeros(16, np.int32)])
    la_p = np.concatenate([la, np.zeros(16)])
    a_p = np.concatenate([a, np.zeros((a.shape[0], 8))], axis=1)
    la_l1_p = jnp.concatenate([la_l1, jnp.zeros(8)])
    padded = run_ours(DenseOp(jnp.asarray(a_p)), y, eu_p, ev_p, la_p,
                      la_l1=la_l1_p, vprox=VertexProx(kind="l1"), lipsch=lip,
                      opt=opt, v=vp)
    np.testing.assert_allclose(np.asarray(padded.x)[:v],
                               np.asarray(base.x), atol=1e-9)
    np.testing.assert_allclose(np.asarray(padded.x)[v:], 0.0, atol=1e-12)


def test_verbose_progress_prints_from_jitted_loop(capsys):
    """opt.verbose=k prints an iteration/evolution line every k iterations
    from inside the jitted while_loop (reference printf contract,
    PFDR_graph_quadratic_d1_l1.cpp:43-55)."""
    import jax

    r = np.random.default_rng(41)
    eu, ev, la = make_grid_graph(6, 6, seed=42)
    v, n = 36, 10
    a = r.normal(size=(n, v)) / np.sqrt(n)
    y = a @ r.normal(size=v)
    g = GraphD1.create(eu, ev, 0.1 * la, dtype=jnp.float64)
    lip = float(np.linalg.eigvalsh(a @ a.T)[-1])
    res = pfdr_quadratic_d1(
        DenseOp(jnp.asarray(a)), jnp.asarray(y), g,
        la_l1=jnp.full((v,), 0.02), vprox=VertexProx(kind="l1"),
        lipsch=lip, opt=PFDROptions(dif_tol=0.0, it_max=25, verbose=10))
    jax.effects_barrier()
    out = capsys.readouterr().out
    assert "PFDR iteration 10 (max. 25)" in out
    assert "PFDR iteration 20 (max. 25)" in out
    assert "relative evolution" in out
    assert int(res.it) == 25


def test_monitored_run_warns_on_staged_switch():
    """Monitoring runs the same single PFDR loop as an unmonitored solve:
    there is no route switch to warn about, the iterate is unchanged, and
    the traces carry no garbage tails (monitoring contract, SURVEY §2.5)."""
    import warnings

    r = np.random.default_rng(0)
    v = 256
    eu = np.arange(v - 1, dtype=np.int32)
    ev = eu + 1
    la = np.full(v - 1, 0.2, np.float32)
    a = (r.standard_normal((16, v)) / 4).astype(np.float32)
    y = r.standard_normal(16).astype(np.float32)
    g = GraphD1.create(eu, ev, la, num_vertices=v, dtype=jnp.float32)
    lip = float(np.linalg.eigvalsh((a @ a.T).astype(np.float64))[-1])
    opt = PFDROptions(rho=1.5, dif_tol=1e-6, it_max=50)
    kw = dict(la_l1=jnp.full((v,), 0.01, jnp.float32),
              vprox=VertexProx(kind="l1", positivity=True), lipsch=lip,
              opt=opt)
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        res = pfdr_quadratic_d1(DenseOp(jnp.asarray(a)), jnp.asarray(y), g,
                                monitor=True, **kw)
    assert not any("staged" in str(w.message) for w in rec), \
        [str(w.message) for w in rec]
    plain = pfdr_quadratic_d1(DenseOp(jnp.asarray(a)), jnp.asarray(y), g,
                              **kw)
    assert int(plain.it) == int(res.it)
    np.testing.assert_array_equal(np.asarray(plain.x), np.asarray(res.x))
    # trace hygiene: tails beyond it are zero, not loop residue
    it = int(res.it)
    obj = np.asarray(res.obj)
    dif = np.asarray(res.dif)
    assert np.all(obj[it + 1:] == 0)
    assert np.all(dif[it:] == 0)
    assert np.all(obj[:it + 1] != 0)
