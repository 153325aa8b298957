"""Checkpoint round-trip and resume-with-updated-data."""
import jax
import jax.numpy as jnp
import numpy as np

from cp_pfdr_graph_d1_tpu import CPOptions, DenseOp, GraphD1, PFDROptions
from cp_pfdr_graph_d1_tpu.solvers.cut_pursuit import cp_quadratic_d1
from cp_pfdr_graph_d1_tpu.solvers.cut_pursuit_simplex import (
    CPSimplexState, cp_loss_d1_simplex)
from cp_pfdr_graph_d1_tpu.utils import load_state, save_state

from .conftest import make_grid_graph


def test_checkpoint_roundtrip_and_resume(tmp_path):
    eu, ev, la = make_grid_graph(6, 6, seed=0)
    v = 36
    r = np.random.default_rng(0)
    a = r.normal(size=(20, v)) / 4
    x_true = np.zeros((6, 6))
    x_true[1:4, 1:4] = 1.0
    y = a @ x_true.ravel() + 0.02 * r.normal(size=20)
    g = GraphD1.create(eu, ev, 0.2 * la, dtype=jnp.float64)
    opt = CPOptions(dif_tol=1e-5, it_max=6,
                    pfdr=PFDROptions(dif_tol=1e-8, it_max=5000))
    la_l1 = np.full(v, 0.02)

    res = cp_quadratic_d1(DenseOp(jnp.asarray(a)), jnp.asarray(y), g,
                          la_l1=la_l1, opt=opt)
    path = tmp_path / "state.npz"
    save_state(path, res.state)
    state = load_state(path)
    np.testing.assert_array_equal(state.cv, res.state.cv)
    np.testing.assert_array_equal(state.active, res.state.active)

    # resume on slightly perturbed data: the warm path may settle on a
    # slightly different (equally valid) partition, so compare objective
    # quality and iteration count rather than exact values
    y2 = y + 0.01 * r.normal(size=20)
    warm = cp_quadratic_d1(DenseOp(jnp.asarray(a)), jnp.asarray(y2), g,
                           la_l1=la_l1, opt=opt, state=state, monitor=True)
    cold = cp_quadratic_d1(DenseOp(jnp.asarray(a)), jnp.asarray(y2), g,
                           la_l1=la_l1, opt=opt, monitor=True)
    assert warm.obj[-1] <= cold.obj[-1] * 1.01 + 1e-9
    assert warm.it <= cold.it


def test_checkpoint_simplex_roundtrip(tmp_path):
    eu, ev, la = make_grid_graph(6, 6, seed=1)
    r = np.random.default_rng(2)
    q = np.abs(r.normal(size=(36, 3))) + 0.1
    q /= q.sum(1, keepdims=True)
    g = GraphD1.create(eu, ev, 0.2 * la, dtype=jnp.float64)
    res = cp_loss_d1_simplex(g, jnp.asarray(q), al=1.0,
                             opt=CPOptions(dif_tol=1e-4, it_max=4))
    path = tmp_path / "sstate.npz"
    save_state(path, res.state)
    state = load_state(path)
    assert isinstance(state, CPSimplexState)
    np.testing.assert_array_equal(state.rp, res.state.rp)


def test_pfdr_state_kill_resume_reproduces_trajectory(tmp_path):
    """A PFDR solve stopped mid-way (return_state=True), persisted to npz,
    reloaded, and resumed (state0=) reproduces the uninterrupted
    trajectory exactly — including the stateful reconditioning decay
    (dif_rcd) the reference cannot checkpoint at all."""
    from cp_pfdr_graph_d1_tpu import VertexProx
    from cp_pfdr_graph_d1_tpu.solvers.pfdr_quadratic import (
        PFDRSolveState, pfdr_quadratic_d1)

    r = np.random.default_rng(31)
    h = w = 12
    v, n = h * w, 20
    eu, ev, la = make_grid_graph(h, w, seed=32)
    a = r.normal(size=(n, v)) / np.sqrt(n)
    y = a @ r.normal(size=v) * 0.5
    graph = GraphD1.create(eu, ev, 0.2 * la, dtype=jnp.float64)
    la_l1 = jnp.full((v,), 0.03)
    lip = float(np.linalg.eigvalsh(a @ a.T)[-1])
    kw = dict(la_l1=la_l1, vprox=VertexProx(kind="l1"), lipsch=lip)
    op = DenseOp(jnp.asarray(a))
    obs = jnp.asarray(y)

    def opts(it_max):
        return PFDROptions(rho=1.4, dif_rcd=1e-2, dif_tol=0.0,
                           it_max=it_max)

    full, full_state = pfdr_quadratic_d1(op, obs, graph, opt=opts(200),
                                         return_state=True, **kw)

    _, mid = pfdr_quadratic_d1(op, obs, graph, opt=opts(80),
                               return_state=True, **kw)
    path = tmp_path / "pfdr.npz"
    save_state(path, jax.device_get(mid))
    loaded = load_state(path)
    assert isinstance(loaded, PFDRSolveState)
    assert int(loaded.it) == 80
    res, res_state = pfdr_quadratic_d1(op, obs, graph, opt=opts(200),
                                       state0=loaded, return_state=True,
                                       **kw)

    assert int(res.it) == int(full.it) == 200
    np.testing.assert_array_equal(np.asarray(res.x), np.asarray(full.x))
    np.testing.assert_array_equal(np.asarray(res_state.zu),
                                  np.asarray(full_state.zu))
    np.testing.assert_array_equal(np.asarray(res_state.dif_rcd2),
                                  np.asarray(full_state.dif_rcd2))


def test_simplex_inner_state_kill_resume(tmp_path):
    """Simplex inner-solver state: a 40-iteration run split 15+25 through
    an .npz checkpoint reproduces the uninterrupted trajectory exactly
    (the simplex twin of the quadratic kill/resume test; the reference's
    CPls_Restart never persisted inner state,
    include/CP_PFDR_graph_loss_d1_simplex.hpp:26-48)."""
    from cp_pfdr_graph_d1_tpu.solvers.pfdr_simplex import \
        pfdr_loss_d1_simplex

    eu, ev, la = make_grid_graph(8, 8, seed=4)
    v, k = 64, 4
    r = np.random.default_rng(9)
    q = r.dirichlet(np.full(k, 0.6), size=v)
    g = GraphD1.create(eu, ev, 0.4 * la, dtype=jnp.float64)
    opt40 = PFDROptions(rho=1.3, dif_tol=0.0, it_max=40)
    full = pfdr_loss_d1_simplex(g, jnp.asarray(q), al=1.0, opt=opt40)

    opt15 = PFDROptions(rho=1.3, dif_tol=0.0, it_max=15)
    _, st = pfdr_loss_d1_simplex(g, jnp.asarray(q), al=1.0, opt=opt15,
                                 return_state=True)
    path = tmp_path / "simplex_inner.npz"
    save_state(path, jax.device_get(st))
    st2 = load_state(path)
    assert int(st2.it) == 15
    res2 = pfdr_loss_d1_simplex(
        g, jnp.asarray(q), al=1.0,
        opt=PFDROptions(rho=1.3, dif_tol=0.0, it_max=40),
        state0=jax.tree_util.tree_map(jnp.asarray, st2))
    assert int(res2.it) == 40
    np.testing.assert_allclose(np.asarray(res2.p), np.asarray(full.p),
                               rtol=0, atol=1e-14)


def test_whole_solve_kernel_resume_exact():
    """A checkpointed solve on a scatter-accumulating COO graph (the
    container of contracted graphs with hub components) resumes from its
    state and reproduces the uninterrupted trajectory bitwise."""
    import jax.numpy as jnp

    from cp_pfdr_graph_d1_tpu import (DenseOp, PFDROptions, VertexProx,
                                      pfdr_quadratic_d1)
    from cp_pfdr_graph_d1_tpu.graph import ScatterGraphD1

    r = np.random.default_rng(0)
    h = w = 24
    v = h * w
    n = 16
    idx = np.arange(v).reshape(h, w)
    eu = np.concatenate([idx[:, :-1].ravel(),
                         idx[:-1, :].ravel()]).astype(np.int32)
    ev = np.concatenate([idx[:, 1:].ravel(),
                         idx[1:, :].ravel()]).astype(np.int32)
    a = (r.standard_normal((n, v)) / np.sqrt(n)).astype(np.float32)
    y = r.standard_normal(n).astype(np.float32)
    sg = ScatterGraphD1.create(eu, ev, np.full(eu.shape, 0.05, np.float32),
                               num_vertices=v, dtype=jnp.float32)
    lip = float(np.linalg.svd(a, compute_uv=False)[0] ** 2)
    kw = dict(la_l1=jnp.full((v,), 0.02, jnp.float32),
              vprox=VertexProx(kind="l1", positivity=True), lipsch=lip)
    op = DenseOp(jnp.asarray(a))
    full = pfdr_quadratic_d1(
        op, jnp.asarray(y), sg, **kw,
        opt=PFDROptions(rho=1.5, dif_tol=0.0, it_max=200))
    _, st = pfdr_quadratic_d1(
        op, jnp.asarray(y), sg, **kw,
        opt=PFDROptions(rho=1.5, dif_tol=0.0, it_max=80),
        return_state=True)
    rest = pfdr_quadratic_d1(
        op, jnp.asarray(y), sg, **kw,
        opt=PFDROptions(rho=1.5, dif_tol=0.0, it_max=200), state0=st)
    assert int(rest.it) == int(full.it) == 200
    np.testing.assert_array_equal(np.asarray(rest.x), np.asarray(full.x))


def test_simplex_fused_resume_exact():
    """Same contract for the multi-label loop on a stencil graph."""
    import jax.numpy as jnp

    from cp_pfdr_graph_d1_tpu import PFDROptions
    from cp_pfdr_graph_d1_tpu.solvers.pfdr_simplex import \
        pfdr_loss_d1_simplex
    from cp_pfdr_graph_d1_tpu.stencil import StencilGraphD1

    r = np.random.default_rng(1)
    h = w = 24
    v = h * w
    sg = StencilGraphD1.create((h, w), {(0, 1): 0.3, (1, 0): 0.3},
                               dtype=jnp.float32)
    q = r.dirichlet(np.full(4, 0.7), size=v).astype(np.float32)
    full = pfdr_loss_d1_simplex(
        sg, jnp.asarray(q), al=1.0,
        opt=PFDROptions(rho=1.5, dif_tol=0.0, it_max=120))
    _, st = pfdr_loss_d1_simplex(
        sg, jnp.asarray(q), al=1.0,
        opt=PFDROptions(rho=1.5, dif_tol=0.0, it_max=50),
        return_state=True)
    rest = pfdr_loss_d1_simplex(
        sg, jnp.asarray(q), al=1.0,
        opt=PFDROptions(rho=1.5, dif_tol=0.0, it_max=120),
        state0=st)
    assert int(rest.it) == int(full.it) == 120
    np.testing.assert_array_equal(np.asarray(rest.p), np.asarray(full.p))
