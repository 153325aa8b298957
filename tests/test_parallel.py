"""Multi-device PFDR on the virtual 8-device CPU mesh: the sharded solve
must match the single-device solve (same iterations, same solution)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cp_pfdr_graph_d1_tpu import (CPOptions, DenseOp, GraphD1,
                                  PFDROptions, VertexProx)
from cp_pfdr_graph_d1_tpu.parallel import (make_mesh,
                                           pfdr_quadratic_d1_sharded,
                                           shard_quadratic_problem)
from cp_pfdr_graph_d1_tpu.solvers.pfdr_quadratic import pfdr_quadratic_d1
from cp_pfdr_graph_d1_tpu.stencil import StencilGraphD1

from .conftest import make_grid_graph


def make_problem(v=100, n=48, seed=0):
    eu, ev, la = make_grid_graph(10, v // 10, seed=seed)
    r = np.random.default_rng(seed + 500)
    a = r.normal(size=(n, v)) / np.sqrt(n)
    x_true = np.zeros(v)
    x_true[r.integers(0, v, 8)] = r.normal(size=8) * 2
    y = a @ x_true + 0.05 * r.normal(size=n)
    return eu, ev, 0.1 * la, a, y


@pytest.mark.parametrize("num_shards", [2, 8])
def test_sharded_matches_single_device(num_shards):
    assert jax.device_count() >= num_shards
    eu, ev, la, a, y = make_problem()
    v = a.shape[1]
    la_l1 = np.full(v, 0.03)
    lip = float(np.linalg.svd(a, compute_uv=False)[0] ** 2)
    opt = PFDROptions(rho=1.2, dif_tol=1e-7, it_max=600)
    vprox = VertexProx(kind="l1")

    base = pfdr_quadratic_d1(
        DenseOp(jnp.asarray(a, jnp.float64)), jnp.asarray(y, jnp.float64),
        GraphD1.create(eu, ev, la, dtype=jnp.float64),
        la_l1=jnp.asarray(la_l1), vprox=vprox, lipsch=lip, opt=opt)

    mesh = make_mesh(num_shards)
    prob = shard_quadratic_problem(a, y, eu, ev, la, num_shards,
                                   dtype=np.float64)
    res = pfdr_quadratic_d1_sharded(prob, mesh, la_l1=la_l1, vprox=vprox,
                                    lipsch=lip, opt=opt)
    assert int(res.it) == int(base.it)
    np.testing.assert_allclose(np.asarray(res.x), np.asarray(base.x),
                               atol=1e-9)


def test_sharded_padding_inert():
    """Shard counts that do not divide N or E exercise the zero padding."""
    eu, ev, la, a, y = make_problem(seed=1)
    v = a.shape[1]
    lip = float(np.linalg.svd(a, compute_uv=False)[0] ** 2)
    opt = PFDROptions(dif_tol=1e-7, it_max=400)
    base = pfdr_quadratic_d1(
        DenseOp(jnp.asarray(a, jnp.float64)), jnp.asarray(y, jnp.float64),
        GraphD1.create(eu, ev, la, dtype=jnp.float64),
        la_l1=jnp.full((v,), 0.03), vprox=VertexProx(kind="l1"),
        lipsch=lip, opt=opt)
    mesh = make_mesh(7)  # 48 % 7 != 0 and E % 7 != 0
    prob = shard_quadratic_problem(a, y, eu, ev, la, 7, dtype=np.float64)
    res = pfdr_quadratic_d1_sharded(prob, mesh, la_l1=np.full(v, 0.03),
                                    vprox=VertexProx(kind="l1"),
                                    lipsch=lip, opt=opt)
    np.testing.assert_allclose(np.asarray(res.x), np.asarray(base.x),
                               atol=1e-9)


def test_halo_stencil_matches_single_device():
    """Vertex-sharded (halo-exchange) stencil PFDR vs single-device."""
    from cp_pfdr_graph_d1_tpu.parallel.halo import (pfdr_quadratic_d1_halo,
                                                    shard_stencil_problem)
    from cp_pfdr_graph_d1_tpu.stencil import StencilGraphD1

    h, w, n = 16, 12, 32
    v = h * w
    r = np.random.default_rng(9)
    la_r = r.uniform(0.1, 0.4, (h, w))
    la_d = r.uniform(0.1, 0.4, (h, w))
    sg = StencilGraphD1.create((h, w), {(0, 1): la_r, (1, 0): la_d},
                               wrap=(False, True), dtype=jnp.float64)
    a = r.normal(size=(n, v)) / np.sqrt(n)
    x_true = np.zeros((h, w))
    x_true[4:10, 3:9] = 1.0
    y = a @ x_true.ravel() + 0.02 * r.normal(size=n)
    la_l1 = np.full(v, 0.02)
    lip = float(np.linalg.svd(a, compute_uv=False)[0] ** 2)
    opt = PFDROptions(rho=1.2, dif_tol=1e-8, it_max=800)
    vprox = VertexProx(kind="l1")

    base = pfdr_quadratic_d1(
        DenseOp(jnp.asarray(a, jnp.float64)), jnp.asarray(y, jnp.float64),
        sg, la_l1=jnp.asarray(la_l1), vprox=vprox, lipsch=lip, opt=opt)

    mesh = make_mesh(8)
    prob = shard_stencil_problem(a.astype(np.float64), y.astype(np.float64),
                                 sg, 8)
    res = pfdr_quadratic_d1_halo(prob, mesh, la_l1=la_l1, vprox=vprox,
                                 lipsch=lip, opt=opt)
    assert int(res.it) == int(base.it)
    np.testing.assert_allclose(np.asarray(res.x), np.asarray(base.x),
                               atol=1e-9)


def make_simplex_problem(h, w, k, seed=0):
    r = np.random.default_rng(seed)
    v = h * w
    labels = (np.arange(v) * k // v)
    q = np.full((v, k), 0.1 / k)
    q[np.arange(v), labels] += 0.9
    q += 0.05 * r.random((v, k))
    q /= q.sum(axis=1, keepdims=True)
    return q


@pytest.mark.parametrize("al", [0.0, 1.0, 0.5])
def test_sharded_simplex_matches_single_device(al):
    """Edge-sharded multi-label PFDR vs single-device, all three losses."""
    from cp_pfdr_graph_d1_tpu.parallel import (pfdr_loss_d1_simplex_sharded,
                                               shard_simplex_problem)
    from cp_pfdr_graph_d1_tpu.solvers.pfdr_simplex import pfdr_loss_d1_simplex

    h, w, k = 8, 9, 4
    eu, ev, la = make_grid_graph(h, w, seed=3)
    la = 0.3 * la
    q = make_simplex_problem(h, w, k, seed=3)
    la_f = np.full(h * w, 1.3)
    opt = PFDROptions(rho=1.2, dif_tol=1e-8, it_max=400)

    base = pfdr_loss_d1_simplex(
        GraphD1.create(eu, ev, la, dtype=jnp.float64),
        jnp.asarray(q, jnp.float64), al=al, la_f=la_f, opt=opt)

    mesh = make_mesh(5)  # E % 5 != 0 exercises the padding
    prob = shard_simplex_problem(q, eu, ev, la, 5, dtype=np.float64)
    res = pfdr_loss_d1_simplex_sharded(prob, mesh, al=al, la_f=la_f, opt=opt)
    assert int(res.it) == int(base.it)
    np.testing.assert_allclose(np.asarray(res.p), np.asarray(base.p),
                               atol=1e-9)


@pytest.mark.parametrize("al", [0.0, 0.5])
def test_halo_simplex_matches_single_device(al):
    """Vertex-sharded (halo) multi-label stencil PFDR vs single-device."""
    from cp_pfdr_graph_d1_tpu.parallel import (pfdr_loss_d1_simplex_halo,
                                               shard_stencil_simplex_problem)
    from cp_pfdr_graph_d1_tpu.solvers.pfdr_simplex import pfdr_loss_d1_simplex
    from cp_pfdr_graph_d1_tpu.stencil import StencilGraphD1

    h, w, k = 16, 6, 3
    sg = StencilGraphD1.create((h, w), {(0, 1): 0.25, (1, 0): 0.25},
                               dtype=jnp.float64)
    q = make_simplex_problem(h, w, k, seed=5)
    la_f = None if al == 0.0 else np.full(h * w, 0.8)
    opt = PFDROptions(rho=1.3, dif_tol=1e-8, it_max=300)

    base = pfdr_loss_d1_simplex(sg, jnp.asarray(q, jnp.float64), al=al,
                                la_f=la_f, opt=opt)

    mesh = make_mesh(8)
    prob = shard_stencil_simplex_problem(q.astype(np.float64), sg, 8,
                                         la_f=la_f)
    res = pfdr_loss_d1_simplex_halo(prob, mesh, al=al, opt=opt)
    assert int(res.it) == int(base.it)
    np.testing.assert_allclose(np.asarray(res.p), np.asarray(base.p),
                               atol=1e-9)


def test_halo_simplex_label_count_stopping():
    """The maximum-likelihood label-count stopping mode psums correctly
    across vertex shards."""
    from cp_pfdr_graph_d1_tpu.parallel import (pfdr_loss_d1_simplex_halo,
                                               shard_stencil_simplex_problem)
    from cp_pfdr_graph_d1_tpu.solvers.pfdr_simplex import pfdr_loss_d1_simplex
    from cp_pfdr_graph_d1_tpu.stencil import StencilGraphD1

    h, w, k = 8, 6, 3
    sg = StencilGraphD1.create((h, w), {(0, 1): 0.3, (1, 0): 0.3},
                               dtype=jnp.float64)
    q = make_simplex_problem(h, w, k, seed=7)
    opt = PFDROptions(rho=1.0, dif_tol=1.0, it_max=200)  # label mode

    base = pfdr_loss_d1_simplex(sg, jnp.asarray(q, jnp.float64), al=0.5,
                                opt=opt)
    mesh = make_mesh(4)
    prob = shard_stencil_simplex_problem(q.astype(np.float64), sg, 4)
    res = pfdr_loss_d1_simplex_halo(prob, mesh, al=0.5, opt=opt)
    assert int(res.it) == int(base.it)
    np.testing.assert_allclose(np.asarray(res.p), np.asarray(base.p),
                               atol=1e-9)


def test_halo_wrapped_axis0():
    """Global wrap on the sharded axis rides the ppermute ring."""
    from cp_pfdr_graph_d1_tpu.parallel.halo import (pfdr_quadratic_d1_halo,
                                                    shard_stencil_problem)
    from cp_pfdr_graph_d1_tpu.stencil import StencilGraphD1

    h, w, n = 8, 10, 24
    v = h * w
    r = np.random.default_rng(11)
    sg = StencilGraphD1.create((h, w), {(0, 1): 0.2, (1, 0): 0.2},
                               wrap=(True, True), dtype=jnp.float64)
    a = r.normal(size=(n, v)) / np.sqrt(n)
    y = a @ r.normal(size=v)
    lip = float(np.linalg.svd(a, compute_uv=False)[0] ** 2)
    opt = PFDROptions(dif_tol=1e-8, it_max=500)
    base = pfdr_quadratic_d1(
        DenseOp(jnp.asarray(a, jnp.float64)), jnp.asarray(y, jnp.float64),
        sg, lipsch=lip, opt=opt)
    mesh = make_mesh(4)
    prob = shard_stencil_problem(a.astype(np.float64), y.astype(np.float64),
                                 sg, 4)
    res = pfdr_quadratic_d1_halo(prob, mesh, lipsch=lip, opt=opt)
    np.testing.assert_allclose(np.asarray(res.x), np.asarray(base.x),
                               atol=1e-9)


# ---------------------------------------------------------------------------
# distributed cut-pursuit (GSPMD operator sharding, parallel/cp_dist.py)
# ---------------------------------------------------------------------------

def _cp_problem(h=8, w=8, n=91, seed=3):
    """Piecewise-constant fused-LASSO problem; n=91 exercises the
    observation-axis zero padding (91 % 8 != 0)."""
    v = h * w
    eu, ev, la = make_grid_graph(h, w, seed=seed)
    r = np.random.default_rng(seed + 700)
    a = r.normal(size=(n, v)) / np.sqrt(n)
    x_true = np.zeros((h, w))
    x_true[1:4, 1:4] = 1.5
    x_true[5:7, 4:7] = -2.0
    y = a @ x_true.ravel() + 0.02 * r.normal(size=n)
    return eu, ev, 0.3 * la, a, y


def test_cp_dist_dense_matches_single_device():
    import dataclasses

    from cp_pfdr_graph_d1_tpu import CPOptions
    from cp_pfdr_graph_d1_tpu.parallel import cp_quadratic_d1_dist
    from cp_pfdr_graph_d1_tpu.solvers.cut_pursuit import cp_quadratic_d1

    eu, ev, la, a, y = _cp_problem()
    v = a.shape[1]
    la_l1 = np.full(v, 0.02)
    graph = GraphD1.create(eu, ev, la, dtype=jnp.float64)
    opt = CPOptions(dif_tol=1e-5, it_max=10,
                    pfdr=PFDROptions(rho=1.5, dif_tol=1e-9, it_max=5000))

    base = cp_quadratic_d1(
        DenseOp(jnp.asarray(a)), jnp.asarray(y), graph, la_l1=la_l1,
        opt=dataclasses.replace(opt, host_small="off"), monitor=True)

    mesh = make_mesh(8)
    res = cp_quadratic_d1_dist(
        DenseOp(jnp.asarray(a)), jnp.asarray(y), graph, mesh,
        la_l1=la_l1, opt=opt, monitor=True)

    assert res.it == base.it
    np.testing.assert_array_equal(np.asarray(res.cv), np.asarray(base.cv))
    np.testing.assert_allclose(np.asarray(res.rx), np.asarray(base.rx),
                               rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(res.obj, base.obj, rtol=1e-9)


def test_cp_dist_dense_positivity_duplex():
    from cp_pfdr_graph_d1_tpu import CPOptions
    from cp_pfdr_graph_d1_tpu.parallel import cp_quadratic_d1_dist
    from cp_pfdr_graph_d1_tpu.solvers.cut_pursuit import cp_quadratic_d1

    eu, ev, la, a, y = _cp_problem(seed=5)
    v = a.shape[1]
    la_l1 = np.full(v, 0.05)
    graph = GraphD1.create(eu, ev, la, dtype=jnp.float64)
    opt = CPOptions(dif_tol=1e-5, it_max=8, host_small="off",
                    pfdr=PFDROptions(dif_tol=1e-9, it_max=5000))

    base = cp_quadratic_d1(
        DenseOp(jnp.asarray(a)), jnp.asarray(y), graph, la_l1=la_l1,
        positivity=True, duplex=True, opt=opt)
    res = cp_quadratic_d1_dist(
        DenseOp(jnp.asarray(a)), jnp.asarray(y), graph, make_mesh(8),
        la_l1=la_l1, positivity=True, duplex=True, opt=opt)

    np.testing.assert_allclose(np.asarray(res.rx)[np.asarray(res.cv)],
                               np.asarray(base.rx)[np.asarray(base.cv)],
                               rtol=1e-9, atol=1e-12)


def test_cp_dist_gram_matches_single_device():
    from cp_pfdr_graph_d1_tpu import CPOptions, GramOp
    from cp_pfdr_graph_d1_tpu.parallel import cp_quadratic_d1_dist
    from cp_pfdr_graph_d1_tpu.solvers.cut_pursuit import cp_quadratic_d1

    eu, ev, la, a, y = _cp_problem(n=128, seed=7)  # AtA path: N >= V
    gram = a.T @ a
    aty = a.T @ y
    v = a.shape[1]
    assert v % 8 == 0
    la_l1 = np.full(v, 0.02)
    graph = GraphD1.create(eu, ev, la, dtype=jnp.float64)
    opt = CPOptions(dif_tol=1e-5, it_max=8, host_small="off",
                    pfdr=PFDROptions(dif_tol=1e-9, it_max=5000))

    base = cp_quadratic_d1(GramOp(jnp.asarray(gram)), jnp.asarray(aty),
                           graph, la_l1=la_l1, opt=opt)
    res = cp_quadratic_d1_dist(GramOp(jnp.asarray(gram)), jnp.asarray(aty),
                               graph, make_mesh(8), la_l1=la_l1, opt=opt)

    np.testing.assert_array_equal(np.asarray(res.cv), np.asarray(base.cv))
    np.testing.assert_allclose(np.asarray(res.rx), np.asarray(base.rx),
                               rtol=1e-9, atol=1e-12)


def test_cp_dist_gram_indivisible_raises():
    from cp_pfdr_graph_d1_tpu import GramOp
    from cp_pfdr_graph_d1_tpu.parallel import shard_cp_quadratic_problem

    g = np.eye(10)
    with pytest.raises(ValueError, match="divisible"):
        shard_cp_quadratic_problem(GramOp(jnp.asarray(g)), np.ones(10),
                                   make_mesh(8))


def test_cp_dist_operator_is_sharded():
    """The placement helper must actually distribute the operator rows."""
    from cp_pfdr_graph_d1_tpu.parallel import shard_cp_quadratic_problem

    eu, ev, la, a, y = _cp_problem()
    mesh = make_mesh(8)
    op, obs = shard_cp_quadratic_problem(DenseOp(jnp.asarray(a)), y, mesh)
    assert op.a.shape[0] % 8 == 0
    assert len(op.a.sharding.device_set) == 8
    # each device holds one row block, not a replica
    shard_rows = {s.data.shape[0] for s in op.a.addressable_shards}
    assert shard_rows == {op.a.shape[0] // 8}


def test_cp_simplex_dist_matches_single_device():
    """Distributed multi-label cut-pursuit (vertex-sharded observation,
    GSPMD gradient + reduced-barycenter stages) reproduces the
    single-device outer loop exactly (same labels, same distributions)."""
    from cp_pfdr_graph_d1_tpu import CPOptions
    from cp_pfdr_graph_d1_tpu.parallel import cp_loss_d1_simplex_dist
    from cp_pfdr_graph_d1_tpu.solvers.cut_pursuit_simplex import \
        cp_loss_d1_simplex

    r = np.random.default_rng(77)
    h, w, k = 10, 10, 3
    v = h * w
    eu, ev, la = make_grid_graph(h, w, seed=78)
    labels_true = (np.arange(v) // (v // k)).clip(0, k - 1)
    q = np.full((v, k), 0.15)
    q[np.arange(v), labels_true] = 0.7
    q += 0.05 * r.random((v, k))
    q /= q.sum(axis=1, keepdims=True)
    g = GraphD1.create(eu, ev, 0.3 * la, dtype=jnp.float64)
    opt = CPOptions(dif_tol=1e-4, it_max=6, host_small="off",
                    pfdr=PFDROptions(rho=1.2, dif_tol=1e-7, it_max=2000))

    base = cp_loss_d1_simplex(g, jnp.asarray(q), al=0.5, opt=opt)
    mesh = make_mesh(8)
    res = cp_loss_d1_simplex_dist(g, q, mesh, al=0.5, opt=opt)

    np.testing.assert_array_equal(res.cv, base.cv)
    np.testing.assert_allclose(np.asarray(res.rp), np.asarray(base.rp),
                               atol=1e-10)


def test_cp_simplex_device_obs_matches_host_obs():
    """device_obs=True (jitted observation stages) equals the numpy
    stages bit-for-double on a single device."""
    from cp_pfdr_graph_d1_tpu import CPOptions
    from cp_pfdr_graph_d1_tpu.solvers.cut_pursuit_simplex import \
        cp_loss_d1_simplex

    r = np.random.default_rng(79)
    eu, ev, la = make_grid_graph(8, 8, seed=80)
    v, k = 64, 4
    # structured observation: the greedy cut trajectory is stable, so the
    # two summation orders must give the same partition (an unstructured
    # dirichlet q amplifies 1e-16 into different-but-valid partitions)
    labels_true = (np.arange(v) // (v // k)).clip(0, k - 1)
    q = np.full((v, k), 0.1)
    q[np.arange(v), labels_true] = 0.7
    q += 0.02 * r.random((v, k))
    q /= q.sum(axis=1, keepdims=True)
    g = GraphD1.create(eu, ev, 0.2 * la, dtype=jnp.float64)
    opt = CPOptions(dif_tol=1e-4, it_max=5, host_small="off",
                    pfdr=PFDROptions(dif_tol=1e-7, it_max=2000))
    a_ = cp_loss_d1_simplex(g, jnp.asarray(q), al=1.0, opt=opt)
    b_ = cp_loss_d1_simplex(g, jnp.asarray(q), al=1.0, opt=opt,
                            device_obs=True)
    np.testing.assert_array_equal(a_.cv, b_.cv)
    np.testing.assert_allclose(np.asarray(a_.rp), np.asarray(b_.rp),
                               atol=1e-10)


# ---------------------------------------------------------------------------
# sharded-graph device cut-pursuit (parallel/cp_sharded.py)
# ---------------------------------------------------------------------------

def _tv_grid_problem(side, seed=3):
    r = np.random.default_rng(seed)
    x_true = np.zeros((side, side), np.float32)
    x_true[side // 8:3 * side // 8, side // 6:side // 2] = 1.2
    x_true[5 * side // 8:7 * side // 8, side // 2:7 * side // 8] = 0.7
    y = (x_true + 0.1 * r.standard_normal((side, side))
         ).astype(np.float32).ravel()
    graph = StencilGraphD1.create((side, side), {(0, 1): 0.3, (1, 0): 0.3},
                                  dtype=jnp.float32)
    return y, graph


def test_cp_sharded_identity_matches_single_device():
    """Sharded-graph device cut-pursuit (PDHG cuts + pointer-jumping
    components under shard_map, host boundary merge) must reproduce the
    single-device device-CP partition bit-for-bit and the values to f32
    tolerance (SURVEY §5 scale capstone)."""
    from cp_pfdr_graph_d1_tpu import IdentityOp
    from cp_pfdr_graph_d1_tpu.parallel import cp_quadratic_d1_sharded
    from cp_pfdr_graph_d1_tpu.solvers.cut_pursuit import cp_quadratic_d1

    y, graph = _tv_grid_problem(48)
    pf = PFDROptions(rho=1.8, dif_tol=1e-6, it_max=1500)
    kw = dict(dif_tol=1e-4, it_max=4, pfdr=pf, cut_tol=1e-6,
              cut_it_max=60_000, inexact="off")
    mesh = make_mesh(8)
    res_s = cp_quadratic_d1_sharded(y, graph, mesh, opt=CPOptions(**kw))
    res_1 = cp_quadratic_d1(IdentityOp(), jnp.asarray(y), graph,
                            opt=CPOptions(**kw, cut="device"))
    np.testing.assert_array_equal(np.asarray(res_s.cv),
                                  np.asarray(res_1.cv))
    np.testing.assert_allclose(res_s.rx, np.asarray(res_1.rx), atol=2e-5)


def test_cp_sharded_dense_matches_single_device():
    """Dense-operator mode: the gradient runs column-sharded (psum); the
    partition must match the single-device device-CP solve."""
    from cp_pfdr_graph_d1_tpu import DenseOp
    from cp_pfdr_graph_d1_tpu.parallel import cp_quadratic_d1_sharded
    from cp_pfdr_graph_d1_tpu.solvers.cut_pursuit import cp_quadratic_d1

    side, n_obs = 48, 32
    v = side * side
    r = np.random.default_rng(9)
    a = (r.standard_normal((n_obs, v)) / np.sqrt(n_obs)).astype(np.float32)
    x_true = np.zeros((side, side), np.float32)
    x_true[8:20, 10:26] = 1.5
    y = (a @ x_true.ravel()
         + 0.02 * r.standard_normal(n_obs)).astype(np.float32)
    la_l1 = np.full(v, 0.01, np.float32)
    graph = StencilGraphD1.create((side, side), {(0, 1): 0.05, (1, 0): 0.05},
                                  dtype=jnp.float32)
    pf = PFDROptions(rho=1.5, dif_tol=1e-6, it_max=3000)
    kw = dict(dif_tol=1e-4, it_max=5, pfdr=pf, cut_tol=1e-6,
              cut_it_max=100_000, inexact="off")
    mesh = make_mesh(8)
    res_s = cp_quadratic_d1_sharded(y, graph, mesh, a=a, la_l1=la_l1,
                                    positivity=True, opt=CPOptions(**kw))
    res_1 = cp_quadratic_d1(DenseOp(jnp.asarray(a)), jnp.asarray(y), graph,
                            la_l1=la_l1, positivity=True,
                            opt=CPOptions(**kw, cut="device"))
    # the two paths solve the reduced problems in different precisions
    # (sharded: host-native f64; single-device: f32 kernels), so a few
    # knife-edge vertices can settle in different near-optimal
    # partitions — the contract is the OBJECTIVE (the reference's own
    # quality trace) plus pointwise closeness
    x_s = res_s.rx[res_s.cv]
    x_1 = np.asarray(res_1.rx)[np.asarray(res_1.cv)]
    np.testing.assert_allclose(x_s, x_1, atol=2e-3)
    eu_t = np.asarray(graph.eu)
    ev_t = np.asarray(graph.ev)
    la_t = np.asarray(graph.la_d1).astype(np.float64)

    def _obj(x):
        x = np.asarray(x, np.float64)
        rr = a.astype(np.float64) @ x - y.astype(np.float64)
        return (0.5 * rr @ rr + np.sum(la_t * np.abs(x[eu_t] - x[ev_t]))
                + np.sum(la_l1.astype(np.float64) * np.abs(x)))

    assert abs(_obj(x_s) - _obj(x_1)) <= 1e-4 * max(abs(_obj(x_1)), 1e-9)


# ---------------------------------------------------------------------------
# halo exchange through ppermute
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shift_weights", [
    {(0, 1): 0.15, (1, 0): 0.15},
    {(0, 1): 0.1, (1, 0): 0.12, (2, 0): 0.05, (1, -1): 0.07},
])
def test_halo_ppermute_matches_single_device(shift_weights):
    """The row-sharded halo PFDR (ppermute boundary exchange under
    shard_map, SURVEY §5) must reproduce the single-device iteration —
    incl. halo depth 2 and negative-dx families."""
    from cp_pfdr_graph_d1_tpu import DenseOp
    from cp_pfdr_graph_d1_tpu.parallel import (pfdr_quadratic_d1_halo,
                                               shard_stencil_problem)

    h, w, n = 48, 40, 24
    r = np.random.default_rng(1)
    a = (r.standard_normal((n, h * w)) / np.sqrt(n)).astype(np.float32)
    y = r.standard_normal(n).astype(np.float32)
    sg = StencilGraphD1.create((h, w), shift_weights)
    lip = float(np.linalg.svd(a, compute_uv=False)[0] ** 2)
    la_l1 = np.full(h * w, 0.02, np.float32)
    mesh = make_mesh(8)
    prob = shard_stencil_problem(a, y, sg, 8)
    vp = VertexProx(kind="l1", positivity=True)
    opt = PFDROptions(rho=1.4, dif_tol=0.0, it_max=120)

    res_halo = pfdr_quadratic_d1_halo(prob, mesh, la_l1=la_l1, vprox=vp,
                                      lipsch=lip, opt=opt)
    res_ref = pfdr_quadratic_d1(
        DenseOp(jnp.asarray(a)), jnp.asarray(y), sg,
        la_l1=jnp.asarray(la_l1), vprox=vp, lipsch=lip, opt=opt)
    np.testing.assert_allclose(np.asarray(res_halo.x),
                               np.asarray(res_ref.x), atol=3e-5)
    assert int(res_halo.it) == int(res_ref.it)


def test_cp_sharded_bounds_and_restart():
    """Bounds family through the sharded device CP, plus warm restart: a
    second solve seeded with the first's state must terminate immediately
    (no new cut) with the same partition."""
    from cp_pfdr_graph_d1_tpu import IdentityOp
    from cp_pfdr_graph_d1_tpu.parallel import cp_quadratic_d1_sharded
    from cp_pfdr_graph_d1_tpu.solvers.cut_pursuit import cp_quadratic_d1

    y, graph = _tv_grid_problem(64, seed=11)
    pf = PFDROptions(rho=1.8, dif_tol=1e-6, it_max=2000)
    kw = dict(dif_tol=1e-4, it_max=4, pfdr=pf, cut_tol=1e-6,
              cut_it_max=100_000, inexact="off")
    mesh = make_mesh(8)
    res_s = cp_quadratic_d1_sharded(y, graph, mesh, bounds=(0.0, 0.9),
                                    opt=CPOptions(**kw))
    res_1 = cp_quadratic_d1(IdentityOp(), jnp.asarray(y), graph,
                            bounds=(0.0, 0.9),
                            opt=CPOptions(**kw, cut="device"))
    # at-bound equality is knife-edge: the sharded path's f64 host-native
    # reduced solves and the single-device path's f32 device solves can
    # legitimately settle on different near-optimal partitions — the
    # contract is the objective (the reference's own quality trace)
    x_s = res_s.rx[res_s.cv]
    x_1 = np.asarray(res_1.rx)[np.asarray(res_1.cv)]

    def objective(x):
        x = np.asarray(x, np.float64)
        d = x - y.astype(np.float64)
        la = np.asarray(graph.la_d1, np.float64)
        xu = x[np.asarray(graph.eu)]
        xv = x[np.asarray(graph.ev)]
        return 0.5 * d @ d + np.sum(la * np.abs(xu - xv))

    f_s, f_1 = objective(x_s), objective(x_1)
    assert f_s <= f_1 * (1 + 1e-3), (f_s, f_1)
    assert x_s.min() >= -1e-6 and x_s.max() <= 0.9 + 1e-6

    res_r = cp_quadratic_d1_sharded(y, graph, mesh, bounds=(0.0, 0.9),
                                    opt=CPOptions(**kw), state=res_s.state)
    assert res_r.it <= 2
    np.testing.assert_array_equal(np.asarray(res_r.cv),
                                  np.asarray(res_s.cv))


def test_cp_sharded_simplex_matches_single_device():
    """Sharded-graph multi-label cut-pursuit (K-1 sharded PDHG expansion
    cuts + sharded components/contraction, replicated reduced solve) vs
    the single-device host solver: the contract is the OBJECTIVE (the
    reference's own quality trace) plus near-complete ML-label agreement
    — the two paths use different cut solvers (sharded PDHG vs exact
    push-relabel) and reduced-solve precisions, so knife-edge vertices
    can settle differently."""
    from cp_pfdr_graph_d1_tpu import GraphD1
    from cp_pfdr_graph_d1_tpu.parallel import cp_loss_d1_simplex_sharded
    from cp_pfdr_graph_d1_tpu.solvers.cut_pursuit_simplex import \
        cp_loss_d1_simplex
    from cp_pfdr_graph_d1_tpu.solvers.pfdr_simplex import (d1_objective,
                                                           loss_objective)

    side, k = 48, 4
    v = side * side
    al = 0.5
    r = np.random.default_rng(11)
    labf = np.zeros((side, side), np.int64)
    labf[6:18, 8:24] = 1
    labf[30:42, 24:42] = 2
    labf[20:28, 4:16] = 3
    q = np.full((v, k), 0.1 / (k - 1), np.float32)
    q[np.arange(v), labf.ravel()] = 0.9
    q += 0.08 * r.random((v, k)).astype(np.float32)
    q /= q.sum(axis=1, keepdims=True)
    graph = StencilGraphD1.create((side, side), {(0, 1): 0.5, (1, 0): 0.5},
                                  dtype=jnp.float32)
    pf = PFDROptions(rho=1.5, dif_tol=1e-6, it_max=2000)
    kw = dict(dif_tol=1.0, it_max=6, pfdr=pf, cut_tol=1e-6,
              cut_it_max=60_000, inexact="off")
    mesh = make_mesh(8)
    res_s = cp_loss_d1_simplex_sharded(q, graph, mesh, al=al,
                                       opt=CPOptions(**kw))

    # oracle: host exact-cut solver on the real-edge COO of the same graph
    eu_t = np.asarray(graph.eu)
    ev_t = np.asarray(graph.ev)
    la_t = np.asarray(graph.la_d1)
    real = la_t > 0
    g64 = GraphD1.create(eu_t[real], ev_t[real], la_t[real].astype(
        np.float64), num_vertices=v, dtype=jnp.float64)
    res_1 = cp_loss_d1_simplex(g64, jnp.asarray(q, jnp.float64), al=al,
                               opt=CPOptions(**kw))

    def objective(p):
        p = jnp.asarray(np.asarray(p, np.float64))
        return float(loss_objective(al, p, jnp.asarray(q, jnp.float64),
                                    None) + d1_objective(g64, p))

    p_s = res_s.rp[res_s.cv]
    p_1 = np.asarray(res_1.rp)[np.asarray(res_1.cv)]
    f_s, f_1 = objective(p_s), objective(p_1)
    assert f_s <= f_1 * (1 + 1e-3), (f_s, f_1)
    lab_s = np.argmax(p_s, axis=1)
    lab_1 = np.argmax(p_1, axis=1)
    assert (lab_s == lab_1).mean() >= 0.98

    # warm restart: a second solve seeded with the first's state must
    # terminate immediately (no new cut) with the same partition
    res_r = cp_loss_d1_simplex_sharded(q, graph, mesh, al=al,
                                       opt=CPOptions(**kw),
                                       state=res_s.state)
    assert res_r.it <= 2
    np.testing.assert_array_equal(np.asarray(res_r.cv),
                                  np.asarray(res_s.cv))
