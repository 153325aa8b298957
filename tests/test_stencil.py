"""Stencil graph container: must be math-identical to the COO container."""
import jax.numpy as jnp
import numpy as np
import pytest

from cp_pfdr_graph_d1_tpu import (DenseOp, GraphD1, PFDROptions, VertexProx,
                                  pfdr_loss_d1_simplex, pfdr_quadratic_d1)
from cp_pfdr_graph_d1_tpu.config import CPOptions
from cp_pfdr_graph_d1_tpu.solvers.cut_pursuit import cp_quadratic_d1
from cp_pfdr_graph_d1_tpu.stencil import StencilGraphD1


def make_pair(h=12, w=10, wrap=(False, True), seed=0):
    """Same grid graph as a stencil and as COO (nonzero edges only)."""
    r = np.random.default_rng(seed)
    la_right = r.uniform(0.2, 1.0, (h, w))
    la_down = r.uniform(0.2, 1.0, (h, w))
    sg = StencilGraphD1.create((h, w), {(0, 1): la_right, (1, 0): la_down},
                               wrap=wrap, dtype=jnp.float64)
    eu, ev = np.asarray(sg.eu), np.asarray(sg.ev)
    la = np.asarray(sg.la_d1)
    keep = la > 0
    cg = GraphD1.create(eu[keep], ev[keep], la[keep], num_vertices=h * w,
                        dtype=jnp.float64)
    return sg, cg, keep


def test_gather_and_reduce_match_coo():
    sg, cg, keep = make_pair()
    r = np.random.default_rng(1)
    x = jnp.asarray(r.normal(size=sg.num_vertices))
    su, sv = sg.gather_endpoints(x)
    su, sv = np.asarray(su)[keep], np.asarray(sv)[keep]
    cu, cvv = cg.gather_endpoints(x)
    np.testing.assert_allclose(su, np.asarray(cu))
    np.testing.assert_allclose(sv, np.asarray(cvv))

    vals = r.normal(size=sg.num_edges)
    vals[~keep] = 0.0  # zero-weight edges carry zero contributions
    out_s = sg.edge_to_vertex_sum(jnp.asarray(vals), jnp.asarray(2 * vals))
    out_c = cg.edge_to_vertex_sum(jnp.asarray(vals[keep]),
                                  jnp.asarray(2 * vals[keep]))
    np.testing.assert_allclose(np.asarray(out_s), np.asarray(out_c),
                               atol=1e-12)


def test_gather_2d_labels():
    sg, cg, keep = make_pair()
    r = np.random.default_rng(2)
    x = jnp.asarray(r.normal(size=(sg.num_vertices, 3)))
    su, sv = sg.gather_endpoints(x)
    cu, cvv = cg.gather_endpoints(x)
    np.testing.assert_allclose(np.asarray(su)[keep], np.asarray(cu))
    np.testing.assert_allclose(np.asarray(sv)[keep], np.asarray(cvv))


def test_pfdr_quadratic_identical_on_stencil():
    sg, cg, keep = make_pair(seed=3)
    v = sg.num_vertices
    r = np.random.default_rng(4)
    a = r.normal(size=(24, v)) / 5.0
    y = a @ r.normal(size=v)
    lip = float(np.linalg.svd(a, compute_uv=False)[0] ** 2)
    opt = PFDROptions(rho=1.3, dif_tol=1e-9, it_max=1500)
    args = dict(la_l1=jnp.full((v,), 0.05), vprox=VertexProx(kind="l1"),
                lipsch=lip, opt=opt)
    r_s = pfdr_quadratic_d1(DenseOp(jnp.asarray(a)), jnp.asarray(y), sg,
                            **args)
    r_c = pfdr_quadratic_d1(DenseOp(jnp.asarray(a)), jnp.asarray(y), cg,
                            **args)
    assert int(r_s.it) == int(r_c.it)
    np.testing.assert_allclose(np.asarray(r_s.x), np.asarray(r_c.x),
                               atol=1e-10)


def test_pfdr_simplex_identical_on_stencil():
    sg, cg, keep = make_pair(seed=5)
    v = sg.num_vertices
    r = np.random.default_rng(6)
    q = np.abs(r.normal(size=(v, 3))) + 0.05
    q /= q.sum(1, keepdims=True)
    opt = PFDROptions(dif_tol=1e-8, it_max=800)
    r_s = pfdr_loss_d1_simplex(sg, jnp.asarray(q), al=1.0, opt=opt)
    r_c = pfdr_loss_d1_simplex(cg, jnp.asarray(q), al=1.0, opt=opt)
    np.testing.assert_allclose(np.asarray(r_s.p), np.asarray(r_c.p),
                               atol=1e-10)


def test_cut_pursuit_on_stencil():
    sg, cg, keep = make_pair(seed=7, wrap=(False, False))
    v = sg.num_vertices
    r = np.random.default_rng(8)
    a = r.normal(size=(30, v)) / 5.0
    x_true = np.zeros((12, 10))
    x_true[3:8, 2:7] = 1.0
    y = a @ x_true.ravel() + 0.02 * r.normal(size=30)
    opt = CPOptions(dif_tol=1e-5, it_max=10,
                    pfdr=PFDROptions(rho=1.5, dif_tol=1e-8, it_max=5000))
    la_l1 = np.full(v, 0.03)
    r_s = cp_quadratic_d1(DenseOp(jnp.asarray(a)), jnp.asarray(y), sg,
                          la_l1=la_l1, opt=opt)
    r_c = cp_quadratic_d1(DenseOp(jnp.asarray(a)), jnp.asarray(y), cg,
                          la_l1=la_l1, opt=opt)
    np.testing.assert_allclose(r_s.rx[r_s.cv], r_c.rx[r_c.cv], atol=1e-6)


@pytest.mark.parametrize("vprox", [
    VertexProx(kind="l1"),
    VertexProx(kind="l1", positivity=True),
    VertexProx(kind="bounds", lo=-0.5, hi=0.8),
    VertexProx(),
])
def test_stencil_pfdr_matches_coo(vprox):
    """Every vertex-prox kind: the roll-based stencil solve equals the COO
    incidence-gather solve (same iteration count, same iterate)."""
    sg, cg, keep = make_pair(seed=11, wrap=(False, True))
    v = sg.num_vertices
    r = np.random.default_rng(12)
    a = r.normal(size=(24, v)) / 5.0
    y = a @ r.normal(size=v)
    lip = float(np.linalg.svd(a, compute_uv=False)[0] ** 2)
    la_l1 = jnp.full((v,), 0.04) if vprox.kind == "l1" else None
    opt = PFDROptions(rho=1.4, dif_tol=1e-9, it_max=700)
    op = DenseOp(jnp.asarray(a))
    obs = jnp.asarray(y)
    r_s = pfdr_quadratic_d1(op, obs, sg, la_l1=la_l1, vprox=vprox,
                            lipsch=lip, opt=opt)
    r_c = pfdr_quadratic_d1(op, obs, cg, la_l1=la_l1, vprox=vprox,
                            lipsch=lip, opt=opt)
    assert int(r_s.it) == int(r_c.it)
    np.testing.assert_allclose(np.asarray(r_s.x), np.asarray(r_c.x),
                               rtol=0, atol=1e-10)


def test_stencil_wrapped_axes_match_coo():
    """Wrapped (periodic) fields: the circular rolls equal the COO edges
    that close each row and column."""
    sg, cg, keep = make_pair(seed=13, wrap=(True, True))
    assert keep.all()
    v = sg.num_vertices
    r = np.random.default_rng(14)
    a = r.normal(size=(16, v)) / 4.0
    y = a @ r.normal(size=v)
    lip = float(np.linalg.svd(a, compute_uv=False)[0] ** 2)
    kw = dict(la_l1=jnp.full((v,), 0.03), vprox=VertexProx(kind="l1"),
              lipsch=lip, opt=PFDROptions(dif_tol=1e-9, it_max=500))
    r_s = pfdr_quadratic_d1(DenseOp(jnp.asarray(a)), jnp.asarray(y), sg,
                            **kw)
    r_c = pfdr_quadratic_d1(DenseOp(jnp.asarray(a)), jnp.asarray(y), cg,
                            **kw)
    assert int(r_s.it) == int(r_c.it)
    np.testing.assert_allclose(np.asarray(r_s.x), np.asarray(r_c.x),
                               rtol=0, atol=1e-10)


@pytest.mark.parametrize("al,label_mode,la_f", [
    (0.0, False, None),
    (1.0, False, 0.8),
    (0.5, False, None),
    (0.5, True, None),
])
def test_stencil_simplex_matches_coo(al, label_mode, la_f):
    """Every loss and both stopping modes of the multi-label solve agree
    between the stencil and COO containers."""
    sg, cg, keep = make_pair(seed=21, wrap=(False, True))
    v = sg.num_vertices
    k = 4
    r = np.random.default_rng(22)
    q = np.abs(r.normal(size=(v, k))) + 0.05
    q /= q.sum(1, keepdims=True)
    laf = jnp.asarray(np.full(v, la_f)) if la_f is not None else None
    dif_tol = 1.0 if label_mode else 1e-9
    opt = PFDROptions(rho=1.3, dif_tol=dif_tol, it_max=400)
    r_s = pfdr_loss_d1_simplex(sg, jnp.asarray(q), al=al, la_f=laf, opt=opt)
    r_c = pfdr_loss_d1_simplex(cg, jnp.asarray(q), al=al, la_f=laf, opt=opt)
    assert int(r_s.it) == int(r_c.it)
    np.testing.assert_allclose(np.asarray(r_s.p), np.asarray(r_c.p),
                               rtol=0, atol=1e-10)


def test_edge_to_vertex_min_matches_coo():
    sg, cg, keep = make_pair(seed=9)
    v = sg.num_vertices
    r = np.random.default_rng(10)
    init = float(v + 7)
    vals_u = np.where(keep, r.normal(size=sg.num_edges), init)
    vals_v = np.where(keep, r.normal(size=sg.num_edges), init)
    out_s = sg.edge_to_vertex_min(jnp.asarray(vals_u), jnp.asarray(vals_v),
                                  init)
    out_c = cg.edge_to_vertex_min(jnp.asarray(vals_u[keep]),
                                  jnp.asarray(vals_v[keep]), init)
    np.testing.assert_allclose(np.asarray(out_s), np.asarray(out_c))


def test_components_identical_on_stencil():
    """Device connected components must be container-independent (stencil
    rolls vs COO incidence gathers)."""
    from cp_pfdr_graph_d1_tpu.ops.components import (
        compact_labels, connected_components_device)
    sg, cg, keep = make_pair(seed=11, wrap=(False, False))
    r = np.random.default_rng(12)
    # random active mask in COO space, mapped into the stencil edge order
    mask_c = r.random(cg.num_edges) > 0.4
    mask_s = np.zeros(sg.num_edges, bool)
    mask_s[keep] = mask_c
    roots_s = connected_components_device(sg, jnp.asarray(mask_s))
    roots_c = connected_components_device(cg, jnp.asarray(mask_c))
    n_s, lab_s = compact_labels(np.asarray(roots_s))
    n_c, lab_c = compact_labels(np.asarray(roots_c))
    assert n_s == n_c
    np.testing.assert_array_equal(lab_s, lab_c)


def test_device_cut_on_stencil_matches_value():
    """PDHG min-cut through the stencil container reaches the same cut
    value as the host push-relabel solver."""
    from cp_pfdr_graph_d1_tpu import maxflow
    from cp_pfdr_graph_d1_tpu.maxflow.device import cut_value, min_cut_device
    sg, cg, keep = make_pair(seed=13, wrap=(False, False))
    v = sg.num_vertices
    r = np.random.default_rng(14)
    c = r.normal(size=v)
    w_s = np.asarray(sg.la_d1, np.float64)
    side_s = min_cut_device(v, None, None, jnp.asarray(w_s), c, graph=sg,
                            dtype=jnp.float64)
    eu, ev = np.asarray(sg.eu)[keep], np.asarray(sg.ev)[keep]
    side_h = maxflow.min_cut(v, eu, ev, w_s[keep], c)
    val_s = cut_value(eu, ev, w_s[keep], c, side_s)
    val_h = cut_value(eu, ev, w_s[keep], c, side_h)
    np.testing.assert_allclose(val_s, val_h, atol=1e-6)


def test_device_loop_identical_on_stencil():
    """cut='device' cut-pursuit must match between the stencil and COO
    containers (cuts, components, contraction all container-aware)."""
    import warnings
    sg, cg, keep = make_pair(seed=15, wrap=(False, False))
    v = sg.num_vertices
    r = np.random.default_rng(16)
    a = r.normal(size=(30, v)) / 5.0
    x_true = np.zeros((12, 10))
    x_true[3:8, 2:7] = 1.0
    y = a @ x_true.ravel() + 0.02 * r.normal(size=30)
    opt = CPOptions(dif_tol=1e-5, it_max=10, cut="device",
                    pfdr=PFDROptions(rho=1.5, dif_tol=1e-8, it_max=5000))
    la_l1 = np.full(v, 0.03)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        r_s = cp_quadratic_d1(DenseOp(jnp.asarray(a)), jnp.asarray(y), sg,
                              la_l1=la_l1, opt=opt)
        r_c = cp_quadratic_d1(DenseOp(jnp.asarray(a)), jnp.asarray(y), cg,
                              la_l1=la_l1, opt=opt)
    np.testing.assert_allclose(r_s.rx[r_s.cv], r_c.rx[r_c.cv], atol=1e-6)
