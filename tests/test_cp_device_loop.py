"""Per-iteration device cut-pursuit loop (``CPOptions(cut="device")``).

PDHG steepest cuts, device connected components (``ops/components.py``),
device contraction and staged reduced solves, one host sync per stage.
The host loop (native push-relabel cuts, scipy components) is the
reference; the two can settle on different near-optimal partitions, so
parity is asserted on the OBJECTIVE, like the reference's own Obj trace.
"""
import jax.numpy as jnp
import numpy as np

from cp_pfdr_graph_d1_tpu import DenseOp, IdentityOp
from cp_pfdr_graph_d1_tpu.config import CPOptions, PFDROptions
from cp_pfdr_graph_d1_tpu.graph import GraphD1
from cp_pfdr_graph_d1_tpu.solvers.cut_pursuit import cp_quadratic_d1
from cp_pfdr_graph_d1_tpu.stencil import StencilGraphD1

PF = PFDROptions(rho=1.5, dif_tol=1e-7, it_max=4000)


def grid_problem(h=16, w=16, n=24, seed=0):
    rng = np.random.default_rng(seed)
    v = h * w
    idx = np.arange(v).reshape(h, w)
    eu = np.concatenate([idx[:, :-1].ravel(),
                         idx[:-1, :].ravel()]).astype(np.int32)
    ev = np.concatenate([idx[:, 1:].ravel(),
                         idx[1:, :].ravel()]).astype(np.int32)
    a = (rng.normal(size=(n, v)) / np.sqrt(n)).astype(np.float32)
    x_true = np.zeros(v, np.float32)
    x_true[idx[4:8, 4:8].ravel()] = 2.0
    y = (a @ x_true + 0.02 * rng.normal(size=n)).astype(np.float32)
    return eu, ev, a, y


def objective(x, a, y, eu, ev, la_d1, la_l1=None):
    x = np.asarray(x, np.float64)
    r = a.astype(np.float64) @ x - y.astype(np.float64)
    obj = 0.5 * r @ r + np.sum(la_d1 * np.abs(x[eu] - x[ev]))
    if la_l1 is not None:
        obj += np.sum(la_l1 * np.abs(x))
    return obj


def stencil(h=16, w=16, la=0.1):
    return StencilGraphD1.create((h, w), {(0, 1): la, (1, 0): la},
                                dtype=jnp.float32)


def test_device_loop_stencil_matches_host_objective():
    eu, ev, a, y = grid_problem()
    la_l1 = np.full(a.shape[1], 0.03, np.float32)
    gc = GraphD1.create(eu, ev, 0.1, dtype=jnp.float32)
    op = DenseOp(jnp.asarray(a))
    res_h = cp_quadratic_d1(op, jnp.asarray(y), gc, la_l1=la_l1,
                            positivity=True,
                            opt=CPOptions(dif_tol=1e-5, it_max=10, pfdr=PF))
    res_d = cp_quadratic_d1(op, jnp.asarray(y), stencil(), la_l1=la_l1,
                            positivity=True,
                            opt=CPOptions(dif_tol=1e-5, it_max=10, pfdr=PF,
                                          cut="device"))
    oh = objective(res_h.rx[res_h.cv], a, y, eu, ev, 0.1, la_l1)
    od = objective(res_d.rx[res_d.cv], a, y, eu, ev, 0.1, la_l1)
    assert od <= oh * (1 + 1e-3) + 1e-9
    assert np.all(res_d.rx[res_d.cv] >= 0)


def test_device_loop_coo_generic_path():
    """The device loop on a plain COO graph: incidence-table cuts and
    components instead of rolls."""
    eu, ev, a, y = grid_problem(seed=1)
    la_l1 = np.full(a.shape[1], 0.03, np.float32)
    gc = GraphD1.create(eu, ev, 0.1, dtype=jnp.float32)
    op = DenseOp(jnp.asarray(a))
    res_h = cp_quadratic_d1(op, jnp.asarray(y), gc, la_l1=la_l1,
                            positivity=True,
                            opt=CPOptions(dif_tol=1e-5, it_max=10, pfdr=PF))
    res_d = cp_quadratic_d1(op, jnp.asarray(y), gc, la_l1=la_l1,
                            positivity=True,
                            opt=CPOptions(dif_tol=1e-5, it_max=10, pfdr=PF,
                                          cut="device"))
    oh = objective(res_h.rx[res_h.cv], a, y, eu, ev, 0.1, la_l1)
    od = objective(res_d.rx[res_d.cv], a, y, eu, ev, 0.1, la_l1)
    assert od <= oh * (1 + 1e-3) + 1e-9


def test_device_loop_bounds_family():
    eu, ev, a, y = grid_problem(seed=2)
    gc = GraphD1.create(eu, ev, 0.1, dtype=jnp.float32)
    op = DenseOp(jnp.asarray(a))
    res_h = cp_quadratic_d1(op, jnp.asarray(y), gc, bounds=(-0.5, 1.5),
                            opt=CPOptions(dif_tol=1e-5, it_max=10, pfdr=PF))
    res_d = cp_quadratic_d1(op, jnp.asarray(y), stencil(),
                            bounds=(-0.5, 1.5),
                            opt=CPOptions(dif_tol=1e-5, it_max=10, pfdr=PF,
                                          cut="device"))
    oh = objective(res_h.rx[res_h.cv], a, y, eu, ev, 0.1)
    od = objective(res_d.rx[res_d.cv], a, y, eu, ev, 0.1)
    assert od <= oh * (1 + 1e-3) + 1e-9
    x = res_d.rx[res_d.cv]
    assert x.min() >= -0.5 - 1e-6 and x.max() <= 1.5 + 1e-6


def test_device_loop_noisy_identity_many_components():
    """A noisy identity problem that shatters into many components: the
    bucketed reduced shapes grow across iterations without losing
    correctness."""
    rng = np.random.default_rng(1)
    h = w = 24
    v = h * w
    idx = np.arange(v).reshape(h, w)
    eu = np.concatenate([idx[:, :-1].ravel(),
                         idx[:-1, :].ravel()]).astype(np.int32)
    ev = np.concatenate([idx[:, 1:].ravel(),
                         idx[1:, :].ravel()]).astype(np.int32)
    xt = np.zeros((h, w), np.float32)
    xt[4:12, 4:12] = 1.0
    xt[14:20, 10:20] = -0.7
    y = (xt + 0.4 * rng.standard_normal((h, w))).astype(np.float32).ravel()
    g = GraphD1.create(eu, ev, 0.15, dtype=jnp.float32)
    res_h = cp_quadratic_d1(IdentityOp(), jnp.asarray(y), g,
                            opt=CPOptions(dif_tol=1e-5, it_max=8, pfdr=PF))
    res_d = cp_quadratic_d1(IdentityOp(), jnp.asarray(y), g,
                            opt=CPOptions(dif_tol=1e-5, it_max=8, pfdr=PF,
                                          cut="device"))
    assert len(res_d.rx) > 8

    def obj(x):
        x = np.asarray(x, np.float64)
        d = x - y.astype(np.float64)
        return 0.5 * d @ d + np.sum(0.15 * np.abs(x[eu] - x[ev]))

    assert obj(res_d.rx[res_d.cv]) <= obj(res_h.rx[res_h.cv]) * (1 + 1e-3)


def test_device_loop_warm_restart_state():
    """The device loop accepts a warm-restart state and keeps improving."""
    eu, ev, a, y = grid_problem(seed=5)
    la_l1 = np.full(a.shape[1], 0.03, np.float32)
    op = DenseOp(jnp.asarray(a))
    gs = stencil()
    opt2 = CPOptions(dif_tol=1e-6, it_max=2, pfdr=PF, cut="device")
    opt_full = CPOptions(dif_tol=1e-6, it_max=10, pfdr=PF, cut="device")
    part = cp_quadratic_d1(op, jnp.asarray(y), gs, la_l1=la_l1,
                           positivity=True, opt=opt2)
    rest = cp_quadratic_d1(op, jnp.asarray(y), gs, la_l1=la_l1,
                           positivity=True, opt=opt_full, state=part.state)
    full = cp_quadratic_d1(op, jnp.asarray(y), gs, la_l1=la_l1,
                           positivity=True, opt=opt_full)
    o_rest = objective(rest.rx[rest.cv], a, y, eu, ev, 0.1, la_l1)
    o_full = objective(full.rx[full.cv], a, y, eu, ev, 0.1, la_l1)
    assert o_rest <= o_full * (1 + 1e-3) + 1e-9


def test_device_cut_matches_host_cut_value():
    """The device loop's steepest cut (PDHG on the standing stencil graph,
    active edges masked out) reaches the host push-relabel cut value."""
    from cp_pfdr_graph_d1_tpu import maxflow
    from cp_pfdr_graph_d1_tpu.maxflow.device import cut_value
    from cp_pfdr_graph_d1_tpu.solvers.cut_pursuit_device import _device_cut

    h = w = 20
    g = stencil(h, w, 0.3)
    r = np.random.default_rng(0)
    act = r.random(g.num_edges) < 0.1
    c = r.standard_normal(g.num_vertices)
    sep, gap, big, x, _ = _device_cut(g, jnp.asarray(act), jnp.asarray(c),
                                      jnp.asarray(1e-9), 50_000, 250)
    assert float(gap) <= 1e-9 * float(big)
    eu, ev = np.asarray(g.eu), np.asarray(g.ev)
    w_np = np.where(act, 0.0, np.asarray(g.la_d1, np.float64))
    side_h = maxflow.min_cut(g.num_vertices, eu, ev, w_np, c)
    v_dev = cut_value(eu, ev, w_np, c, np.asarray(x) > 0.5)
    v_host = cut_value(eu, ev, w_np, c, side_h)
    np.testing.assert_allclose(v_dev, v_host, atol=1e-6)


def test_components_high_density_converges():
    """Regression: the device components' former round cap (2 log2 V + 8)
    under-converged on snake-shaped components at high cut densities —
    the stencil (rolls) and COO (incidence) paths must match scipy."""
    from cp_pfdr_graph_d1_tpu.solvers.cut_pursuit_common import \
        connected_components
    from cp_pfdr_graph_d1_tpu.solvers.cut_pursuit_device import \
        _device_components

    side = 48
    sgc = stencil(side, side, 0.3)
    rr = np.random.default_rng(5)
    act_np = rr.random(sgc.num_edges) < 0.45
    eu = np.asarray(sgc.eu)
    ev = np.asarray(sgc.ev)
    la = np.asarray(sgc.la_d1)
    nc_true, cv_true = connected_components(side * side, eu, ev,
                                            ~act_np & (la > 0))
    cvs, ncs, _ = _device_components(sgc, jnp.asarray(act_np))
    assert int(ncs) == nc_true
    np.testing.assert_array_equal(np.asarray(cvs), cv_true)
    keep = la > 0
    g = GraphD1.create(eu[keep], ev[keep], la[keep],
                       num_vertices=side * side, dtype=jnp.float32)
    cvg, ncg, _ = _device_components(g, jnp.asarray(act_np[keep]))
    assert int(ncg) == nc_true
    np.testing.assert_array_equal(np.asarray(cvg), cv_true)
