"""Route choice on a GPU backend: every public path is plain JAX/XLA.

The backend query is patched to report ``"gpu"``, and binding a Pallas
kernel raises, so any entry point that would trace a ``pallas_call`` on
the card fails here.  The reduced-solve route of the host loop is
checked too: on a non-CPU backend, small reduced problems go to the
native float64 solver.
"""
import importlib
import pkgutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import cp_pfdr_graph_d1_tpu as cp
from cp_pfdr_graph_d1_tpu import native
from cp_pfdr_graph_d1_tpu.circulant import CirculantGraphD1
from cp_pfdr_graph_d1_tpu.graph import GraphD1, ScatterGraphD1
from cp_pfdr_graph_d1_tpu.solvers.cut_pursuit import cp_quadratic_d1
from cp_pfdr_graph_d1_tpu.solvers.cut_pursuit_common import \
    make_reduced_container
from cp_pfdr_graph_d1_tpu.solvers.cut_pursuit_simplex import \
    cp_loss_d1_simplex
from cp_pfdr_graph_d1_tpu.stencil import StencilGraphD1

H = W = 12


@pytest.fixture
def gpu_backend(monkeypatch):
    """Reports a GPU backend and forbids tracing any Pallas kernel."""
    from jax._src.pallas import pallas_call as pallas_mod

    def no_kernels(*args, **kwargs):
        raise AssertionError("a Pallas kernel was traced")

    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    monkeypatch.setattr(pallas_mod.pallas_call_p, "bind", no_kernels)
    monkeypatch.setattr(pallas_mod, "pallas_call", no_kernels)


def grid(container):
    idx = np.arange(H * W).reshape(H, W)
    eu = np.concatenate([idx[:, :-1].ravel(), idx[:-1, :].ravel()])
    ev = np.concatenate([idx[:, 1:].ravel(), idx[1:, :].ravel()])
    if container == "stencil":
        return StencilGraphD1.create((H, W), {(0, 1): 0.1, (1, 0): 0.1},
                                     dtype=jnp.float32)
    if container == "circulant":
        return CirculantGraphD1.create(eu, ev, 0.1, num_vertices=H * W,
                                       dtype=jnp.float32, max_families=4,
                                       min_count=2)
    return GraphD1.create(eu, ev, 0.1, num_vertices=H * W,
                          dtype=jnp.float32)


def problem(seed=0, n=20):
    r = np.random.default_rng(seed)
    v = H * W
    a = (r.standard_normal((n, v)) / np.sqrt(n)).astype(np.float32)
    x = np.zeros((H, W), np.float32)
    x[3:8, 2:7] = 1.0
    y = (a @ x.ravel() + 0.02 * r.standard_normal(n)).astype(np.float32)
    return a, y


def labels_q(seed=0, k=3):
    r = np.random.default_rng(seed)
    lab = np.zeros((H, W), int)
    lab[:, W // 2:] = 1
    lab[H // 2:, :] = 2
    q = np.full((H * W, k), 0.1, np.float32)
    q[np.arange(H * W), lab.ravel()] = 0.8
    q += 0.05 * r.random((H * W, k)).astype(np.float32)
    return q / q.sum(1, keepdims=True)


CONTAINERS = ["coo", "stencil", "circulant"]


@pytest.mark.parametrize("container", CONTAINERS)
def test_pfdr_quadratic_route_is_plain_xla(gpu_backend, container):
    a, y = problem()
    res = cp.pfdr_quadratic_d1(
        cp.DenseOp(jnp.asarray(a)), jnp.asarray(y), grid(container),
        la_l1=jnp.full((H * W,), 0.01, jnp.float32),
        vprox=cp.VertexProx(kind="l1", positivity=True),
        lipsch=float(np.linalg.norm(a, 2) ** 2),
        opt=cp.PFDROptions(rho=1.5, dif_tol=0.0, it_max=30))
    assert int(res.it) == 30 and np.isfinite(np.asarray(res.x)).all()


@pytest.mark.parametrize("container", CONTAINERS)
def test_pfdr_simplex_route_is_plain_xla(gpu_backend, container):
    res = cp.pfdr_loss_d1_simplex(
        grid(container), jnp.asarray(labels_q()), al=0.5,
        opt=cp.PFDROptions(rho=1.5, dif_tol=0.0, it_max=30))
    p = np.asarray(res.p)
    assert int(res.it) == 30
    np.testing.assert_allclose(p.sum(1), 1.0, atol=1e-5)


@pytest.mark.parametrize("cut", ["host", "device"])
def test_cp_quadratic_route_is_plain_xla(gpu_backend, monkeypatch, cut):
    """On a GPU the host loop sends small reduced problems to the native
    f64 solver; the device loop keeps them on the card."""
    calls = []
    host_solve = native.pfdr_quadratic_d1_host

    def spy(*args, **kwargs):
        calls.append(1)
        return host_solve(*args, **kwargs)

    monkeypatch.setattr(native, "pfdr_quadratic_d1_host", spy)
    a, y = problem(seed=1)
    graph = grid("stencil" if cut == "device" else "coo")
    res = cp_quadratic_d1(
        cp.DenseOp(jnp.asarray(a)), jnp.asarray(y), graph,
        la_l1=np.full(H * W, 0.01, np.float32), positivity=True,
        opt=cp.CPOptions(dif_tol=1e-4, it_max=4, cut=cut,
                         pfdr=cp.PFDROptions(rho=1.5, dif_tol=1e-5,
                                             it_max=2000)))
    x = res.rx[res.cv]
    assert np.isfinite(x).all() and len(res.rx) >= 2
    assert bool(calls) == (cut == "host" and native.available())


@pytest.mark.parametrize("cut", ["host", "device"])
def test_cp_simplex_route_is_plain_xla(gpu_backend, cut):
    graph = grid("stencil" if cut == "device" else "coo")
    res = cp_loss_d1_simplex(
        graph, jnp.asarray(labels_q(seed=2)), al=0.5,
        opt=cp.CPOptions(dif_tol=1.0, it_max=4, cut=cut,
                         pfdr=cp.PFDROptions(rho=1.5, dif_tol=1e-4,
                                             it_max=500)))
    p = np.asarray(res.rp)[np.asarray(res.cv)]
    assert len(res.rp) >= 2
    np.testing.assert_allclose(p.sum(1), 1.0, atol=1e-4)


def test_no_module_imports_pallas():
    """No module of the package depends on Pallas."""
    for info in pkgutil.walk_packages(cp.__path__, cp.__name__ + "."):
        mod = importlib.import_module(info.name)
        for name, val in vars(mod).items():
            assert "pallas" not in getattr(val, "__name__", ""), \
                (info.name, name)


def test_reduced_container_choice():
    """Contracted graphs keep the incidence-table container unless a hub
    component makes the [rV, max_degree] table degenerate; then they
    switch to scatter-add accumulation — with the same solve."""
    rv = 4096
    ring = np.arange(rv, dtype=np.int32)
    g_ring = make_reduced_container(ring, (ring + 1) % rv,
                                    np.full(rv, 0.2), rv, jnp.float64)
    assert type(g_ring) is GraphD1
    spokes = np.arange(1, rv, dtype=np.int32)
    hub_u = np.concatenate([np.zeros(rv - 1, np.int32), ring[1:-1]])
    hub_v = np.concatenate([spokes, ring[2:]])
    la = np.full(len(hub_u), 0.2)
    g_hub = make_reduced_container(hub_u, hub_v, la, rv, jnp.float64)
    assert type(g_hub) is ScatterGraphD1
    r = np.random.default_rng(0)
    obs = jnp.asarray(r.standard_normal(rv))
    kw = dict(opt=cp.PFDROptions(rho=1.5, dif_tol=0.0, it_max=40))
    x_s = cp.pfdr_quadratic_d1(cp.IdentityOp(), obs, g_hub, **kw).x
    x_g = cp.pfdr_quadratic_d1(
        cp.IdentityOp(), obs,
        GraphD1.create(hub_u, hub_v, la, num_vertices=rv,
                       dtype=jnp.float64), **kw).x
    np.testing.assert_allclose(np.asarray(x_s), np.asarray(x_g),
                               atol=1e-12)
