"""Circulant (shift-family) graph container vs the plain COO container.

The container only reorders and pads the edge set (inert weight-0 slots),
so solves must match the plain container to float64 rounding.
"""
import jax.numpy as jnp
import numpy as np
import pytest

from cp_pfdr_graph_d1_tpu import (DenseOp, GraphD1, PFDROptions, VertexProx,
                                  pfdr_quadratic_d1)
from cp_pfdr_graph_d1_tpu.circulant import CirculantGraphD1, strip_order

from .conftest import make_grid_graph


def mesh_graph(v=600, seed=0):
    """Grid plus random chords: many repeated offsets, some rare ones."""
    r = np.random.default_rng(seed)
    eu, ev, la = make_grid_graph(24, v // 24, seed=seed)
    extra = 40
    ceu = r.integers(0, v, extra).astype(np.int32)
    cev = ((ceu + r.integers(1, v // 2, extra)) % v).astype(np.int32)
    keep = ceu != cev
    eu = np.concatenate([eu, ceu[keep]])
    ev = np.concatenate([ev, cev[keep]])
    la = np.concatenate([la, 0.4 + r.random(keep.sum())])
    return eu, ev, la


def test_build_partitions_edges():
    """Family slots + remainder must hold exactly the input edge multiset."""
    eu, ev, la = mesh_graph(seed=1)
    v = 600
    g = CirculantGraphD1.create(eu, ev, la, num_vertices=v,
                                dtype=jnp.float64, max_families=8,
                                min_count=4)
    # weight-carrying slots of the container == input edges (orientation
    # normalized to min-endpoint first)
    got = {}
    ge, gv, gl = (np.asarray(g.eu), np.asarray(g.ev), np.asarray(g.la_d1))
    for e in range(g.num_edges):
        if gl[e] != 0.0:
            key = (min(ge[e], gv[e]), max(ge[e], gv[e]))
            got[key] = got.get(key, 0.0) + gl[e]
    want = {}
    for u, w, weight in zip(eu, ev, la):
        key = (min(u, w), max(u, w))
        want[key] = want.get(key, 0.0) + weight
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-12)
    assert len(g.offsets) <= 8
    assert g.num_rem < len(eu)  # most edges landed in families


def test_scatter_matches_plain():
    eu, ev, la = mesh_graph(seed=2)
    v = 600
    g = CirculantGraphD1.create(eu, ev, la, num_vertices=v,
                                dtype=jnp.float64, max_families=8,
                                min_count=4)
    r = np.random.default_rng(3)
    vu = jnp.asarray(r.normal(size=g.num_edges))
    vv = jnp.asarray(r.normal(size=g.num_edges))
    out = np.asarray(g.edge_to_vertex_sum(vu, vv))
    # oracle: accumulate through the masked incidence table (only real,
    # incidence-listed slots participate; sentinel 2E selects the zero pad)
    inc = np.asarray(g.incidence)
    e = g.num_edges
    vals = np.concatenate([np.asarray(vu), np.asarray(vv), [0.0]])
    ref = vals[inc].reshape(v, -1).sum(axis=1)
    np.testing.assert_allclose(out, ref, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("vprox", [
    VertexProx(kind="l1"),
    VertexProx(kind="l1", positivity=True),
    VertexProx(kind="bounds", lo=-0.4, hi=1.1),
    VertexProx(kind="none"),
])
def test_circulant_matches_plain(vprox):
    """Circulant solve (families + COO remainder) == plain COO solve."""
    eu, ev, la = mesh_graph(seed=4)
    v = 600
    la = 0.12 * la
    r = np.random.default_rng(5)
    a = r.normal(size=(32, v)) / np.sqrt(32)
    y = a @ r.normal(size=v)
    lip = float(np.linalg.svd(a, compute_uv=False)[0] ** 2)
    la_l1 = jnp.full((v,), 0.03) if vprox.kind == "l1" else None
    kw = dict(la_l1=la_l1, vprox=vprox, lipsch=lip,
              opt=PFDROptions(rho=1.4, dif_tol=1e-8, it_max=400))
    base = pfdr_quadratic_d1(
        DenseOp(jnp.asarray(a)), jnp.asarray(y),
        GraphD1.create(eu, ev, la, num_vertices=v, dtype=jnp.float64), **kw)
    circ = CirculantGraphD1.create(eu, ev, la, num_vertices=v,
                                   dtype=jnp.float64, max_families=8,
                                   min_count=4)
    assert circ.num_rem > 0
    res = pfdr_quadratic_d1(DenseOp(jnp.asarray(a)), jnp.asarray(y), circ,
                            **kw)
    assert int(res.it) == int(base.it)
    np.testing.assert_allclose(np.asarray(res.x), np.asarray(base.x),
                               atol=1e-10)


def test_circulant_no_remainder():
    """A pure grid under its natural order decomposes with zero remainder."""
    eu, ev, la = make_grid_graph(16, 16, seed=6)
    v = 256
    g = CirculantGraphD1.create(eu, ev, 0.1, num_vertices=v,
                                dtype=jnp.float64, max_families=4,
                                min_count=2)
    assert g.num_rem == 0
    r = np.random.default_rng(7)
    a = r.normal(size=(20, v)) / 4.0
    y = a @ r.normal(size=v)
    lip = float(np.linalg.svd(a, compute_uv=False)[0] ** 2)
    kw = dict(la_l1=jnp.full((v,), 0.02), vprox=VertexProx(kind="l1"),
              lipsch=lip, opt=PFDROptions(dif_tol=1e-9, it_max=400))
    base = pfdr_quadratic_d1(
        DenseOp(jnp.asarray(a)), jnp.asarray(y),
        GraphD1.create(eu, ev, 0.1, num_vertices=v, dtype=jnp.float64),
        **kw)
    res = pfdr_quadratic_d1(DenseOp(jnp.asarray(a)), jnp.asarray(y), g,
                            **kw)
    assert int(res.it) == int(base.it)
    np.testing.assert_allclose(np.asarray(res.x), np.asarray(base.x),
                               atol=1e-10)


def test_family_slots_are_flat_shifts():
    """Family ``f``'s slot ``u`` is the edge ``(u, u + d_f)``: its endpoint
    gather is the vertex field circularly shifted by the family offset,
    with every empty slot at weight 0."""
    eu, ev, la = mesh_graph(seed=9)
    v = 600
    g = CirculantGraphD1.create(eu, ev, la, num_vertices=v,
                                dtype=jnp.float64, max_families=8,
                                min_count=4)
    x = jnp.asarray(np.random.default_rng(10).normal(size=v))
    xu, xv = g.gather_endpoints(x)
    la_g = np.asarray(g.la_d1)
    for f, d in enumerate(g.offsets):
        sl = slice(f * v, (f + 1) * v)
        real = la_g[sl] != 0
        np.testing.assert_array_equal(np.asarray(xu[sl])[real],
                                      np.asarray(x)[real])
        np.testing.assert_array_equal(np.asarray(xv[sl])[real],
                                      np.roll(np.asarray(x), -d)[real])
    assert g.num_edges == len(g.offsets) * v + g.num_rem


def test_strip_order_concentrates_offsets():
    """strip_order on scattered mesh coordinates concentrates edge offsets
    far better than the shuffled labeling."""
    r = np.random.default_rng(8)
    from scipy.spatial import Delaunay
    pts = r.random((2000, 2))
    tri = Delaunay(pts)
    edges = set()
    for s in tri.simplices:
        for i in range(3):
            a, b = int(s[i]), int(s[(i + 1) % 3])
            edges.add((min(a, b), max(a, b)))
    eu = np.array([e[0] for e in edges])
    ev = np.array([e[1] for e in edges])
    order = strip_order(pts)
    inv = np.empty(len(pts), np.int64)
    inv[order] = np.arange(len(pts))

    def coverage(u, w, topk=64):
        d = np.abs(u.astype(np.int64) - w.astype(np.int64))
        _, counts = np.unique(d, return_counts=True)
        counts = np.sort(counts)[::-1]
        return counts[:topk].sum() / counts.sum()

    assert coverage(inv[eu], inv[ev]) > 2 * coverage(eu, ev)
    assert coverage(inv[eu], inv[ev]) > 0.8
