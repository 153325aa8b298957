"""Steepest-cut min-cut primitive (native C++ with pure-Python fallback).

Cut-pursuit's steepest binary cut asks, for per-vertex direction costs ``c``
and inactive-edge weights ``w``, for the set ``U`` minimizing
``sum_{v in U} c_v + sum_{e in boundary(U)} w_e`` — the reference poses this
as a Boykov-Kolmogorov s-t max-flow (``CP_PFDR_graph_quadratic_d1_l1.cpp:
411-549``).  Here the solver is an original FIFO push-relabel implementation
(``mincut.cpp``) compiled on first use by :mod:`..native_build`;
``min_cut`` falls back to a Dinic implementation in Python when no C++
toolchain is available.
"""
from __future__ import annotations

import ctypes
import pathlib
import warnings

import numpy as np

from ..native_build import build_library

_DIR = pathlib.Path(__file__).resolve().parent
_SRC = _DIR / "mincut.cpp"

_lib = None
_use_fallback = False


def _get_lib():
    global _lib, _use_fallback
    if _lib is not None or _use_fallback:
        return _lib
    try:
        lib = ctypes.CDLL(str(build_library("cpmincut", [_SRC])))
        lib.cp_steepest_cut.restype = ctypes.c_int
        lib.cp_steepest_cut.argtypes = [
            ctypes.c_int, ctypes.c_int,
            np.ctypeslib.ndpointer(np.int32, flags="C"),
            np.ctypeslib.ndpointer(np.int32, flags="C"),
            np.ctypeslib.ndpointer(np.float64, flags="C"),
            np.ctypeslib.ndpointer(np.float64, flags="C"),
            np.ctypeslib.ndpointer(np.uint8, flags="C"),
        ]
        lib.cp_steepest_cut_directed.restype = ctypes.c_int
        lib.cp_steepest_cut_directed.argtypes = [
            ctypes.c_int, ctypes.c_int,
            np.ctypeslib.ndpointer(np.int32, flags="C"),
            np.ctypeslib.ndpointer(np.int32, flags="C"),
            np.ctypeslib.ndpointer(np.float64, flags="C"),
            np.ctypeslib.ndpointer(np.float64, flags="C"),
            np.ctypeslib.ndpointer(np.float64, flags="C"),
            np.ctypeslib.ndpointer(np.uint8, flags="C"),
        ]
        _lib = lib
    except Exception as e:  # pragma: no cover - exercised only without g++
        warnings.warn(f"native min-cut unavailable ({e}); "
                      "falling back to pure-Python Dinic")
        _use_fallback = True
    return _lib


def min_cut(num_vertices: int, eu, ev, w, c) -> np.ndarray:
    """Returns ``side`` (uint8 [V]) with 1 for vertices in the minimizing U.

    Infinite entries of ``c`` are handled (clamped beyond any finite cut).
    """
    eu = np.ascontiguousarray(eu, np.int32)
    ev = np.ascontiguousarray(ev, np.int32)
    w = np.ascontiguousarray(w, np.float64)
    c = np.ascontiguousarray(c, np.float64)
    side = np.zeros(num_vertices, np.uint8)
    lib = _get_lib()
    if lib is not None:
        lib.cp_steepest_cut(num_vertices, len(eu), eu, ev, w, c, side)
        return side
    return _min_cut_python(num_vertices, eu, ev, w, w, c)


def min_cut_directed(num_vertices: int, eu, ev, w_uv, w_vu, c) -> np.ndarray:
    """Directed variant: per edge, residual capacity ``w_uv`` on the arc
    eu->ev and ``w_vu`` on ev->eu; an arc x->y is paid when x is in U and y
    is not.  Used by the duplex two-layer ternary cut."""
    eu = np.ascontiguousarray(eu, np.int32)
    ev = np.ascontiguousarray(ev, np.int32)
    w_uv = np.ascontiguousarray(w_uv, np.float64)
    w_vu = np.ascontiguousarray(w_vu, np.float64)
    c = np.ascontiguousarray(c, np.float64)
    side = np.zeros(num_vertices, np.uint8)
    lib = _get_lib()
    if lib is not None:
        lib.cp_steepest_cut_directed(num_vertices, len(eu), eu, ev,
                                     w_uv, w_vu, c, side)
        return side
    return _min_cut_python(num_vertices, eu, ev, w_uv, w_vu, c)


def _min_cut_python(n, eu, ev, w_uv, w_vu, c):
    """Dinic's algorithm fallback (slow; for toolchain-free environments).
    Per-direction arc capacities (``w_uv`` on eu->ev, ``w_vu`` on ev->eu;
    pass the same array twice for the undirected cut)."""
    big = 1.0 + (float(np.sum(w_uv[np.isfinite(w_uv)]))
                 + float(np.sum(w_vu[np.isfinite(w_vu)]))
                 + float(np.sum(np.abs(c[np.isfinite(c)]))))
    # node 0 = source, 1..n = vertices, n+1 = sink
    graph = [[] for _ in range(n + 2)]

    def add(u, v, cap):
        graph[u].append([v, cap, len(graph[v])])
        graph[v].append([u, 0.0, len(graph[u]) - 1])

    s, t = 0, n + 1
    for i in range(n):
        cv = min(max(float(c[i]), -big), big)
        if cv > 0:
            add(i + 1, t, cv)
        elif cv < 0:
            add(s, i + 1, -cv)
    for e in range(len(eu)):
        wf = min(float(w_uv[e]), big)
        wb = min(float(w_vu[e]), big)
        if wf > 0:
            add(eu[e] + 1, ev[e] + 1, wf)
        if wb > 0:
            add(ev[e] + 1, eu[e] + 1, wb)

    from collections import deque

    def bfs():
        level = [-1] * (n + 2)
        level[s] = 0
        q = deque([s])
        while q:
            u = q.popleft()
            for arc in graph[u]:
                if arc[1] > 1e-12 and level[arc[0]] < 0:
                    level[arc[0]] = level[u] + 1
                    q.append(arc[0])
        return level

    def dfs(u, f, level, it):
        if u == t:
            return f
        while it[u] < len(graph[u]):
            arc = graph[u][it[u]]
            v = arc[0]
            if arc[1] > 1e-12 and level[v] == level[u] + 1:
                d = dfs(v, min(f, arc[1]), level, it)
                if d > 0:
                    arc[1] -= d
                    graph[v][arc[2]][1] += d
                    return d
            it[u] += 1
        return 0.0

    import sys
    sys.setrecursionlimit(10000 + 2 * n)
    while True:
        level = bfs()
        if level[t] < 0:
            break
        it = [0] * (n + 2)
        while dfs(s, float("inf"), level, it) > 0:
            pass
    # sink side = can reach t in residual graph
    t_side = np.zeros(n + 2, bool)
    t_side[t] = True
    stack = [t]
    # reverse residual reachability: u -> t side if residual cap(u -> x) > 0
    # for some x already on the t side
    incoming = [[] for _ in range(n + 2)]
    for u in range(n + 2):
        for ai, arc in enumerate(graph[u]):
            incoming[arc[0]].append((u, ai))
    while stack:
        x = stack.pop()
        for (u, ai) in incoming[x]:
            if not t_side[u] and graph[u][ai][1] > 1e-12:
                t_side[u] = True
                stack.append(u)
    return (~t_side[1:n + 1]).astype(np.uint8)
