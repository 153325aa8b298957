"""Float64 native-twin references shared by the CPU tests."""
import numpy as np

from cp_pfdr_graph_d1_tpu import VertexProx, native


def vprox_kwargs(vprox: VertexProx, la_l1):
    """Arguments of :func:`native.pfdr_quadratic_d1_host` that select the
    same vertex term as ``vprox`` (with ``la_l1`` for the l1 family)."""
    if vprox.kind == "l1":
        return dict(la_l1=None if la_l1 is None else np.asarray(la_l1),
                    positivity=vprox.positivity)
    if vprox.kind == "bounds":
        return dict(bounds=(vprox.lo, vprox.hi))
    return {}


VPROXES = [
    VertexProx(kind="l1"),
    VertexProx(kind="l1", positivity=True),
    VertexProx(kind="bounds", lo=-0.5, hi=0.8),
    VertexProx(),
]
VPROX_IDS = ["l1", "l1pos", "bounds", "none"]
