"""Graph-TV proximal-splitting framework on JAX.

A from-scratch JAX/XLA re-design of the capabilities of the reference
``CP_PFDR_graph_d1`` C++/OpenMP library: cut-pursuit outer solvers over
preconditioned forward-Douglas-Rachford inner solvers for graph
total-variation regularized problems (fused LASSO, box-constrained quadratic,
separable-loss simplex labeling).
"""

from .circulant import CirculantGraphD1, strip_order
from .config import CPOptions, Lipsch, PFDROptions
from .graph import GraphD1
from .stencil import StencilGraphD1
from .operators import (DenseOp, DiagOp, GramOp, IdentityOp, QuadOp,
                        make_operator)
from .solvers import (PFDRResult, SimplexResult, VertexProx,
                      pfdr_loss_d1_simplex, pfdr_quadratic_d1)

__all__ = [
    "CirculantGraphD1", "StencilGraphD1", "strip_order",
    "CPOptions", "Lipsch", "PFDROptions", "GraphD1",
    "DenseOp", "DiagOp", "GramOp", "IdentityOp", "QuadOp", "make_operator",
    "PFDRResult", "SimplexResult", "VertexProx", "pfdr_loss_d1_simplex",
    "pfdr_quadratic_d1",
]

__version__ = "0.1.0"
