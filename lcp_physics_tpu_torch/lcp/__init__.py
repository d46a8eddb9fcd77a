"""Batched differentiable LCP/QP solver (counterpart of
``lcp_physics_tpu/lcp``)."""

from lcp_physics_tpu_torch.lcp.cone import ConeF
from lcp_physics_tpu_torch.lcp.lcp import (LCPFunction, lcp_solve,
                                           lcp_solve_full)
from lcp_physics_tpu_torch.lcp.pdipm import (PdipmSolution, pdipm_solve,
                                             solve_eq_kkt)
from lcp_physics_tpu_torch.lcp.util import (batch, bger, expandParam,
                                            expand_param, extract_batch_size,
                                            extract_nBatch, get_sizes)

__all__ = [
    "ConeF", "LCPFunction", "lcp_solve", "lcp_solve_full", "pdipm_solve",
    "PdipmSolution", "solve_eq_kkt", "batch", "bger", "expandParam",
    "expand_param", "extract_batch_size", "extract_nBatch", "get_sizes",
]
