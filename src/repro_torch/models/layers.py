"""Shared layers: the float / kneaded linear dispatch."""
from __future__ import annotations

import torch

from repro_torch.core.kneading import KneadedWeight


def matmul_any(x: torch.Tensor, w, impl: str = "int") -> torch.Tensor:
    """``x @ w`` in f32 for a float or a :class:`KneadedWeight` ``w``.

    ``impl`` selects the SAC path for kneaded weights (see
    ``core.sac.sac_matmul``) and is ignored for float ones.
    """
    if isinstance(w, KneadedWeight):
        from repro_torch.core.sac import sac_matmul
        return sac_matmul(x, w, impl=impl, device=x.device)
    return x.to(torch.float32) @ w.to(torch.float32)
