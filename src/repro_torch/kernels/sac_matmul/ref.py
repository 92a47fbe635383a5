"""Dense oracle for the SAC bit-plane matmul: ``A @ unknead(KW)`` in f32,
by construction ``scale * sum_b 2^b (A @ S_b)``."""
from __future__ import annotations

import torch

from repro_torch.core.kneading import KneadedWeight, unknead


def sac_matmul_ref(a: torch.Tensor, kw: KneadedWeight) -> torch.Tensor:
    """[M, K] @ kneaded [K, N] -> [M, N] f32."""
    return a.to(torch.float32) @ unknead(kw)
