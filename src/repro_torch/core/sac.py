"""Split-and-Accumulate (SAC) — the paper's computing pattern in PyTorch.

``sum_i A_i W_i = sum_b 2^b (sum_i A_i W_i^b)``: one segment accumulator per
bit plane, one shift-and-add at the end (the rear adder tree).

* ``impl="planes"`` — paper-faithful per-plane SAC, K tiles ascending and
  planes within each tile (the compacted schedule's order); the kernel's
  semantic oracle.
* ``impl="int"`` / ``"float"`` — one f32 matmul against the dequantized
  codes (identical math).
* ``impl="kernel"`` — the hand-written CUDA kernel (its plain PyTorch
  version for CPU tensors); replaces the JAX package's ``"pallas"``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core import bitplanes
from repro_torch.core.activation_occupancy import GEMV_ROWS_MAX
from repro_torch.core.kneading import KneadedWeight, unknead
from repro_torch.device import DeviceLike, resolve_device

__all__ = ["SAC_IMPLS", "sac_matmul", "sac_matmul_planes", "sac_matmul_int"]

SAC_IMPLS = ("float", "int", "planes", "kernel")


def sac_matmul_planes(a: torch.Tensor, kw: KneadedWeight) -> torch.Tensor:
    """Per-plane matmuls in the schedule's k-major order, each into its
    plane's f32 segment, then ``scale * sum_b 2^b S_b`` once.  ``a`` is
    [M, kw.k]."""
    mag = bitplanes.unpack_bits(kw.planes, axis=1)               # [B-1, K, N]
    sign = 1 - 2 * bitplanes.unpack_bits(kw.signs, axis=0).to(torch.int8)
    a32 = a.to(torch.float32)
    planes = [(mag[b].to(torch.int8) * sign).to(torch.float32)
              for b in range(kw.bits - 1)]
    segments = [torch.zeros((a32.shape[0], kw.n), dtype=torch.float32,
                            device=a.device) for _ in range(kw.bits - 1)]
    for t in range(kw.k // kw.ks):           # K tiles ascending
        sl = slice(t * kw.ks, (t + 1) * kw.ks)
        for b in range(kw.bits - 1):         # planes within the K tile
            segments[b] = segments[b] + a32[:, sl] @ planes[b][sl]
    weights = (2.0 ** torch.arange(kw.bits - 1, device=a.device)).reshape(
        -1, 1, 1)
    out = (torch.stack(segments) * weights).sum(dim=0)           # rear adder
    return out * kw.scale                                        # scale once


def sac_matmul_int(a: torch.Tensor, q: torch.Tensor,
                   scale: torch.Tensor) -> torch.Tensor:
    """Integer-code matmul with the scale applied once in the epilogue.
    Codes cast to f32 are exact for bits <= 16."""
    return (a.to(torch.float32) @ q.to(torch.float32)) * scale


def sac_matmul(a: torch.Tensor, kw: KneadedWeight, impl: str = "int", *,
               skip_activations: bool = False,
               device: DeviceLike = None) -> torch.Tensor:
    """SAC matmul of activations [..., K] against a kneaded weight [K, N].

    ``K`` may be the stored or the logical dim (zero-padded here); the
    output is sliced to ``kw.logical_n``.  ``skip_activations`` arms the
    activation-side skip on the kernel path in the decode-GEMV regime only
    (at most ``GEMV_ROWS_MAX`` rows); it never changes a result.  Runs on
    ``device`` (default ``cuda``; raises without CUDA unless
    ``device="cpu"``), where ``kw`` must live.
    """
    dev = resolve_device(device)
    if kw.device != dev:
        raise ValueError(f"kneaded weight on {kw.device}, expected {dev}")
    lead = a.shape[:-1]
    a2 = a.to(dev).reshape(-1, a.shape[-1])
    if a2.shape[1] not in (kw.k, kw.logical_k):
        raise ValueError(f"activation K {a2.shape[1]} matches neither stored "
                         f"{kw.k} nor logical {kw.logical_k}")
    skip = bool(skip_activations) and a2.shape[0] <= GEMV_ROWS_MAX
    if impl == "kernel":
        from repro_torch.kernels.sac_matmul.ops import sac_matmul_kernel
        out = sac_matmul_kernel(a2, kw, skip_activations=skip)
    else:
        if a2.shape[1] != kw.k:
            a2 = F.pad(a2, (0, kw.k - a2.shape[1]))
        if impl == "planes":
            # replay the kernel path's padded M (zero rows, exact), so the
            # oracle sees the same operand shapes at every M
            from repro_torch.kernels.sac_matmul.ops import m_block
            m0 = a2.shape[0]
            pad = (-m0) % m_block(m0)
            if pad:
                a2 = F.pad(a2, (0, 0, 0, pad))
            out = sac_matmul_planes(a2, kw)[:m0]
        elif impl in ("int", "float"):
            out = a2.to(torch.float32) @ unknead(kw)   # codes * scale, exact
        else:
            raise ValueError(f"unknown impl {impl!r}")
    out = out[:, :kw.logical_n]
    return out.reshape(lead + (kw.logical_n,)).to(a.dtype)
