"""Fixed-point quantization — the substrate under weight kneading.

Symmetric per-output-channel fixed-point quantization for B in {2..16}
bits, the same codes and scales as ``repro.core.quantization`` bit for bit:

* ``q`` is a signed integer code in ``[-(2^{B-1}-1), 2^{B-1}-1]`` stored in
  the smallest sufficient integer dtype (int8 for B<=8 else int16).
* ``w ~= q * scale`` with ``scale`` broadcast along the output-channel axis
  (last axis by convention: weights are stored ``[..., K, N]``).
* ``-2^{B-1}`` is excluded from the code range so ``|q|`` fits in B-1
  magnitude bits: the sign-magnitude decomposition is exactly B-1 planes
  plus a sign.
* Rounding is half-to-even (``torch.round``, like ``jnp.round``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

__all__ = ["QuantizedTensor", "storage_dtype", "quantize", "dequantize"]


def storage_dtype(bits: int) -> torch.dtype:
    """Smallest signed integer dtype that can hold a ``bits``-bit code."""
    if bits <= 8:
        return torch.int8
    if bits <= 16:
        return torch.int16
    return torch.int32


@dataclasses.dataclass(frozen=True)
class QuantizedTensor:
    """A symmetric fixed-point tensor: ``value ~= q.float() * scale``."""

    q: torch.Tensor
    scale: torch.Tensor
    bits: int = 8
    axis: Optional[int] = -1


def quantize(w: torch.Tensor, bits: int = 8,
             axis: Optional[int] = -1) -> QuantizedTensor:
    """Symmetric quantization of ``w`` to ``bits`` bits with one scale per
    channel along ``axis``, or one per-tensor scale for ``axis=None``."""
    if not 2 <= bits <= 16:
        raise ValueError(f"bits must be in [2, 16], got {bits}")
    w = w.to(torch.float32)
    qmax = float(2 ** (bits - 1) - 1)
    if axis is None:
        absmax = w.abs().amax().reshape((1,) * w.ndim)
    else:
        dims = tuple(i for i in range(w.ndim) if i != axis % w.ndim)
        absmax = w.abs().amax(dim=dims, keepdim=True)
    # all-zero channels: scale 1.0 yields q == 0 there
    scale = torch.where(absmax > 0, absmax / qmax, torch.ones_like(absmax))
    q = torch.clamp(torch.round(w / scale), -qmax, qmax)
    return QuantizedTensor(q=q.to(storage_dtype(bits)),
                           scale=scale.to(torch.float32), bits=bits,
                           axis=axis)


def dequantize(t: QuantizedTensor) -> torch.Tensor:
    return t.q.to(torch.float32) * t.scale
