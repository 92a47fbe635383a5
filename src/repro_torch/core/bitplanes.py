"""Bit-plane decomposition and packing — the data layout under SAC.

Sign-magnitude planes: ``q = sign(q) * sum_b 2^b * P_b`` with
``P_b in {0, 1}``.  Planes are bit-packed 32 per word along the reduction
axis K: bit ``i`` of word ``w`` holds row ``32 w + i``.

Packed words are ``torch.int32`` tensors holding the same 32 bits as the
JAX package's ``uint32`` words, so their bytes (and CRC32s) are identical.
int32 is used because shifts on ``torch.uint32`` are not implemented on
every backend; ``(x >> i) & 1`` on int32 still reads bit ``i`` for every
``0 <= i < 32`` (the arithmetic shift only fills bits above it).
"""
from __future__ import annotations

import torch

__all__ = ["WORD", "magnitude_planes", "pack_bits", "unpack_bits",
           "plane_tile_occupancy", "pack_presence", "unpack_presence"]

WORD = 32  # packing word width


def magnitude_planes(q: torch.Tensor, bits: int) -> torch.Tensor:
    """Unsigned magnitude planes ``P[b] = bit b of |q|``: uint8
    ``(bits - 1,) + q.shape`` in {0, 1}."""
    mag = q.to(torch.int32).abs()
    shifts = torch.arange(bits - 1, dtype=torch.int32, device=q.device)
    shifts = shifts.reshape((bits - 1,) + (1,) * q.ndim)
    return ((mag[None] >> shifts) & 1).to(torch.uint8)


def pack_bits(bits01: torch.Tensor, axis: int = 0) -> torch.Tensor:
    """Pack a {0,1} tensor into int32 words (uint32 bits) along ``axis``,
    whose length must be a multiple of 32."""
    axis = axis % bits01.ndim
    n = bits01.shape[axis]
    if n % WORD:
        raise ValueError(f"pack axis length {n} not a multiple of {WORD}")
    x = torch.movedim(bits01.to(torch.int64), axis, -1)
    x = x.reshape(x.shape[:-1] + (n // WORD, WORD))
    shifts = torch.arange(WORD, dtype=torch.int64, device=x.device)
    words = (x << shifts).sum(dim=-1)                 # [0, 2^32)
    words = torch.where(words >= 2 ** 31, words - 2 ** 32, words)
    return torch.movedim(words.to(torch.int32), -1, axis).contiguous()


def unpack_bits(packed: torch.Tensor, axis: int = 0) -> torch.Tensor:
    """Inverse of :func:`pack_bits`: uint8 {0,1} with axis length x32."""
    axis = axis % packed.ndim
    x = torch.movedim(packed.to(torch.int32), axis, -1)
    shifts = torch.arange(WORD, dtype=torch.int32, device=x.device)
    bits01 = ((x[..., None] >> shifts) & 1).to(torch.uint8)
    bits01 = bits01.reshape(x.shape[:-1] + (x.shape[-1] * WORD,))
    return torch.movedim(bits01, -1, axis)


def plane_tile_occupancy(planes: torch.Tensor, k_block: int,
                         n_block: int) -> torch.Tensor:
    """int32 [B, K/k_block, N/n_block]: 1 where the (plane, K-tile, N-tile)
    holds at least one essential bit."""
    b, k, n = planes.shape
    if k % k_block or n % n_block:
        raise ValueError(f"({k},{n}) not divisible by ({k_block},{n_block})")
    t = planes.to(torch.int32).abs().reshape(
        b, k // k_block, k_block, n // n_block, n_block)
    return (t.sum(dim=(2, 4)) > 0).to(torch.int32)


def pack_presence(presence: torch.Tensor) -> torch.Tensor:
    """Bit-pack a {0,1} [B, NK, NN] presence map along its K-tile axis
    (zero-padded to a word multiple): int32 words [B, ceil(NK/32), NN]."""
    nk = presence.shape[1]
    pad = (-nk) % WORD
    if pad:
        presence = torch.nn.functional.pad(presence, (0, 0, 0, pad))
    return pack_bits((presence != 0).to(torch.uint8), axis=1)


def unpack_presence(packed: torch.Tensor, nk: int) -> torch.Tensor:
    """Inverse of :func:`pack_presence`: int32 {0,1} [B, nk, NN]."""
    return unpack_bits(packed, axis=1)[:, :nk].to(torch.int32)
