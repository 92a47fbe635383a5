"""Weight kneading — the paper's core contribution, in two forms.

1. The cycle model (:func:`kneaded_cycles`): within a group of ``ks``
   weights along a reduction lane, essential bits bubble up per bit column,
   so the group costs ``max_b popcount_b(group)`` cycles instead of ``ks``.
2. The kneaded format (:class:`KneadedWeight` / :func:`knead`): packed
   sign-magnitude bit planes plus per-(plane, tile) occupancy compacted into
   a :class:`~repro_torch.core.schedule.KneadedSchedule`.  Every array is
   byte-identical to the JAX package's for the same float weight, so a
   weight kneaded by either package has the same CRC32s.

Kneading is exact: ``unknead(knead(w)) == dequantize(quantize(w))``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch

from repro_torch.core import bitplanes
from repro_torch.core.quantization import QuantizedTensor, quantize
from repro_torch.core.schedule import (KneadedIntegrityError,
                                       KneadedSchedule, build_schedule,
                                       integrity_checksums, verify_checksums)

__all__ = ["KneadedIntegrityError", "KneadedWeight", "knead",
           "knead_padded", "kneadable_dims", "kneaded_codes", "unknead",
           "kneaded_cycles", "kneading_ratio"]


# ---------------------------------------------------------------------------
# 1. The kneading cycle model (Fig 3 semantics)
# ---------------------------------------------------------------------------

def kneaded_cycles(q: torch.Tensor, bits: int, ks: int) -> torch.Tensor:
    """int [K // ks, ...]: cycles of each KS-group of a weight lane after
    kneading, ``max_b popcount_b(group)``.  ``q`` is laid out [K, ...]."""
    k = q.shape[0]
    if k % ks:
        raise ValueError(f"lane length {k} not divisible by ks={ks}")
    planes = bitplanes.magnitude_planes(q, bits)          # [B-1, K, ...]
    g = planes.reshape((planes.shape[0], k // ks, ks) + tuple(planes.shape[2:]))
    return g.to(torch.int32).sum(dim=2).amax(dim=0)       # [K/ks, ...]


def kneading_ratio(q: torch.Tensor, bits: int, ks: int) -> torch.Tensor:
    """T_ks / T_base of Fig 11: kneaded cycles over un-kneaded cycles."""
    cyc = kneaded_cycles(q, bits, ks)
    return cyc.sum() / (cyc.numel() * ks)


# ---------------------------------------------------------------------------
# 2. The kneaded-weight format
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class KneadedWeight:
    """A [K, N] weight matrix in kneaded (packed bit-plane) form.

    Attributes:
      planes:    int32 [B-1, K/32, N] magnitude planes (uint32 bits).
      signs:     int32 [K/32, N] sign bits (1 = negative).
      scale:     f32 [1, N] per-output-channel scale.
      occupancy: int32 [B-1, ceil(K/ks/32), N/n_block] packed presence bits.
      schedule:  the compacted per-N-tile work lists the kernel walks.
      bits, ks, n_block: width B, kneading stride (= kernel K tile), N tile.
      k, n:      stored (tile-aligned) dims.
      k_orig, n_orig: logical dims before alignment padding (0 = same).
      checksums: knead-time per-field CRC32s (``()`` = unchecked).
    """

    planes: torch.Tensor
    signs: torch.Tensor
    scale: torch.Tensor
    occupancy: torch.Tensor
    schedule: KneadedSchedule
    bits: int = 8
    ks: int = 256
    n_block: int = 128
    k: int = 0
    n: int = 0
    k_orig: int = 0
    n_orig: int = 0
    checksums: Tuple[Tuple[str, int], ...] = ()

    _INTEGRITY_FIELDS = ("planes", "signs", "scale", "occupancy",
                         "schedule.counts", "schedule.plane_ids",
                         "schedule.ktile_ids")

    @property
    def shape(self):
        return (self.k, self.n)

    @property
    def device(self) -> torch.device:
        return self.planes.device

    @property
    def logical_k(self) -> int:
        return self.k_orig or self.k

    @property
    def logical_n(self) -> int:
        return self.n_orig or self.n

    def with_checksums(self) -> "KneadedWeight":
        """Stamp knead-time CRC32s over every array field."""
        return dataclasses.replace(
            self, checksums=integrity_checksums(self, self._INTEGRITY_FIELDS))

    def verify(self, strict: bool = False) -> Tuple[str, ...]:
        """Names of array fields whose bytes changed since knead time;
        ``strict`` raises :class:`KneadedIntegrityError` instead."""
        bad = verify_checksums(self, self.checksums)
        if bad and strict:
            raise KneadedIntegrityError(
                f"kneaded weight [{self.logical_k}x{self.logical_n}] "
                f"corrupt in: {', '.join(bad)}")
        return bad

    def occupancy_map(self) -> torch.Tensor:
        """Unpacked presence map, int32 {0,1} [B-1, K/ks, N/n_block]."""
        return bitplanes.unpack_presence(self.occupancy, self.k // self.ks)

    def with_occupancy(self, occupancy_map: torch.Tensor) -> "KneadedWeight":
        """Replace the occupancy map, re-deriving the packed bits and the
        schedule (the kernel executes the schedule), and re-stamp CRCs."""
        return dataclasses.replace(
            self, occupancy=bitplanes.pack_presence(occupancy_map),
            schedule=build_schedule(occupancy_map)).with_checksums()

    def metadata_bytes(self) -> int:
        """Packed presence bits plus the compacted schedule arrays."""
        return self.occupancy.numel() * 4 + self.schedule.metadata_bytes()

    def packed_bytes(self) -> int:
        """Device bytes of the kneaded format: planes, signs, scale and
        metadata."""
        return ((self.planes.numel() + self.signs.numel()
                 + self.scale.numel()) * 4 + self.metadata_bytes())

    def dense_bf16_bytes(self) -> int:
        return self.k * self.n * 2


def kneadable_dims(k: int, n: int, ks: int = 256,
                   n_block: int = 128) -> Tuple[int, int]:
    """Smallest (K', N') >= (k, n) with K' a multiple of lcm(32, ks) and N'
    a multiple of n_block."""
    k_align = math.lcm(32, ks)
    return (-(-k // k_align) * k_align, -(-n // n_block) * n_block)


def knead(w: torch.Tensor, bits: int = 8, ks: int = 256, n_block: int = 128,
          *, qt: Optional[QuantizedTensor] = None) -> KneadedWeight:
    """Quantize (unless ``qt`` given) and knead a tile-aligned [K, N] weight
    on its own device.  Use :func:`knead_padded` for arbitrary dims."""
    if qt is None:
        qt = quantize(w, bits=bits, axis=-1)
    q = qt.q
    if q.ndim != 2:
        raise ValueError(f"knead expects [K, N], got {tuple(q.shape)}")
    k, n = q.shape
    if (k, n) != kneadable_dims(k, n, ks, n_block):
        raise ValueError(f"shape {tuple(q.shape)} incompatible with "
                         f"ks={ks}, n_block={n_block}")
    mag = bitplanes.magnitude_planes(q, qt.bits)                # [B-1, K, N]
    occ_map = bitplanes.plane_tile_occupancy(mag, ks, n_block)
    scale = qt.scale.reshape(1, -1) if qt.scale.ndim else qt.scale
    return KneadedWeight(
        planes=bitplanes.pack_bits(mag, axis=1),                # [B-1, K/32, N]
        signs=bitplanes.pack_bits((q < 0).to(torch.uint8), axis=0),
        scale=scale.to(torch.float32).contiguous(),
        occupancy=bitplanes.pack_presence(occ_map),
        schedule=build_schedule(occ_map),
        bits=qt.bits, ks=ks, n_block=n_block, k=k, n=n,
    ).with_checksums()


def knead_padded(w: torch.Tensor, bits: int = 8, ks: int = 256,
                 n_block: int = 128) -> KneadedWeight:
    """Knead an arbitrary [K, N] matrix by zero-padding it to alignment.

    Padded rows meet zero-padded activations and padded channels get scale
    1.0 and codes 0, so the padding is exact; its planes are all zero and
    the schedule never dispatches them.
    """
    if w.ndim != 2:
        raise ValueError(f"knead_padded expects [K, N], got {tuple(w.shape)}")
    k0, n0 = w.shape
    kp, np_ = kneadable_dims(k0, n0, ks, n_block)
    if (kp, np_) == (k0, n0):
        return knead(w, bits=bits, ks=ks, n_block=n_block)
    w = torch.nn.functional.pad(w, (0, np_ - n0, 0, kp - k0))
    kw = knead(w, bits=bits, ks=ks, n_block=n_block)
    return dataclasses.replace(kw, k_orig=k0, n_orig=n0)


def kneaded_codes(kw: KneadedWeight) -> torch.Tensor:
    """Signed int32 codes [K, N] reconstructed from the packed planes."""
    mag = bitplanes.unpack_bits(kw.planes, axis=1).to(torch.int32)
    weights = (2 ** torch.arange(kw.bits - 1, dtype=torch.int32,
                                 device=mag.device)).reshape(-1, 1, 1)
    absq = (mag * weights).sum(dim=0, dtype=torch.int32)       # [K, N]
    sign = 1 - 2 * bitplanes.unpack_bits(kw.signs, axis=0).to(torch.int32)
    return absq * sign


def unknead(kw: KneadedWeight) -> torch.Tensor:
    """Exact float reconstruction: equals dequantize(quantize(w))."""
    return kneaded_codes(kw).to(torch.float32) * kw.scale
