"""Occupancy-compacted work schedules for the SAC kernel (unsharded).

Per N-tile, a compacted list of the non-empty ``(plane, k_tile)`` work
items, k-major (K-tile ascending, plane ascending within a K-tile).  Ragged
tiles pad to the max work count by repeating their last real item; all-empty
N-tiles carry count 0.  ``build_schedule`` is numpy, as in the JAX package,
so both packages produce the same arrays byte for byte.

Every kneaded array is checksummed (CRC32 of its bytes) at knead time:
kneading is an exact re-encoding, so a flipped bit in a schedule array
changes *which work runs*, and only a byte-level check can notice.
"""
from __future__ import annotations

import dataclasses
import zlib
from typing import TYPE_CHECKING, Optional, Tuple

import numpy as np
import torch

if TYPE_CHECKING:  # kneading imports this module
    from repro_torch.core.kneading import KneadedWeight

__all__ = ["KneadedIntegrityError", "KneadedSchedule", "build_schedule",
           "replay_schedule", "integrity_checksums", "verify_checksums"]


class KneadedIntegrityError(RuntimeError):
    """A kneaded weight's arrays no longer match their knead-time CRC32s."""


def _crc32(x: torch.Tensor) -> int:
    """CRC32 of a tensor's raw bytes (copies to the host)."""
    return zlib.crc32(x.detach().cpu().contiguous().numpy().tobytes())


def _walk(obj, dotted: str):
    for part in dotted.split("."):
        obj = getattr(obj, part)
    return obj


def integrity_checksums(obj, fields: Tuple[str, ...]
                        ) -> Tuple[Tuple[str, int], ...]:
    """Per-field CRC32s over ``obj``'s (possibly dotted) tensor fields."""
    return tuple((name, _crc32(_walk(obj, name))) for name in fields)


def verify_checksums(obj, checksums: Tuple[Tuple[str, int], ...]
                     ) -> Tuple[str, ...]:
    """Names of fields whose current bytes mismatch ``checksums``."""
    return tuple(name for name, want in checksums
                 if _crc32(_walk(obj, name)) != want)


@dataclasses.dataclass(frozen=True)
class KneadedSchedule:
    """Compacted per-N-tile work lists for one kneaded weight.

    Attributes:
      counts:     int32 [N/n_block] real work items per N-tile.
      plane_ids:  int32 [N/n_block, num_work] plane of each item.
      ktile_ids:  int32 [N/n_block, num_work] K-tile of each item.
      num_work:   ``max(1, max(counts))``.
      total_work: ``sum(counts)`` == tile dots the kernel executes per M tile.
      nk, n_tiles: dense extents K/ks and N/n_block.
    """

    counts: torch.Tensor
    plane_ids: torch.Tensor
    ktile_ids: torch.Tensor
    num_work: int = 1
    total_work: int = 0
    nk: int = 0
    n_tiles: int = 0

    def dense_work(self, bits: int) -> int:
        """Items the dense walk would execute: (B-1) * K/ks * N/n_block."""
        return (bits - 1) * self.nk * self.n_tiles

    def metadata_bytes(self) -> int:
        return (self.counts.numel() + self.plane_ids.numel()
                + self.ktile_ids.numel()) * 4


def build_schedule(occupancy_map: torch.Tensor) -> KneadedSchedule:
    """Flatten a {0,1} [B-1, K/ks, N/n_block] occupancy map into a compacted
    k-major schedule, on the map's device (built on the host)."""
    device = occupancy_map.device
    occ = occupancy_map.detach().cpu().numpy() != 0        # [B-1, NK, NN]
    nb, nk, nn = occ.shape
    counts = occ.sum(axis=(0, 1)).astype(np.int32)         # [NN]
    num_work = max(1, int(counts.max(initial=0)))
    plane_ids = np.zeros((nn, num_work), np.int32)
    ktile_ids = np.zeros((nn, num_work), np.int32)
    for j in range(nn):
        # [NK, B-1] nonzero -> row-major: k_tile ascending, plane within
        kt, pb = np.nonzero(occ[:, :, j].T)
        c = kt.size
        if c:
            plane_ids[j, :c], ktile_ids[j, :c] = pb, kt
            plane_ids[j, c:], ktile_ids[j, c:] = pb[-1], kt[-1]
    return KneadedSchedule(
        counts=torch.from_numpy(counts).to(device),
        plane_ids=torch.from_numpy(plane_ids).to(device),
        ktile_ids=torch.from_numpy(ktile_ids).to(device),
        num_work=num_work, total_work=int(counts.sum()), nk=nk, n_tiles=nn)


def replay_schedule(a: torch.Tensor, kw: "KneadedWeight",
                    act_presence: Optional[torch.Tensor] = None
                    ) -> torch.Tensor:
    """Executable spec of the compacted kernel: walk the schedule item by
    item on the host, one f32 tile dot into the item's plane segment, then
    the rear-adder epilogue.  ``act_presence`` ({0,1} [kw.k // kw.ks])
    drops real items whose activation K-tile is absent.

    ``a`` is [M, kw.k] (the stored, padded K).
    """
    from repro_torch.core import bitplanes

    sched = kw.schedule
    mag = bitplanes.unpack_bits(kw.planes, axis=1)             # [B-1, K, N]
    sign = 1 - 2 * bitplanes.unpack_bits(kw.signs, axis=0).to(torch.int8)
    a32 = a.to(torch.float32)
    counts = sched.counts.cpu().tolist()
    plane_ids = sched.plane_ids.cpu().numpy()
    ktile_ids = sched.ktile_ids.cpu().numpy()
    presence = None if act_presence is None else act_presence.cpu().numpy()
    ks, nb = kw.ks, kw.n_block
    m = a32.shape[0]
    weights = (2.0 ** torch.arange(kw.bits - 1, device=a.device)).reshape(
        -1, 1, 1)
    out_tiles = []
    for j in range(sched.n_tiles):
        nsl = slice(j * nb, (j + 1) * nb)
        seg = torch.zeros((kw.bits - 1, m, nb), dtype=torch.float32,
                          device=a.device)
        for w in range(counts[j]):                     # real items only
            b, t = int(plane_ids[j, w]), int(ktile_ids[j, w])
            if presence is not None and not presence[t]:
                continue                               # activation-side skip
            ksl = slice(t * ks, (t + 1) * ks)
            plane = (mag[b, ksl, nsl].to(torch.int8)
                     * sign[ksl, nsl]).to(torch.float32)
            seg[b] = seg[b] + a32[:, ksl] @ plane      # S_b += A_t @ P_bt
        out_tiles.append((seg * weights).sum(dim=0))
    return torch.cat(out_tiles, dim=1) * kw.scale
