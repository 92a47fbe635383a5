"""The SAC bit-plane matmul kernel: CUDA wrapper and plain PyTorch version.

``sac_matmul_launch`` is the counterpart of the JAX package's
``sac_matmul_pallas_call``: raw, tile-aligned arrays in, ``[M, N]`` f32 out.
For CUDA tensors it launches ``csrc/sac_matmul.cu`` (built at first use) and
raises if the launch fails; for CPU tensors it runs :func:`sac_matmul_plain`,
the same function in plain PyTorch.  There is no fallback from one to the
other.

Both walk the same compacted schedule under the same survival mask: for
each N tile j and slot w with ``mask[j, w] != 0``, plane ``b =
plane_ids[j, w]`` of K tile ``t = ktile_ids[j, w]`` is unpacked, signed and
multiplied into the f32 segment ``S_b``; the epilogue forms
``(sum_b 2^b S_b) * scale`` once per tile.  They differ only in the order
of f32 sums, so they agree to ``1e-4 + 1e-5 * |plain|``.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.core import bitplanes
from repro_torch.core.activation_occupancy import weight_only_mask
from repro_torch.core.schedule import KneadedSchedule
from repro_torch.kernels import LAUNCHES

WORD = 32
BN = 128                        # the CUDA kernel's N tile
SMEM_LIMIT = 232448             # bytes of shared memory a Hopper CTA can use
_CTA_ROWS = (8, 16, 32)         # M tiles the CUDA kernel is built for

_lib: Optional[ctypes.CDLL] = None


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        from repro_torch.kernels import build
        lib = build.load("sac_matmul")
        lib.sac_matmul_launch.argtypes = [ctypes.c_void_p] * 8 + [
            ctypes.c_int] * 7 + [ctypes.c_void_p]
        lib.sac_matmul_launch.restype = ctypes.c_int
        lib.sac_matmul_error_string.argtypes = [ctypes.c_int]
        lib.sac_matmul_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def cta_tiles(bits: int, ks: int) -> Tuple[int, ...]:
    """The M tiles (of 8/16/32 rows) whose ``(B-1)`` f32 segments,
    activation slice and sign and plane words fit in shared memory.  The
    sum is the one ``smem_bytes`` in ``csrc/sac_matmul.cu`` allocates; a
    tile it did not fit would fail to launch, and the wrapper would raise."""
    def smem(bm):
        return ((bits - 1) * bm * BN + bm * ks) * 4 + 2 * (ks // WORD) * BN * 4
    fits = tuple(bm for bm in _CTA_ROWS if smem(bm) <= SMEM_LIMIT)
    if not fits:
        raise ValueError(f"bits={bits}, ks={ks} leave no M tile that fits "
                         f"in {SMEM_LIMIT} bytes of shared memory")
    return fits


def cta_rows(m: int, n: int, bits: int, ks: int, sms: int) -> int:
    """The CUDA kernel's M tile for an [m, K] x [K, n] launch.

    Of the tiles that fit (:func:`cta_tiles`) and are no taller than ``m``
    rounded up to 8, the tallest that still gives every one of the card's
    ``sms`` SMs a CTA wins (taller tiles reuse each unpacked weight over
    more rows); if none does, the shortest (most CTAs).
    """
    fits = cta_tiles(bits, ks)
    useful = [bm for bm in fits if bm <= max(8, -(-m // 8) * 8)] or fits[:1]
    for bm in reversed(useful):
        if -(-m // bm) * (n // BN) >= sms:
            return bm
    return useful[0]


def _check(a, planes, signs, scale, schedule, mask, bits, bn, bk):
    m, k = a.shape
    n = planes.shape[-1]
    if a.dtype != torch.float32:
        raise TypeError(f"activations must be float32, got {a.dtype}")
    for name, t in (("planes", planes), ("signs", signs),
                    ("plane_ids", schedule.plane_ids),
                    ("ktile_ids", schedule.ktile_ids), ("mask", mask)):
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
    if scale.dtype != torch.float32:
        raise TypeError(f"scale must be float32, got {scale.dtype}")
    if bk % WORD or k % bk or n % bn:
        raise ValueError(f"shapes not tile-aligned: M={m} K={k} N={n} "
                         f"bk={bk} bn={bn}")
    if planes.shape != (bits - 1, k // WORD, n):
        raise ValueError(f"planes {tuple(planes.shape)} != "
                         f"{(bits - 1, k // WORD, n)}")
    if signs.shape != (k // WORD, n) or scale.numel() != n:
        raise ValueError("signs/scale do not match the planes")
    if (schedule.nk, schedule.n_tiles) != (k // bk, n // bn):
        raise ValueError(f"schedule extents {(schedule.nk, schedule.n_tiles)}"
                         f" != {(k // bk, n // bn)}")
    if mask.shape != schedule.plane_ids.shape:
        raise ValueError(f"mask {tuple(mask.shape)} != schedule "
                         f"{tuple(schedule.plane_ids.shape)}")
    devices = {t.device for t in (a, planes, signs, scale, mask,
                                  schedule.plane_ids, schedule.ktile_ids)}
    if len(devices) != 1:
        raise ValueError(f"inputs on several devices: {devices}")


def sac_matmul_launch(a: torch.Tensor, planes: torch.Tensor,
                      signs: torch.Tensor, scale: torch.Tensor,
                      schedule: KneadedSchedule, *, bits: int,
                      bn: int = 128, bk: int = 256,
                      mask: Optional[torch.Tensor] = None,
                      cta_m: Optional[int] = None) -> torch.Tensor:
    """[M, K] f32 x kneaded planes [B-1, K/32, N] -> [M, N] f32.

    Shapes must already be tile-aligned (K % bk == 0, N % bn == 0).
    ``mask`` is the int32 [N/bn, num_work] survival mask; ``None`` is the
    weight-only walk (``w < counts[j]``).  CUDA tensors launch the kernel
    (``bn`` must be 128) with the M tile :func:`cta_rows` picks, or
    ``cta_m`` rows when given (for tile sweeps); CPU tensors run
    :func:`sac_matmul_plain`.
    """
    if mask is None:
        mask = weight_only_mask(schedule.counts, schedule.num_work)
    _check(a, planes, signs, scale, schedule, mask, bits, bn, bk)
    if a.device.type == "cpu":
        return sac_matmul_plain(a, planes, signs, scale, schedule, bits=bits,
                                bn=bn, bk=bk, mask=mask)
    if a.device.type != "cuda":
        raise ValueError(f"no SAC kernel for device {a.device}")
    if bn != BN:
        raise ValueError(f"the CUDA kernel's N tile is {BN}, got bn={bn}")
    m, k = a.shape
    n = planes.shape[-1]
    args = [t.contiguous() for t in (a, planes, signs, scale, mask,
                                     schedule.plane_ids, schedule.ktile_ids)]
    out = torch.empty((m, n), dtype=torch.float32, device=a.device)
    if m == 0:
        return out
    if cta_m is None:
        sms = torch.cuda.get_device_properties(a.device).multi_processor_count
        cta_m = cta_rows(m, n, bits, bk, sms)
    elif cta_m not in cta_tiles(bits, bk):
        raise ValueError(f"cta_m must be one of {cta_tiles(bits, bk)}, "
                         f"got {cta_m}")
    lib = _library()
    stream = torch.cuda.current_stream(a.device).cuda_stream
    with torch.cuda.device(a.device):
        err = lib.sac_matmul_launch(
            *(t.data_ptr() for t in args), out.data_ptr(), m, k, n, bits, bk,
            schedule.num_work, cta_m, stream)
    if err:
        raise RuntimeError("sac_matmul kernel launch failed: "
                           + lib.sac_matmul_error_string(err).decode())
    LAUNCHES["sac_matmul"] += 1
    return out


def sac_matmul_plain(a: torch.Tensor, planes: torch.Tensor,
                     signs: torch.Tensor, scale: torch.Tensor,
                     schedule: KneadedSchedule, *, bits: int, bn: int = 128,
                     bk: int = 256, mask: Optional[torch.Tensor] = None
                     ) -> torch.Tensor:
    """The kernel's function in plain PyTorch, on any device: walk the
    schedule slots the mask keeps, with per-plane f32 segments, the sign
    multiplier cached per K tile, and one epilogue per N tile."""
    if mask is None:
        mask = weight_only_mask(schedule.counts, schedule.num_work)
    m = a.shape[0]
    n = planes.shape[-1]
    wk = bk // WORD
    mask_h = mask.cpu().tolist()               # host-side control flow
    pids = schedule.plane_ids.cpu().tolist()
    kids = schedule.ktile_ids.cpu().tolist()
    a32 = a.to(torch.float32)
    out = torch.empty((m, n), dtype=torch.float32, device=a.device)
    for j in range(n // bn):
        nsl = slice(j * bn, (j + 1) * bn)
        seg = torch.zeros((bits - 1, m, bn), dtype=torch.float32,
                          device=a.device)
        cached_kt, signf = -1, None
        for w, alive in enumerate(mask_h[j]):
            if not alive:
                continue
            b, kt = pids[j][w], kids[j][w]
            if kt != cached_kt:                # k-major: reuse per K tile
                sbits = bitplanes.unpack_bits(
                    signs[kt * wk:(kt + 1) * wk, nsl], axis=0)
                signf = 1.0 - 2.0 * sbits.to(torch.float32)
                cached_kt = kt
            plane = bitplanes.unpack_bits(
                planes[b, kt * wk:(kt + 1) * wk, nsl], axis=0)
            seg[b] += a32[:, kt * bk:(kt + 1) * bk] @ (
                plane.to(torch.float32) * signf)
        total = seg[0].clone()
        for b in range(1, bits - 1):           # rear adder tree
            total += seg[b] * float(2 ** b)
        out[:, nsl] = total * scale.reshape(1, -1)[:, nsl]
    return out
