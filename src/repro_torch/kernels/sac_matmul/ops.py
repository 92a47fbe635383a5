"""Public wrappers around the SAC kernel: padding policy, im2col, conv.

``sac_matmul_kernel``: [M, K] x kneaded [K, N] through the kernel
(:mod:`~repro_torch.kernels.sac_matmul.kernel`) — one launch per call.
Accepts activations sized to the stored or the logical K and zero-pads;
rounds M up to :func:`m_block` (zero rows, exact), the padding policy the
planes oracle replays.

``sac_conv2d``: im2col plus one SAC matmul over the whole
``[B*H'*W', K]`` patch matrix — one kernel launch per conv layer.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.core import activation_occupancy
from repro_torch.core.kneading import KneadedWeight
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels.sac_matmul.kernel import sac_matmul_launch


STREAM_BLOCK = 256   # the JAX kernel's streamed M block


def m_block(m: int) -> int:
    """Effective M block of an M-row call: M rounded up to 8 rows, capped
    at the streamed block (the decode/GEMV regime pads one row to 8, not to
    256).  The padding policy only: the CUDA kernel picks its own M tile."""
    return min(STREAM_BLOCK, max(8, -(-m // 8) * 8))


def _pad_activations(a: torch.Tensor, kw: KneadedWeight):
    """Zero-pad logical-K activations to the stored K and round M up to a
    multiple of ``m_block(M)``.  Returns (padded a, M, block)."""
    m, k = a.shape
    if k != kw.k:
        if k != kw.logical_k:
            raise ValueError(f"activation K {k} matches neither stored "
                             f"{kw.k} nor logical {kw.logical_k}")
        a = F.pad(a, (0, kw.k - k))
    bm_eff = m_block(m)
    pad = (-m) % bm_eff
    if pad:
        a = F.pad(a, (0, 0, 0, pad))
    return a, m, bm_eff


def sac_matmul_kernel(a: torch.Tensor, kw: KneadedWeight, *,
                      skip_activations: bool = False) -> torch.Tensor:
    """[M, K] @ kneaded [K, N] -> [M, N] f32 (stored N) through the SAC
    kernel, on the device of ``a`` and ``kw``.

    ``skip_activations`` intersects per-K-tile activation presence into the
    kernel's survival mask (at any M; ``core.sac.sac_matmul`` gates it to
    the GEMV regime).  Bit-exact against the unskipped walk.
    """
    a, m, _ = _pad_activations(a.to(torch.float32), kw)
    sched = kw.schedule
    if skip_activations:
        presence = activation_occupancy.ktile_presence(a, kw.ks)
        mask = activation_occupancy.work_mask(sched.counts, sched.ktile_ids,
                                              presence)
        activation_occupancy.record_skip(mask, sched.counts)
    else:
        mask = activation_occupancy.weight_only_mask(sched.counts,
                                                     sched.num_work)
    out = sac_matmul_launch(a.contiguous(), kw.planes, kw.signs, kw.scale,
                            sched, bits=kw.bits, bn=kw.n_block, bk=kw.ks,
                            mask=mask)
    return out[:m]


def _same_pads(size: int, k: int, stride: int):
    """XLA's SAME padding: ``out = ceil(size / stride)``, the total split
    with the smaller half first (``lo = total // 2``)."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def im2col(x: torch.Tensor, k: int, stride: int) -> torch.Tensor:
    """x [B, H, W, C] -> patches [B, H', W', C*k*k] with SAME padding.

    Feature order is C-major (``[C, kh, kw]``), the order of
    ``lax.conv_general_dilated_patches`` — the JAX package's ``[C*k*k, N]``
    conv weight matrices are laid out for it.  ``F.unfold`` on the NCHW
    view produces the same order.
    """
    b, h, w, c = x.shape
    ph, pw = _same_pads(h, k, stride), _same_pads(w, k, stride)
    xn = F.pad(x.permute(0, 3, 1, 2), (pw[0], pw[1], ph[0], ph[1]))
    cols = F.unfold(xn, kernel_size=k, stride=stride)   # [B, C*k*k, H'*W']
    ho, wo = -(-h // stride), -(-w // stride)
    return cols.transpose(1, 2).reshape(b, ho, wo, c * k * k)


def sac_conv2d(x: torch.Tensor, kw: KneadedWeight, *, ksize: int,
               stride: int = 1, bias: Optional[torch.Tensor] = None,
               impl: str = "kernel",
               device: DeviceLike = None) -> torch.Tensor:
    """2-D convolution as im2col + SAC matmul against a kneaded filter.

    ``kw`` is the kneaded [C*k*k, out_ch] im2col matrix (``knead_padded``).
    ``impl="kernel"`` sends the whole patch matrix through one kernel
    launch; "planes"/"int"/"float" take the plain SAC paths of
    ``core.sac``.  Runs on ``device`` (default ``cuda``; raises without
    CUDA unless ``device="cpu"``).  Returns [B, H', W', out_ch] f32.
    """
    dev = resolve_device(device)
    if kw.device != dev:
        raise ValueError(f"kneaded weight on {kw.device}, expected {dev}")
    patches = im2col(x.to(dev, torch.float32), ksize, stride)
    lead = patches.shape[:-1]
    a = patches.reshape(-1, patches.shape[-1])
    if a.shape[1] not in (kw.k, kw.logical_k):
        raise ValueError(f"patch K {a.shape[1]} does not match kneaded "
                         f"weight (stored {kw.k}, logical {kw.logical_k})")
    if impl == "kernel":
        out = sac_matmul_kernel(a, kw)[:, :kw.logical_n]
    else:
        from repro_torch.core.sac import sac_matmul
        out = sac_matmul(a, kw, impl=impl, device=dev)
    out = out.reshape(lead + (kw.logical_n,))
    return out + bias if bias is not None else out
