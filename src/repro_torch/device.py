"""Device policy shared by every entry point of the port.

Entry points run on ``cuda`` unless the caller asks for the CPU.  Without
CUDA and without an explicit device they raise rather than quietly run on
the CPU: a CPU result must never pass for a GPU one.

TF32 is switched off for CUDA devices: the float CNN path is im2col plus an
f32 matmul, and the parity bars (``1e-4 + 1e-5 * |ref|``) assume full f32
products.  TF32 keeps ~10 mantissa bits and would break them.
"""
from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """The device an entry point runs on: ``device``, else ``cuda``.

    A bare ``cuda`` resolves to the current card's index, so the result
    compares equal to the ``.device`` of tensors placed there.  Raises
    ``RuntimeError`` when no device is given and CUDA is absent.
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run the plain "
                "PyTorch versions on the CPU")
        device = "cuda"
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev
