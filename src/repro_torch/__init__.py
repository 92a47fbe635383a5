"""Tetris (weight kneading + SAC) in PyTorch, with hand-written CUDA kernels
for NVIDIA Hopper.

A module-for-module counterpart of the JAX package ``repro``: the same
kneaded weight format (byte for byte), the same schedules and the same
public layouts (NHWC images, ``[K, N]`` weight matrices, ``[B-1, K/32, N]``
packed planes).  It imports ``torch`` and numpy only.

Entry points (``CNNServingEngine``, ``sac_matmul``, ``sac_conv2d``) run on
``cuda`` unless the caller passes ``device="cpu"``; with no device given on
a host without CUDA they raise (see :mod:`repro_torch.device`).
"""
