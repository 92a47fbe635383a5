"""Carry a float checkpoint of the JAX package over to the port.

Only float weights cross: each package kneads them itself, and since
kneading is deterministic both produce the same bytes.
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device


def from_jax_params(np_params: Mapping, device: DeviceLike = None) -> Dict:
    """A CNN checkpoint ``{layer: {"w": [K, N], "b": [N]}}`` of numpy
    arrays (e.g. ``jax.tree.map(np.asarray, params)``) as f32 tensors on
    ``device``, in the same nesting."""
    dev = resolve_device(device)
    return {name: {key: torch.from_numpy(
                np.array(arr, dtype=np.float32, copy=True)).to(dev)
                   for key, arr in layer.items()}
            for name, layer in np_params.items()}
