"""CNNs from the paper's evaluation set (AlexNet / VGG-16 / NiN style).

Convolution is im2col -> matmul, so every conv layer is a
``[K = C*kh*kw, N = out_ch]`` weight matrix — the form kneading consumes.
``knead_params`` kneads every conv/fc matrix and ``apply`` routes each
layer's matmul through the chosen SAC path (``impl``).  Images are NHWC.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.kneading import KneadedWeight, knead_padded
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels.sac_matmul.ops import im2col, sac_conv2d
from repro_torch.models import layers as L

# spec entries: ("conv", out_ch, k, stride) | ("pool", k) | ("fc", out)
CNNSpec = Sequence[Tuple]


@dataclasses.dataclass(frozen=True)
class CNNConfig:
    name: str
    spec: CNNSpec
    in_channels: int = 3
    image_size: int = 32
    num_classes: int = 100


ALEXNET = CNNConfig("alexnet", (
    ("conv", 64, 3, 1), ("pool", 2),
    ("conv", 192, 3, 1), ("pool", 2),
    ("conv", 384, 3, 1), ("conv", 256, 3, 1), ("conv", 256, 3, 1),
    ("pool", 2),
    ("fc", 1024), ("fc", 1024), ("fc", 100),
))

VGG16 = CNNConfig("vgg16", (
    ("conv", 64, 3, 1), ("conv", 64, 3, 1), ("pool", 2),
    ("conv", 128, 3, 1), ("conv", 128, 3, 1), ("pool", 2),
    ("conv", 256, 3, 1), ("conv", 256, 3, 1), ("conv", 256, 3, 1), ("pool", 2),
    ("conv", 512, 3, 1), ("conv", 512, 3, 1), ("conv", 512, 3, 1), ("pool", 2),
    ("conv", 512, 3, 1), ("conv", 512, 3, 1), ("conv", 512, 3, 1), ("pool", 2),
    ("fc", 1024), ("fc", 1024), ("fc", 100),
))

NIN = CNNConfig("nin", (
    ("conv", 192, 5, 1), ("conv", 160, 1, 1), ("conv", 96, 1, 1), ("pool", 2),
    ("conv", 192, 5, 1), ("conv", 192, 1, 1), ("conv", 192, 1, 1), ("pool", 2),
    ("conv", 192, 3, 1), ("conv", 192, 1, 1), ("conv", 100, 1, 1),
))

CNN_ZOO = {c.name: c for c in (ALEXNET, VGG16, NIN)}


def _dense_init(gen: torch.Generator, d_in: int, d_out: int,
                scale: float) -> torch.Tensor:
    w = torch.empty((d_in, d_out), dtype=torch.float32)
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return w * scale


def init(cfg: CNNConfig, generator: torch.Generator,
         device: DeviceLike = None) -> Dict:
    """He-scaled truncated-normal weights and zero biases, drawn on the host
    from ``generator`` (a CPU ``torch.Generator``) and placed on ``device``.
    """
    dev = resolve_device(device)
    params: Dict = {}
    c, size, flat = cfg.in_channels, cfg.image_size, None
    for i, item in enumerate(cfg.spec):
        kind = item[0]
        if kind == "conv":
            _, out_c, k, stride = item
            d_in = c * k * k
            params[f"conv{i}"] = {
                "w": _dense_init(generator, d_in, out_c,
                                 float(np.sqrt(2.0 / d_in))).to(dev),
                "b": torch.zeros((out_c,), dtype=torch.float32, device=dev)}
            c = out_c
            size //= stride
        elif kind == "pool":
            size //= item[1]
        elif kind == "fc":
            _, out = item
            d_in = flat if flat is not None else c * size * size
            params[f"fc{i}"] = {
                "w": _dense_init(generator, d_in, out,
                                 float(np.sqrt(2.0 / d_in))).to(dev),
                "b": torch.zeros((out,), dtype=torch.float32, device=dev)}
            flat = out
    return params


def _max_pool(x: torch.Tensor, k: int) -> torch.Tensor:
    """VALID k x k max pool with stride k on NHWC."""
    b, h, w, c = x.shape
    ho, wo = h // k, w // k
    x = x[:, :ho * k, :wo * k].reshape(b, ho, k, wo, k, c)
    return x.amax(dim=(2, 4))


def apply(params: Dict, x: torch.Tensor, cfg: CNNConfig, impl: str = "float",
          collect_activations: bool = False):
    """x [B, H, W, C] -> logits [B, classes] on x's device.

    Kneaded conv layers go through ``sac_conv2d`` (one kernel launch per
    layer for ``impl="kernel"``); float layers run im2col + f32 matmul.
    ``collect_activations`` also returns each layer's [M, K] matmul input.
    """
    acts: Dict[str, torch.Tensor] = {}
    x = x.to(torch.float32)
    flat = False
    for i, item in enumerate(cfg.spec):
        kind = item[0]
        if kind == "conv":
            _, _, k, stride = item
            p = params[f"conv{i}"]
            if collect_activations:
                patches = im2col(x, k, stride)
                acts[f"conv{i}"] = patches.reshape(-1, patches.shape[-1])
            if isinstance(p["w"], KneadedWeight):
                x = sac_conv2d(x, p["w"], ksize=k, stride=stride,
                               bias=p["b"], impl=impl, device=x.device)
            else:
                x = L.matmul_any(im2col(x, k, stride), p["w"],
                                 impl=impl) + p["b"]
            x = torch.relu(x)
        elif kind == "pool":
            x = _max_pool(x, item[1])
        elif kind == "fc":
            if not flat:
                x = x.reshape(x.shape[0], -1)
                flat = True
            if collect_activations:
                acts[f"fc{i}"] = x
            p = params[f"fc{i}"]
            x = L.matmul_any(x, p["w"], impl=impl) + p["b"]
            if i != len(cfg.spec) - 1:
                x = torch.relu(x)
    if x.ndim == 4:                 # NiN: global average pooling head
        x = x.mean(dim=(1, 2))
    return (x, acts) if collect_activations else x


def knead_params(params: Dict, bits: int = 8, ks: int = 256,
                 n_block: int = 128) -> Dict:
    """Knead every conv/fc matrix (``knead_padded``: conv im2col matrices
    are rarely tile-aligned) on its own device; biases stay float."""
    return {name: {"w": knead_padded(p["w"], bits=bits, ks=ks,
                                     n_block=n_block),
                   "b": p["b"]}
            for name, p in params.items()}


def weight_matrices(params: Dict) -> Dict[str, torch.Tensor]:
    """Every layer as its [K, N] matmul matrix (the kneading target)."""
    return {name: p["w"] for name, p in params.items()}
