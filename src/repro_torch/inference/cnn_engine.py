"""CNN serving engine — the paper's own workload, served fully kneaded.

``CNNServingEngine`` takes a float checkpoint of an AlexNet/VGG-16/NiN-style
model, kneads every conv/fc layer (conv layers via their im2col
``[C*kh*kw, out_ch]`` matrices, zero-padded to tile alignment) on its
device, and runs the forward pass through the selected SAC path:

  impl="float"   — the float weights, im2col + f32 matmul (the baseline)
  impl="int"     — one f32 matmul against the dequantized codes
  impl="planes"  — paper-faithful per-plane SAC (the kernel's oracle)
  impl="kernel"  — the hand-written CUDA SAC kernel, one launch per layer
                   (its plain PyTorch version on the CPU)

``submit()``/``drain()`` serve single-image requests in padding-bucket
micro-batches, with per-request latency recorded (``latency_stats``).

Float products are full f32: TF32 is switched off for CUDA devices
(``torch.backends.cuda.matmul.allow_tf32 = False``, see
:mod:`repro_torch.device`), and convolutions are im2col + matmul, never
``F.conv2d``, whose cuDNN path defaults to TF32.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Tuple

import torch

from repro_torch.core.kneading import (KneadedWeight, kneaded_codes,
                                       kneading_ratio)
from repro_torch.core.quantization import quantize
from repro_torch.core.sac import SAC_IMPLS
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.inference import frontend as fe
from repro_torch.models import cnn


@dataclasses.dataclass(frozen=True)
class CNNServingConfig:
    impl: str = "int"          # "float" | "int" | "planes" | "kernel"
    bits: int = 8              # kneaded fixed-point width
    ks: int = 256              # kneading stride == kernel K tile
    n_block: int = 128         # kernel N tile (occupancy granularity)
    # Keep the float checkpoint after kneading so layer_report() can
    # re-quantize cheaply; without it the codes are rebuilt from the planes.
    keep_float_params: bool = True
    # Micro-batch padding buckets for submit()/drain(), ascending.
    buckets: Tuple[int, ...] = (1, 2, 4, 8)
    # Per-request log entries kept for latency_stats() (sliding window).
    stats_window: int = 4096


class CNNServingEngine(fe.RequestFrontEnd):
    """Classify NHWC images through a fully kneaded CNN forward pass.

    Runs on ``device`` (default ``cuda``; raises without CUDA unless
    ``device="cpu"``).  ``params`` is a float checkpoint
    ``{layer: {"w": [K, N], "b": [N]}}`` (see ``convert.from_jax_params``).
    """

    def __init__(self, cfg: cnn.CNNConfig, params: Dict,
                 scfg: CNNServingConfig = CNNServingConfig(), *,
                 device: DeviceLike = None):
        if scfg.impl not in SAC_IMPLS:
            raise ValueError(f"impl must be one of {SAC_IMPLS}, "
                             f"got {scfg.impl!r}")
        fe.validate_buckets(scfg.buckets)
        self.device = resolve_device(device)
        self.cfg, self.scfg = cfg, scfg
        params = {name: {k: v.to(self.device, torch.float32)
                         for k, v in p.items()}
                  for name, p in params.items()}
        if scfg.impl == "float":
            self.params = params
            self.float_params = params
        else:
            self.params = cnn.knead_params(params, bits=scfg.bits,
                                           ks=scfg.ks, n_block=scfg.n_block)
            self.float_params = params if scfg.keep_float_params else None
        self._init_front_end(scfg.stats_window)

    @torch.inference_mode()
    def logits(self, x) -> torch.Tensor:
        """x [B, H, W, C] -> logits [B, num_classes] on the engine's device."""
        x = torch.as_tensor(x, dtype=torch.float32).to(self.device)
        return cnn.apply(self.params, x, self.cfg, impl=self.scfg.impl)

    def classify(self, x) -> torch.Tensor:
        """x [B, H, W, C] -> predicted class ids [B] int32."""
        return self.logits(x).argmax(dim=-1).to(torch.int32)

    # ------------------------------------------------- batched request front end

    def submit(self, x) -> fe.RequestHandle:
        """Queue one single-image request [H, W, C]; the shape is checked
        against the model config here, not deep inside the forward."""
        x = torch.as_tensor(x, dtype=torch.float32)
        want = (self.cfg.image_size, self.cfg.image_size,
                self.cfg.in_channels)
        if tuple(x.shape) != want:
            raise ValueError(f"submit takes one image {want} [H, W, C], "
                             f"got shape {tuple(x.shape)}")
        return self._new_request(x)

    def drain(self) -> Dict[int, torch.Tensor]:
        """Serve every pending request; returns {request_id: logits}.

        Requests split into chunks of at most ``max(buckets)`` images; each
        chunk is stacked and zero-padded up to the smallest bucket that
        fits (padded rows ride the kernel's M dimension and are sliced off).
        """
        buckets = self.scfg.buckets
        results: Dict[int, torch.Tensor] = {}
        while self._pending:
            chunk = self._pending[:buckets[-1]]
            self._pending = self._pending[buckets[-1]:]
            b = len(chunk)
            bucket = next(bk for bk in buckets if bk >= b)
            start, start_tick = time.perf_counter(), self.ticks
            for req in chunk:
                req.state = fe.RUNNING
            xb = torch.stack([r.payload for r in chunk]).to(self.device)
            if bucket > b:
                xb = torch.nn.functional.pad(
                    xb, (0, 0, 0, 0, 0, 0, 0, bucket - b))
            self.ticks += 1                     # one forward launch
            out = self.logits(xb)[:b]
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            done = time.perf_counter()
            for i, req in enumerate(chunk):
                req.state = fe.DONE
                req.result = out[i]
                req.admit_t, req.finish_t = start, done
                req.admit_tick, req.finish_tick = start_tick, self.ticks
                results[req.id] = req.result
                self._log_request(
                    id=req.id,
                    latency_ms=(done - req.submit_t) * 1e3,
                    queue_wait_ms=(start - req.submit_t) * 1e3,
                    decode_ms=(done - start) * 1e3,
                    latency_ticks=self.ticks - req.submit_tick,
                    bucket=bucket,
                    batch_fill=b / bucket,
                )
        return results

    # ------------------------------------------------------------- reporting

    def serving_bytes(self) -> int:
        """Device bytes of the serving params (kneaded packed, or floats
        counted as bf16 as in the JAX package)."""
        total = 0
        for p in self.params.values():
            for leaf in p.values():
                if isinstance(leaf, KneadedWeight):
                    total += leaf.packed_bytes()
                else:
                    total += leaf.numel() * 2
        return total

    def _layer_codes(self, name: str, kw: KneadedWeight) -> torch.Tensor:
        """Integer codes of one layer: re-quantized from the float
        checkpoint when kept, else rebuilt exactly from the planes."""
        if self.float_params is not None:
            return quantize(self.float_params[name]["w"], bits=kw.bits,
                            axis=-1).q
        return kneaded_codes(kw)[:kw.logical_k, :kw.logical_n]

    def layer_report(self, cycle_ks: int = 16) -> List[Dict[str, Any]]:
        """Per-layer kneaded footprint and cycle statistics.

        ``cycle_ks`` is the hardware kneading stride of the cycle model,
        independent of the format stride ``scfg.ks``.
        """
        if self.scfg.impl == "float":
            raise ValueError("layer_report needs kneaded params "
                             "(impl != 'float')")
        rows = []
        for name, p in self.params.items():
            kw: KneadedWeight = p["w"]
            q = self._layer_codes(name, kw)
            k = (q.shape[0] // cycle_ks) * cycle_ks
            rows.append({
                "layer": name,
                "shape": (kw.logical_k, kw.logical_n),
                "bytes_vs_bf16": kw.packed_bytes() / kw.dense_bf16_bytes(),
                "executed_tile_dots": kw.schedule.total_work,
                "dense_tile_dots": kw.schedule.dense_work(kw.bits),
                "cycle_ratio": float(kneading_ratio(q[:k], kw.bits,
                                                    cycle_ks)),
            })
        return rows
