"""Tetris core — weight kneading + SAC, in PyTorch.

  quantize / dequantize                      (fixed-point substrate)
  knead / knead_padded / unknead / KneadedWeight   (the kneaded format)
  kneaded_cycles / kneading_ratio            (paper Fig 3 cycle semantics)
  sac_matmul                                 (SAC computing pattern)
"""
from repro_torch.core.kneading import (KneadedWeight, knead, knead_padded,
                                       kneaded_cycles, kneading_ratio,
                                       unknead)
from repro_torch.core.quantization import (QuantizedTensor, dequantize,
                                           quantize, storage_dtype)
from repro_torch.core.sac import (SAC_IMPLS, sac_matmul, sac_matmul_int,
                                  sac_matmul_planes)

__all__ = ["QuantizedTensor", "quantize", "dequantize", "storage_dtype",
           "KneadedWeight", "knead", "knead_padded", "unknead",
           "kneaded_cycles", "kneading_ratio", "SAC_IMPLS", "sac_matmul",
           "sac_matmul_planes", "sac_matmul_int"]
