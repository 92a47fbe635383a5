"""Hand-written CUDA kernels of the port, with their plain PyTorch versions.

``LAUNCHES`` counts, per kernel name, the launches of the CUDA kernel
itself: each wrapper adds one where it launches its kernel and nowhere else
(the plain version, taken for CPU tensors, is not counted).  A run reads it
to show that its path really went through the kernels.
"""
import collections

LAUNCHES: "collections.Counter[str]" = collections.Counter()
