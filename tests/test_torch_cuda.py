"""The port's CUDA kernel on the card: against its plain PyTorch version,
and on the serving path.  Marked ``cuda``; without a card every test skips.

Run on a machine with an NVIDIA Hopper GPU and ``nvcc``:
``PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py``.
The bar is ``tests/parity.py``'s (rtol 1e-5, atol 1e-4): plane entries are
in {-1, 0, 1}, so only the order of the f32 sums differs.
"""
import numpy as np
import pytest
import torch

from repro_torch.core.kneading import knead_padded
from repro_torch.inference.cnn_engine import (CNNServingConfig,
                                              CNNServingEngine)
from repro_torch.kernels import LAUNCHES
from repro_torch.kernels.sac_matmul import kernel, ops
from repro_torch.models import cnn

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.mark.parametrize("m,k,n,bits,ks", [(24, 512, 128, 8, 256),
                                           (1, 4800, 192, 4, 512),
                                           (40, 1024, 256, 16, 256)])
def test_kernel_matches_plain_on_card(dev, m, k, n, bits, ks):
    rng = np.random.default_rng(m + k)
    w = rng.standard_normal((k, n)).astype(np.float32) * 0.05
    kw = knead_padded(torch.from_numpy(w).to(dev), bits=bits, ks=ks)
    a = torch.from_numpy(rng.standard_normal((m, k)).astype(
        np.float32)).to(dev)
    a_p, _, _ = ops._pad_activations(a, kw)
    args = (a_p, kw.planes, kw.signs, kw.scale, kw.schedule)
    got = kernel.sac_matmul_launch(*args, bits=bits, bk=ks)
    want = kernel.sac_matmul_plain(*args, bits=bits, bk=ks)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)


def test_engine_launches_once_per_layer(dev):
    cfg = cnn.CNN_ZOO["alexnet"]
    params = cnn.init(cfg, torch.Generator().manual_seed(0), device=dev)
    eng = CNNServingEngine(cfg, params, CNNServingConfig(impl="kernel"),
                           device=dev)
    planes = CNNServingEngine(cfg, params, CNNServingConfig(impl="planes"),
                              device=dev)
    x = torch.randn(2, 32, 32, 3, generator=torch.Generator().manual_seed(1))
    LAUNCHES.clear()
    got = eng.logits(x)
    assert LAUNCHES["sac_matmul"] == len(params)
    torch.testing.assert_close(got, planes.logits(x), rtol=1e-5, atol=1e-4)
