"""The port's kneaded CNN serving slice against the JAX package.

The reference's float checkpoint crosses through ``convert.from_jax_params``
and each package kneads it itself.  The port's ``kernel`` logits (the
kernel's plain PyTorch version on the CPU) must match JAX's ``planes``
logits to the ``tests/parity.py`` bar (rtol 1e-5, atol 1e-4) with the same
argmax on every row; ``layer_report()`` rows must be equal.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.inference.cnn_engine import CNNServingConfig as JConfig
from repro.inference.cnn_engine import CNNServingEngine as JEngine
from repro.models import cnn as jcnn
from repro_torch.convert import from_jax_params
from repro_torch.inference.cnn_engine import (CNNServingConfig,
                                              CNNServingEngine)
from repro_torch.models import cnn
from test_torch_sac import to_jax

RTOL, ATOL = 1e-5, 1e-4


# conv 27 -> 64 and 576 -> 96 and fc 1536 -> 100: every dim padded, three
# weight shapes where AlexNet has seven (each costs the JAX package's
# layer_report a quantize compile)
TINY_SPEC = (("conv", 64, 3, 1), ("pool", 2), ("conv", 96, 3, 1),
             ("pool", 2), ("fc", 100))


def _cfgs(name):
    if name == "tiny":
        return (jcnn.CNNConfig(name, TINY_SPEC, image_size=16),
                cnn.CNNConfig(name, TINY_SPEC, image_size=16))
    return (dataclasses.replace(jcnn.CNN_ZOO[name], image_size=16),
            dataclasses.replace(cnn.CNN_ZOO[name], image_size=16))


def _checkpoint(jcfg):
    """A float checkpoint in the reference's layer shapes, drawn with numpy
    (He-scaled weights, and non-zero biases so the bias add is held too)."""
    shapes = jax.eval_shape(lambda: jcnn.init(jax.random.PRNGKey(0), jcfg))
    rng = np.random.default_rng(0)
    return {name: {
        "w": (rng.standard_normal(p["w"].shape)
              * np.sqrt(2.0 / p["w"].shape[0])).astype(np.float32),
        "b": (0.1 * rng.standard_normal(p["b"].shape)).astype(np.float32)}
        for name, p in sorted(shapes.items())}


@pytest.fixture(scope="module", params=["alexnet", "nin"])
def model(request):
    """(name, JAX planes engine, port float checkpoint, port cfg, images).

    The JAX engine serves the bytes the port kneads from the same floats
    (``to_jax``; kneading is held byte-identical in test_torch_kneading.py),
    so this file times the two forward paths and not the JAX package's
    per-shape kneading compiles."""
    return _models(request.param)


def _models(name):
    jcfg, tcfg = _cfgs(name)
    np_params = _checkpoint(jcfg)
    jparams = jax.tree.map(jnp.asarray, np_params)
    images = np.random.default_rng(1).standard_normal(
        (3, 16, 16, 3)).astype(np.float32)
    tparams = from_jax_params(np_params, device="cpu")

    def knead_like_the_port(params, **kw):
        return {name: {"w": to_jax(p["w"]), "b": params[name]["b"]}
                for name, p in cnn.knead_params(tparams, **kw).items()}

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jcnn, "knead_params", knead_like_the_port)
        jeng = JEngine(jcfg, jparams, JConfig(impl="planes"))
    return name, jeng, tparams, tcfg, images


def _engine(tcfg, tparams, impl, **kw):
    return CNNServingEngine(tcfg, tparams, CNNServingConfig(impl=impl, **kw),
                            device="cpu")


def test_kernel_logits_match_jax_planes(model):
    _, jeng, tparams, tcfg, images = model
    want = np.asarray(jeng.logits(jnp.asarray(images)))
    got = _engine(tcfg, tparams, "kernel").logits(images).numpy()
    assert got.shape == want.shape == (3, tcfg.num_classes)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


def test_port_impls_agree(model):
    _, _, tparams, tcfg, images = model
    eng = _engine(tcfg, tparams, "kernel")
    kernel = eng.logits(images)
    pred = eng.classify(images)
    assert pred.dtype == torch.int32
    assert torch.equal(pred, kernel.argmax(-1).to(torch.int32))
    for impl in ("planes", "int"):
        np.testing.assert_allclose(
            _engine(tcfg, tparams, impl).logits(images).numpy(),
            kernel.numpy(), rtol=RTOL, atol=ATOL, err_msg=impl)
    flt = _engine(tcfg, tparams, "float").logits(images)
    # int8 per-channel quantization of every layer: a few % of max |logit|
    assert float((kernel - flt).abs().max() / flt.abs().max()) < 0.1


def test_layer_report_and_bytes_equal_jax():
    _, jeng, tparams, tcfg, _ = _models("tiny")
    eng = _engine(tcfg, tparams, "kernel")
    want = {r["layer"]: r for r in jeng.layer_report()}
    got = eng.layer_report()
    assert sorted(r["layer"] for r in got) == sorted(want)
    for g in got:
        w = want[g["layer"]]
        for key in ("shape", "executed_tile_dots", "dense_tile_dots",
                    "bytes_vs_bf16", "cycle_ratio"):
            assert g[key] == w[key], (g["layer"], key)
    assert eng.serving_bytes() == jeng.serving_bytes()
    # without the float checkpoint the codes come from the planes
    lean = _engine(tcfg, tparams, "kernel", keep_float_params=False)
    assert lean.layer_report() == got


def test_submit_drain_buckets_and_latency_stats():
    _, tcfg = _cfgs("nin")
    tparams = cnn.init(tcfg, torch.Generator().manual_seed(0), device="cpu")
    eng = _engine(tcfg, tparams, "kernel")
    images = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (11, 16, 16, 3)).astype(np.float32))
    handles = [eng.submit(img) for img in images]
    results = eng.drain()
    assert sorted(results) == sorted(handles) == list(range(11))
    assert eng.ticks == 2                       # 8, then 3 padded to 4
    log = list(eng._request_log)
    assert [r["bucket"] for r in log] == [8] * 8 + [4] * 3
    assert [r["batch_fill"] for r in log] == [1.0] * 8 + [0.75] * 3
    direct = eng.logits(images)
    for h in handles:
        assert h.state == "done"
        np.testing.assert_allclose(h.result().numpy(), direct[h].numpy(),
                                   rtol=RTOL, atol=ATOL)
    stats = eng.latency_stats()
    assert stats["requests"] == 11
    for key in ("mean_ms", "p50_ms", "p95_ms", "max_ms", "mean_batch_fill",
                "queue_wait_p50_ms", "queue_wait_p95_ms", "decode_p50_ms",
                "decode_p95_ms"):
        assert stats[key] >= 0, key
    assert stats["mean_batch_fill"] == pytest.approx((8 + 0.75 * 3) / 11)
    h = eng.submit(images[0])
    assert h.cancel() and h.state == "cancelled"
    assert eng.drain() == {}
    with pytest.raises(RuntimeError, match="cancelled"):
        h.result()
    with pytest.raises(ValueError, match="image"):
        eng.submit(images[0, :8])


def test_engine_without_device_raises_on_cpu_host(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, tcfg = _cfgs("nin")
    params = cnn.init(tcfg, torch.Generator().manual_seed(0), device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        CNNServingEngine(tcfg, params, CNNServingConfig(impl="kernel"))
    with pytest.raises(RuntimeError, match="CUDA"):
        cnn.init(tcfg, torch.Generator().manual_seed(0))


@pytest.mark.parametrize("name", ["alexnet", "nin"])
def test_init_matches_jax_shapes_and_is_seeded(name):
    jcfg, tcfg = _cfgs(name)
    jshapes = jax.eval_shape(lambda: jcnn.init(jax.random.PRNGKey(0), jcfg))
    a = cnn.init(tcfg, torch.Generator().manual_seed(3), device="cpu")
    b = cnn.init(tcfg, torch.Generator().manual_seed(3), device="cpu")
    assert sorted(a) == sorted(jshapes)
    for layer, p in a.items():
        for key in ("w", "b"):
            assert tuple(p[key].shape) == jshapes[layer][key].shape
            assert torch.equal(p[key], b[layer][key])
        assert float(p["w"].abs().max()) <= 2 * np.sqrt(
            2.0 / p["w"].shape[0]) + 1e-6         # truncated at 2 sigma
