"""The port's SAC matmul paths against the JAX package.

Port ``planes``/``int``/``float``/``kernel`` (the kernel's plain PyTorch
version on the CPU) against JAX ``planes``/``int`` and
``sac_matmul_pallas`` in interpret mode, to the ``tests/parity.py`` bar
(rtol 1e-5, atol 1e-4): plane entries are in {-1, 0, 1}, so every product
is exact and only the order of the f32 sums differs between libraries.
Inside the port, where the order is the same, skip-on equals skip-off bit
for bit.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from repro.core import activation_occupancy as jao
from repro.core.kneading import KneadedWeight as JKneadedWeight
from repro.core.schedule import KneadedSchedule as JSchedule
from repro.core.sac import sac_matmul as j_sac_matmul
from repro.kernels.sac_matmul.ops import im2col as j_im2col
from repro.kernels.sac_matmul.ops import sac_conv2d as j_sac_conv2d
from repro.kernels.sac_matmul.ops import sac_matmul_pallas
from repro_torch.core import activation_occupancy as tao
from repro_torch.core.kneading import knead_padded
from repro_torch.core.sac import SAC_IMPLS, sac_matmul
from repro_torch.kernels import LAUNCHES
from repro_torch.kernels.sac_matmul import kernel, ops
from repro_torch.kernels.sac_matmul.ref import sac_matmul_ref

RTOL, ATOL = 1e-5, 1e-4
PARITY_SHAPES = [(24, 512, 128), (8, 1024, 256), (40, 768, 128)]


def to_jax(tkw):
    """The same kneaded weight as a JAX ``KneadedWeight``.  Kneading itself
    is held byte-identical in test_torch_kneading.py; reusing the port's
    bytes here (and in test_torch_cnn.py) spares the JAX package's kneading,
    which compiles anew for every weight shape (about 3 s each on a CPU)."""
    def arr(t):
        x = t.numpy()
        return jnp.asarray(x.view(np.uint32) if x.dtype == np.int32 else x)
    s = tkw.schedule
    sched = JSchedule(counts=jnp.asarray(s.counts.numpy()),
                      plane_ids=jnp.asarray(s.plane_ids.numpy()),
                      ktile_ids=jnp.asarray(s.ktile_ids.numpy()),
                      num_work=s.num_work, total_work=s.total_work, nk=s.nk,
                      n_tiles=s.n_tiles)
    return JKneadedWeight(planes=arr(tkw.planes), signs=arr(tkw.signs),
                          scale=arr(tkw.scale), occupancy=arr(tkw.occupancy),
                          schedule=sched, bits=tkw.bits, ks=tkw.ks,
                          n_block=tkw.n_block, k=tkw.k, n=tkw.n,
                          k_orig=tkw.k_orig, n_orig=tkw.n_orig)


def _case(seed, m, k, n, bits=8, ks=256, sparsity=0.0):
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((k, n)).astype(np.float32) * 0.05
    if sparsity:
        w *= rng.random((k, n)) >= sparsity
    a = rng.standard_normal((m, k)).astype(np.float32)
    tkw = knead_padded(torch.from_numpy(w), bits=bits, ks=ks)
    return a, to_jax(tkw), tkw


# one compiled program per case instead of one compile per eager op
_j_planes = jax.jit(functools.partial(j_sac_matmul, impl="planes"))
_j_int = jax.jit(functools.partial(j_sac_matmul, impl="int"))


def _jax_outputs(a, jkw, pallas=True):
    """JAX ``planes`` and ``int``, and ``sac_matmul_pallas`` in interpret
    mode when ``pallas`` (its slowest path on the CPU)."""
    aj = jnp.asarray(a)
    out = {"planes": np.asarray(_j_planes(aj, jkw)),
           "int": np.asarray(_j_int(aj, jkw))}
    if pallas:
        out["pallas"] = np.asarray(sac_matmul_pallas(aj, jkw))[
            :, :jkw.logical_n]
    return out


@pytest.mark.parametrize("m,k,n", PARITY_SHAPES)
@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("ks", [256, 512])
def test_sac_impls_match_jax(m, k, n, bits, ks):
    a, jkw, tkw = _case(bits + ks + m, m, k, n, bits=bits, ks=ks,
                        sparsity=0.7 if bits == 4 else 0.0)
    # pallas == planes bit for bit in the JAX package; interpret it at one
    # bit width per shape and stride
    ref = _jax_outputs(a, jkw, pallas=bits == 8)
    at = torch.from_numpy(a)
    outs = {impl: sac_matmul(at, tkw, impl=impl, device="cpu").numpy()
            for impl in SAC_IMPLS}
    for impl, out in outs.items():
        assert out.shape == (m, n)
        for jimpl, want in ref.items():
            np.testing.assert_allclose(out, want, rtol=RTOL, atol=ATOL,
                                       err_msg=f"{impl} vs jax {jimpl}")
    np.testing.assert_array_equal(outs["float"], outs["int"])
    a_stored = torch.nn.functional.pad(at, (0, tkw.k - k))
    np.testing.assert_allclose(
        outs["kernel"], sac_matmul_ref(a_stored, tkw)[:, :n].numpy(),
        rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("m,k,n", [(8, 300, 100), (2, 27, 64), (1, 4800, 192),
                                   (7, 512, 256)])
def test_padded_and_gemv_shapes_match_jax(m, k, n):
    a, jkw, tkw = _case(m * k, m, k, n)
    ref = _jax_outputs(a, jkw)
    at = torch.from_numpy(a)
    for impl in ("planes", "kernel"):
        out = sac_matmul(at, tkw, impl=impl, device="cpu").numpy()
        assert out.shape == (m, n)
        for want in ref.values():
            np.testing.assert_allclose(out, want, rtol=RTOL, atol=ATOL)


def _zero_tiles(a, ks, tiles):
    for t in tiles:
        a[:, t * ks:(t + 1) * ks] = 0.0
    return a


def test_ktile_presence_and_work_mask_equal_jax():
    a, jkw, tkw = _case(5, 4, 1024, 256, sparsity=0.7)
    a = _zero_tiles(a, 256, (1, 3))
    pj = jao.ktile_presence(jnp.asarray(a), 256)
    pt = tao.ktile_presence(torch.from_numpy(a), 256)
    np.testing.assert_array_equal(pt.numpy(), np.asarray(pj))
    sj, st = jkw.schedule, tkw.schedule
    np.testing.assert_array_equal(
        tao.weight_only_mask(st.counts, st.num_work).numpy(),
        np.asarray(jao.weight_only_mask(sj.counts, sj.num_work)))
    mt = tao.work_mask(st.counts, st.ktile_ids, pt)
    np.testing.assert_array_equal(
        mt.numpy(), np.asarray(jao.work_mask(sj.counts, sj.ktile_ids, pj)))
    assert 0 < int(mt.sum()) < st.total_work


@pytest.mark.parametrize("m", [1, 7, 8])
def test_skip_on_equals_skip_off_bitwise(m):
    a, _, tkw = _case(11 + m, m, 1024, 256, sparsity=0.5)
    at = torch.from_numpy(_zero_tiles(a, 256, (0, 2)))
    tao.reset_skip_stats()
    for impl in ("kernel", "planes"):
        on = sac_matmul(at, tkw, impl=impl, skip_activations=True,
                        device="cpu")
        off = sac_matmul(at, tkw, impl=impl, device="cpu")
        assert torch.equal(on, off), impl
    stats = tao.skip_stats()
    assert stats["skip_calls"] == 1                  # kernel impl only
    assert 0 < stats["executed_tile_dots"] < stats["weight_tile_dots"]


def test_skip_gate_off_above_gemv_rows():
    a, _, tkw = _case(3, 9, 512, 128)
    tao.reset_skip_stats()
    sac_matmul(torch.from_numpy(a), tkw, impl="kernel",
               skip_activations=True, device="cpu")
    assert tao.skip_stats()["skip_calls"] == 0


def test_kernel_wrapper_cpu_path_counts_no_launch():
    a, _, tkw = _case(4, 8, 512, 128)
    before = LAUNCHES["sac_matmul"]
    ops.sac_matmul_kernel(torch.from_numpy(a), tkw)
    assert LAUNCHES["sac_matmul"] == before


def test_kernel_wrapper_rejects_bad_inputs():
    a, _, tkw = _case(4, 8, 512, 128)
    a_p = torch.from_numpy(a)
    s = tkw.schedule
    args = (tkw.planes, tkw.signs, tkw.scale, s)
    with pytest.raises(TypeError):
        kernel.sac_matmul_launch(a_p.double(), *args, bits=8)
    with pytest.raises(ValueError):
        kernel.sac_matmul_launch(a_p[:, :256], *args, bits=8)
    mask = tao.weight_only_mask(s.counts, s.num_work)
    with pytest.raises(ValueError):              # no kernel for this device
        kernel.sac_matmul_launch(a_p.to("meta"), tkw.planes.to("meta"),
                                 tkw.signs.to("meta"), tkw.scale.to("meta"),
                                 type(s)(s.counts.to("meta"),
                                         s.plane_ids.to("meta"),
                                         s.ktile_ids.to("meta"), s.num_work,
                                         s.total_work, s.nk, s.n_tiles),
                                 bits=8, mask=mask.to("meta"))


def test_entry_points_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    a, _, tkw = _case(4, 8, 512, 128)
    with pytest.raises(RuntimeError, match="CUDA"):
        sac_matmul(torch.from_numpy(a), tkw, impl="kernel")
    with pytest.raises(RuntimeError, match="CUDA"):
        ops.sac_conv2d(torch.zeros(1, 4, 4, 3), tkw, ksize=3)


@pytest.mark.parametrize("shape,k,stride", [
    ((2, 10, 10, 8), 3, 1), ((2, 9, 7, 3), 4, 2), ((1, 8, 8, 2), 5, 1),
    ((1, 16, 16, 3), 2, 2), ((2, 5, 6, 3), 1, 1), ((1, 7, 7, 4), 3, 3)])
def test_im2col_equals_conv_general_dilated_patches(shape, k, stride):
    x = np.random.default_rng(k).standard_normal(shape).astype(np.float32)
    want = np.asarray(lax.conv_general_dilated_patches(
        jnp.asarray(x), (k, k), (stride, stride), "SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC")))
    np.testing.assert_array_equal(
        ops.im2col(torch.from_numpy(x), k, stride).numpy(), want)
    np.testing.assert_array_equal(np.asarray(j_im2col(jnp.asarray(x), k,
                                                      stride)), want)


@pytest.fixture(scope="module")
def conv_case():
    rng = np.random.default_rng(9)
    x = rng.standard_normal((2, 10, 10, 8)).astype(np.float32)
    w = rng.standard_normal((72, 32)).astype(np.float32) * 0.05
    b = rng.standard_normal(32).astype(np.float32)
    tkw = knead_padded(torch.from_numpy(w))
    want = np.asarray(j_sac_conv2d(jnp.asarray(x), to_jax(tkw), ksize=3,
                                   bias=jnp.asarray(b), impl="planes"))
    return x, tkw, b, want


@pytest.mark.parametrize("impl", ["kernel", "planes", "int"])
def test_sac_conv2d_matches_jax(conv_case, impl):
    x, tkw, b, want = conv_case
    got = ops.sac_conv2d(torch.from_numpy(x), tkw, ksize=3,
                         bias=torch.from_numpy(b), impl=impl, device="cpu")
    assert got.shape == (2, 10, 10, 32)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


def test_cta_rows_fills_the_card_within_shared_memory():
    assert kernel.cta_tiles(8, 256) == (8, 16, 32)
    assert kernel.cta_tiles(16, 512) == (8, 16)      # 32 rows do not fit
    sms = 132
    assert kernel.cta_rows(8192, 128, 8, 256, sms) == 32   # 256 CTAs
    assert kernel.cta_rows(2048, 128, 8, 256, sms) == 8    # 128 at 16 rows
    assert kernel.cta_rows(128, 512, 8, 256, sms) == 8
    assert kernel.cta_rows(1, 1 << 16, 8, 256, sms) == 8   # never > M
    assert kernel.cta_rows(8192, 128, 16, 512, sms) == 16
    with pytest.raises(ValueError):
        kernel.cta_tiles(16, 4096)
