"""The port's quantization and bit packing against the JAX package.

Codes, scales and packed words must equal the reference's bit for bit
(tolerance: none) — the kneaded format is only interchangeable if they do.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bitplanes as jbp
from repro.core import quantization as jq
from repro_torch.core import bitplanes as tbp
from repro_torch.core import quantization as tq


def _weights(seed, shape=(320, 96)):
    rng = np.random.default_rng(seed)
    w = rng.standard_normal(shape).astype(np.float32) * 0.05
    w[:, 3] = 0.0                               # an all-zero channel
    return w


@pytest.mark.parametrize("bits", range(2, 17))
def test_quantize_codes_and_scales_bit_exact(bits):
    w = _weights(bits)
    ref = jq.quantize(jnp.asarray(w), bits=bits)
    got = tq.quantize(torch.from_numpy(w), bits=bits)
    q_ref = np.asarray(ref.q)
    assert got.q.numpy().dtype == q_ref.dtype
    np.testing.assert_array_equal(got.q.numpy(), q_ref)
    assert got.scale.numpy().tobytes() == np.asarray(ref.scale).tobytes()
    qmax = 2 ** (bits - 1) - 1
    assert int(got.q.abs().max()) <= qmax      # -2^(B-1) never appears
    np.testing.assert_array_equal(tq.dequantize(got).numpy(),
                                  np.asarray(jq.dequantize(ref)))


@pytest.mark.parametrize("axis", [None, 0])
def test_quantize_other_axes_bit_exact(axis):
    w = _weights(7)
    ref = jq.quantize(jnp.asarray(w), bits=8, axis=axis)
    got = tq.quantize(torch.from_numpy(w), bits=8, axis=axis)
    np.testing.assert_array_equal(got.q.numpy(), np.asarray(ref.q))
    assert got.scale.numpy().tobytes() == np.asarray(ref.scale).tobytes()


def test_round_half_even():
    w = torch.tensor([[0.5, 1.5, 2.5, -0.5, -2.5, 127.0]]).T
    q = tq.quantize(w, bits=8, axis=-1).q.flatten().tolist()
    assert q == [0, 2, 2, 0, -2, 127]


@pytest.mark.parametrize("bits", [4, 8, 9, 16])
def test_packed_planes_and_signs_bit_exact(bits):
    w = _weights(100 + bits, (256, 64))
    q_ref = jq.quantize(jnp.asarray(w), bits=bits).q
    q = tq.quantize(torch.from_numpy(w), bits=bits).q
    mag_ref = jbp.magnitude_planes(q_ref, bits)
    mag = tbp.magnitude_planes(q, bits)
    np.testing.assert_array_equal(mag.numpy(), np.asarray(mag_ref))
    planes_ref = np.asarray(jbp.pack_bits(mag_ref, axis=1))
    planes = tbp.pack_bits(mag, axis=1)
    assert planes.numpy().tobytes() == planes_ref.tobytes()
    signs_ref = np.asarray(jbp.pack_bits((q_ref < 0).astype(jnp.uint8)))
    signs = tbp.pack_bits((q < 0).to(torch.uint8))
    assert signs.numpy().tobytes() == signs_ref.tobytes()
    # bit i of word w is row 32w + i, and unpacking round-trips
    np.testing.assert_array_equal(tbp.unpack_bits(planes, axis=1).numpy(),
                                  mag.numpy())


def test_pack_bits_high_bit_and_presence_round_trip():
    rng = np.random.default_rng(3)
    bits01 = (rng.random((5, 64, 7)) < 0.5).astype(np.uint8)
    bits01[:, 31, :] = 1                        # the sign bit of an int32
    ref = np.asarray(jbp.pack_bits(jnp.asarray(bits01), axis=1))
    got = tbp.pack_bits(torch.from_numpy(bits01), axis=1)
    assert got.dtype == torch.int32
    assert got.numpy().tobytes() == ref.tobytes()
    np.testing.assert_array_equal(tbp.unpack_bits(got, axis=1).numpy(),
                                  bits01)
    presence = (rng.random((3, 37, 4)) < 0.3).astype(np.int32)
    ref = np.asarray(jbp.pack_presence(jnp.asarray(presence)))
    got = tbp.pack_presence(torch.from_numpy(presence))
    assert got.numpy().tobytes() == ref.tobytes()
    np.testing.assert_array_equal(tbp.unpack_presence(got, 37).numpy(),
                                  presence)
