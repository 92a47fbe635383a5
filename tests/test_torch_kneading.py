"""The port's kneaded format against the JAX package, byte for byte.

Every array (planes, signs, scale, occupancy, counts, plane_ids, ktile_ids)
must equal the reference's bytes, so the CRC32s agree too; the schedule
statics and ``packed_bytes()`` must be equal.  Tolerance: none.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import kneading as jk
from repro_torch.core import kneading as tk
from repro_torch.core.schedule import (KneadedIntegrityError,
                                       replay_schedule)

SHAPES = [(512, 128), (1024, 256), (300, 100), (27, 64), (4800, 192)]
FIELDS = ("planes", "signs", "scale", "occupancy")
SCHEDULE_FIELDS = ("counts", "plane_ids", "ktile_ids")


def _pair(k, n, bits=8, ks=256, sparsity=0.0, seed=0):
    rng = np.random.default_rng(seed + k + n)
    w = rng.standard_normal((k, n)).astype(np.float32) * 0.05
    if sparsity:
        w *= rng.random((k, n)) >= sparsity
    ref = jk.knead_padded(jnp.asarray(w), bits=bits, ks=ks)
    got = tk.knead_padded(torch.from_numpy(w), bits=bits, ks=ks)
    return w, ref, got


def _assert_same_bytes(ref, got):
    for f in FIELDS:
        r, g = np.asarray(getattr(ref, f)), getattr(got, f).numpy()
        assert g.shape == r.shape, f
        assert g.tobytes() == r.tobytes(), f
    for f in SCHEDULE_FIELDS:
        r = np.asarray(getattr(ref.schedule, f))
        g = getattr(got.schedule, f).numpy()
        assert g.shape == r.shape and g.tobytes() == r.tobytes(), f
    assert got.checksums == ref.checksums
    for f in ("num_work", "total_work", "nk", "n_tiles"):
        assert getattr(got.schedule, f) == getattr(ref.schedule, f), f
    for f in ("bits", "ks", "n_block", "k", "n", "logical_k", "logical_n"):
        assert getattr(got, f) == getattr(ref, f), f
    assert got.packed_bytes() == ref.packed_bytes()
    assert got.metadata_bytes() == ref.metadata_bytes()
    assert got.dense_bf16_bytes() == ref.dense_bf16_bytes()


@pytest.mark.parametrize("k,n", SHAPES)
def test_knead_padded_byte_identical(k, n):
    _, ref, got = _pair(k, n)
    _assert_same_bytes(ref, got)


@pytest.mark.parametrize("bits,ks,sparsity", [(4, 512, 0.7), (8, 256, 0.95),
                                              (16, 256, 0.0)])
def test_knead_byte_identical_other_formats(bits, ks, sparsity):
    _, ref, got = _pair(1024, 256, bits=bits, ks=ks, sparsity=sparsity)
    _assert_same_bytes(ref, got)


def test_knead_aligned_codes_and_unknead():
    w, ref, got = _pair(512, 128)
    direct = tk.knead(torch.from_numpy(w))
    assert direct.checksums == got.checksums
    np.testing.assert_array_equal(tk.kneaded_codes(got).numpy(),
                                  np.asarray(jk.kneaded_codes(ref)))
    np.testing.assert_array_equal(tk.unknead(got).numpy(),
                                  np.asarray(jk.unknead(ref)))


def test_occupancy_map_and_with_occupancy():
    _, ref, got = _pair(1024, 256, sparsity=0.7)
    occ = got.occupancy_map()
    np.testing.assert_array_equal(occ.numpy(), np.asarray(ref.occupancy_map()))
    occ = occ.clone()
    occ[0] = 0                                   # drop plane 0 everywhere
    ref2 = ref.with_occupancy(jnp.asarray(occ.numpy()))
    got2 = got.with_occupancy(occ)
    _assert_same_bytes(ref2, got2)
    assert got2.verify() == ()


def test_verify_detects_corruption():
    _, _, got = _pair(512, 128)
    assert got.verify() == ()
    planes = got.planes.clone()
    planes.view(-1)[5] ^= 1
    bad = dataclasses.replace(got, planes=planes)
    assert bad.verify() == ("planes",)
    with pytest.raises(KneadedIntegrityError):
        bad.verify(strict=True)


@pytest.mark.parametrize("bits,ks", [(8, 16), (4, 10)])
def test_kneaded_cycles_and_ratio(bits, ks):
    rng = np.random.default_rng(bits)
    w = rng.standard_normal((160, 48)).astype(np.float32)
    q_ref = jk.quantize(jnp.asarray(w), bits=bits).q
    q = tk.quantize(torch.from_numpy(w), bits=bits).q
    np.testing.assert_array_equal(
        tk.kneaded_cycles(q, bits, ks).numpy(),
        np.asarray(jk.kneaded_cycles(q_ref, bits, ks)))
    assert float(tk.kneading_ratio(q, bits, ks)) == float(
        jk.kneading_ratio(q_ref, bits, ks))


def test_replay_schedule_matches_dense_oracle():
    """The item-by-item replay equals a @ unknead(w) to the parity bar."""
    _, _, got = _pair(1024, 256, sparsity=0.7)
    a = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (8, 1024)).astype(np.float32))
    np.testing.assert_allclose(replay_schedule(a, got).numpy(),
                               (a @ tk.unknead(got)).numpy(),
                               rtol=1e-5, atol=1e-4)
