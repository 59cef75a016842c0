"""Dataset IO, native library, and serialization round trips."""

import os
import tempfile

import numpy as np

from image_matching.utils import io as dio
from image_matching.utils import native


def test_dataset_roundtrip(tmp_path):
    q, db = dio.gen_dataset(16, 32, seed=2)
    p = str(tmp_path / "d.dat")
    dio.write_dataset(p, q, db)
    q2, db2 = dio.read_dataset(p, 32)
    np.testing.assert_array_equal(q, q2)
    np.testing.assert_array_equal(db, db2)


def test_planted_match_semantics():
    q, db = dio.gen_dataset(64, 128, seed=3)
    from image_matching.matching import vector_utils as vu

    sims = vu.cosine_similarity(vu.normalize(q)[None, :], vu.normalize(db))
    assert sims[0] > 0.8  # planted match at index 0
    assert np.all(np.abs(sims[1:]) < 0.6)


def test_native_crt_matches_python():
    if not native.available():
        return
    from image_matching.ckks import encoding as enc
    from image_matching.ckks.params import find_primes_near

    primes = find_primes_near(1 << 28, 256, 5)
    rng = np.random.default_rng(4)
    c = rng.integers(-(1 << 50), 1 << 50, size=(2, 64)).astype(np.int64)
    res = enc.to_rns(c, primes)
    out = native.crt_compose_centered(res, primes)
    np.testing.assert_array_equal(out, c.astype(np.float64))


def test_identity_dataset_separation():
    db, db_ids, queries, qids = dio.gen_identity_dataset(8, 3, 5, 64, seed=5)
    from image_matching.matching import vector_utils as vu

    sims = vu.cosine_similarity(
        vu.normalize(queries[0])[None, :], vu.normalize(db)
    )
    same = sims[db_ids == qids[0]]
    diff = sims[db_ids != qids[0]]
    assert same.mean() > 0.6 and abs(diff.mean()) < 0.3


def test_context_serialization(tmp_path):
    from image_matching.ckks.params import SchemeParams
    from image_matching.ckks.context import CkksContext
    from image_matching.utils import serial

    params = SchemeParams.create(ring_dim=256, mult_depth=2, security="none")
    ctx = CkksContext(params, seed=6)
    ctx.gen_power_of_two_rotation_keys()
    z = np.random.default_rng(6).uniform(-1, 1, ctx.slots)
    ct = ctx.encrypt(z)

    serial.save_context(ctx, str(tmp_path))
    ctx2 = serial.load_context(str(tmp_path))
    # keys identical -> decryption of the old ciphertext works
    np.testing.assert_allclose(ctx2.decrypt(ct), z, atol=1e-4)
    # rotation keys survive
    out = ctx2.decrypt(ctx2.rotate(ct, 2))
    np.testing.assert_allclose(out, np.roll(z, -2), atol=1e-4)
