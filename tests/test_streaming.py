"""Seed-compressed streamed DB: seeded encryption round-trip (device and
native C++ engines, which must produce interchangeable ciphertexts),
Threefry cross-language consistency, and streamed-vs-in-memory sender
parity (reference behavior: per-op DB streaming,
src/sender/sender_diag.cpp:85-94)."""

import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from image_matching.ckks.params import SchemeParams, compute_required_depth
from image_matching.ckks.context import CkksContext, Ciphertext
from image_matching.matching.config import MatchConfig
from image_matching.matching.protocol import MatchingProtocol
from image_matching.matching import streaming
from image_matching.ops import prng
from image_matching.utils import io as dio
from image_matching.utils import native

RING = 512
DIM = 64


def _cfg():
    return MatchConfig(vector_dim=DIM, chunk_len=16, comp_depth=8, alpha_depth=2)


_CTX = {}


@pytest.fixture
def native_lib():
    """Skip (at run time, not import) when the C++ library cannot be built."""
    if not native.available():
        pytest.skip("native library not built")


def _ctx():
    if "c" not in _CTX:
        depth = compute_required_depth(5, _cfg().comp_depth)
        params = SchemeParams.create(ring_dim=RING, mult_depth=depth, security="none")
        _CTX["c"] = CkksContext(params, seed=7)
    return _CTX["c"]


def test_threefry_jnp_matches_numpy():
    x = np.arange(4096, dtype=np.uint32)
    with np.errstate(over="ignore"):
        h_np, l_np = prng.threefry2x32(np.uint32(7), np.uint32(3), x,
                                       np.zeros_like(x))
    h_j, l_j = prng.threefry2x32(jnp.uint32(7), jnp.uint32(3),
                                 jnp.asarray(x), jnp.zeros(4096, jnp.uint32))
    np.testing.assert_array_equal(np.asarray(h_j), h_np)
    np.testing.assert_array_equal(np.asarray(l_j), l_np)


@pytest.mark.slow
def test_seeded_encrypt_roundtrip():
    ctx = _ctx()
    rng = np.random.default_rng(3)
    vals = rng.uniform(-1, 1, (3, ctx.slots))
    c0 = ctx.encrypt_seeded_batch(vals, seed=42, group=5)
    c1 = ctx.expand_c1(42, jnp.uint32(5), 3, ctx.Lq)
    for i in range(3):
        ct = Ciphertext(jnp.stack([c0[i], c1[i]]), ctx.fresh_scale)
        got = ctx.decrypt(ct)
        np.testing.assert_allclose(got, vals[i], atol=1e-6)


@pytest.mark.slow
def test_native_enroll_matches_device_stream(native_lib):
    """The C++ host engine must produce ciphertexts the device can decrypt
    with its own regenerated c1 — proving the Threefry streams and NTT
    wiring agree across languages."""
    ctx = _ctx()
    rng = np.random.default_rng(4)
    vals = rng.uniform(-1, 1, (3, ctx.slots))
    c0 = ctx.encrypt_seeded_batch_host(vals, seed=42, group=5)
    assert c0 is not None
    c1 = np.asarray(ctx.expand_c1(42, jnp.uint32(5), 3, ctx.Lq))
    for i in range(3):
        ct = Ciphertext(jnp.asarray(np.stack([c0[i], c1[i]])), ctx.fresh_scale)
        got = ctx.decrypt(ct)
        np.testing.assert_allclose(got, vals[i], atol=1e-6)


def test_expand_c1_matches_numpy_reference():
    ctx = _ctx()
    a = np.asarray(ctx.expand_c1(9, jnp.uint32(2), 2, 3))
    b = prng.uniform_residues_np(9, 2, 0, (2, 3, ctx.n), ctx.all_primes)
    np.testing.assert_array_equal(a, b)


def test_uniform_mont_distribution():
    """Mean of uniform residues must be ~q/2 (catches biased reduction)."""
    ctx = _ctx()
    u = np.asarray(ctx.uniform_mont(1, jnp.uint32(0), (8,), 2))
    for i in range(2):
        q = ctx.all_primes[i]
        m = u[:, i].mean()
        assert abs(m / q - 0.5) < 0.01


@pytest.mark.slow
@pytest.mark.parametrize("nvec", [40, 300])
def test_streamed_matches_inmemory(nvec):
    """Streamed sender (host-spilled groups + seeded c1) returns the same
    membership/index results as the device-resident DiagonalSender; 300
    vectors span 2 groups at these parameters, exercising the multi-group
    prefetch loop and the host spill path (resident_budget=0)."""
    cfg = _cfg()
    ctx = _ctx()
    query, db = dio.gen_dataset(nvec, DIM, seed=1)
    ref = MatchingProtocol.setup(5, db, cfg, ctx=ctx)
    st = MatchingProtocol.setup(5, db, cfg, ctx=ctx, streamed=True,
                                resident_budget=0, engine="device")
    assert st.sender.store.resident_count() == 0
    qcts = ref.encrypt_query(query)

    ref_scores = ref.sender.compute_similarity(qcts)
    st_scores = st.sender.compute_similarity(qcts)
    assert len(ref_scores) == len(st_scores)
    for a, b in zip(ref_scores, st_scores):
        np.testing.assert_allclose(
            ctx.decrypt(a), ctx.decrypt(b), atol=2e-5)

    mem = st.sender.run_membership(qcts)
    assert st.decrypt_membership(mem) is True
    idx = st.decrypt_index(st.sender.run_index(qcts))
    ref_idx = ref.decrypt_index(ref.sender.run_index(qcts))
    assert sorted(idx) == sorted(ref_idx)
    assert 0 in idx


@pytest.mark.slow
@pytest.mark.parametrize("nvec", [300])
def test_streamed_hers_matches_inmemory(nvec):
    """Streamed HERS sender (approach 4, dimension-major groups + seeded
    c1) matches the device-resident HersSender — the reference streams
    this layout per-op from disk (src/sender/sender_hers.cpp:88-98)."""
    cfg = _cfg()
    ctx = _ctx()
    query, db = dio.gen_dataset(nvec, DIM, seed=1)
    ref = MatchingProtocol.setup(4, db, cfg, ctx=ctx)
    st = MatchingProtocol.setup(4, db, cfg, ctx=ctx, streamed=True,
                                resident_budget=0, engine="device")
    assert st.sender.store.resident_count() == 0
    assert st.sender.store.num_groups == 2  # multi-group prefetch path
    qcts = ref.encrypt_query(query)

    ref_scores = ref.sender.compute_similarity(qcts)
    st_scores = st.sender.compute_similarity(qcts)
    assert len(ref_scores) == len(st_scores)
    for a, b in zip(ref_scores, st_scores):
        np.testing.assert_allclose(ctx.decrypt(a), ctx.decrypt(b), atol=2e-5)

    mem = st.sender.run_membership(qcts)
    assert st.decrypt_membership(mem) is True
    idx = st.decrypt_index(st.sender.run_index(qcts))
    ref_idx = ref.decrypt_index(ref.sender.run_index(qcts))
    assert sorted(idx) == sorted(ref_idx)
    assert 0 in idx


@pytest.mark.slow
def test_enroll_cache_resume(tmp_path, monkeypatch, native_lib):
    """Interrupted enrollment resumes from the per-group cache files: a
    cache dir with no meta.json (incomplete run) is picked up, complete
    groups are trusted, and the newest file — possibly a torn write from a
    pre-atomic-rename writer — is re-enrolled."""
    cfg = _cfg()
    ctx = _ctx()
    query, db = dio.gen_dataset(300, DIM, seed=2)
    monkeypatch.setenv("IMTPU_STORE_DIR", str(tmp_path))
    st1 = streaming.enroll_diag_streamed(ctx, cfg, db, resident_budget=0,
                                         engine="native")
    want0 = np.array(st1.groups[0])
    [d] = [p for p in tmp_path.iterdir() if p.is_dir()]
    assert (d / "meta.json").exists() and st1.num_groups == 2
    # simulate an interrupted run: no completeness marker, torn last file
    (d / "meta.json").unlink()
    sorted(d.glob("g*.npy"))[-1].write_bytes(b"torn write")
    st2 = streaming.enroll_diag_streamed(ctx, cfg, db, resident_budget=0,
                                         engine="native")
    assert (d / "meta.json").exists()
    assert st2.num_groups == st1.num_groups
    # trusted cached group is served byte-identical; the suspect one is
    # re-encrypted (fresh noise) — verify it functionally instead
    np.testing.assert_array_equal(want0, np.asarray(st2.groups[0]))
    proto = MatchingProtocol.setup(5, db, cfg, ctx=ctx, streamed=True,
                                   resident_budget=0, engine="native")
    qcts = proto.encrypt_query(query)
    assert proto.decrypt_membership(proto.sender.run_membership(qcts)) is True
    assert 0 in proto.decrypt_index(proto.sender.run_index(qcts))


@pytest.mark.slow
def test_streamed_native_engine_end_to_end(native_lib):
    """Full streamed pipeline with the C++ host enroller."""
    cfg = _cfg()
    ctx = _ctx()
    query, db = dio.gen_dataset(40, DIM, seed=1)
    st = MatchingProtocol.setup(5, db, cfg, ctx=ctx, streamed=True,
                                resident_budget=0, engine="native")
    qcts = st.encrypt_query(query)
    assert st.decrypt_membership(st.sender.run_membership(qcts)) is True
    assert 0 in st.decrypt_index(st.sender.run_index(qcts))


@pytest.mark.slow
def test_encode_split_matches_batch_encrypt():
    """encrypt_seeded_from_split(encode_split(v)) must equal
    encrypt_seeded_batch(v) given the same noise stream — the contract the
    encode-coefficient disk cache (streaming._enc_cache_path) relies on."""
    ctx = _ctx()
    rng = np.random.default_rng(5)
    vals = rng.uniform(-1, 1, (4, ctx.slots))
    st = ctx._rng.bit_generator.state
    c0a = np.asarray(ctx.encrypt_seeded_batch(vals, seed=99, group=3))
    ctx._rng.bit_generator.state = st  # replay the noise draw
    hi, lo = ctx.encode_split(vals)
    c0b = np.asarray(ctx.encrypt_seeded_from_split(hi, lo, seed=99, group=3))
    assert np.array_equal(c0a, c0b)


def test_enc_cache_atomics(tmp_path):
    """_atomic_save publishes complete files; _enc_complete detects a full
    group set and nothing less."""
    d = str(tmp_path / "enc")
    arr = np.arange(12, dtype=np.uint32).reshape(2, 2, 3)
    assert streaming._atomic_save(d, "g0000.npy", arr)
    got = np.load(f"{d}/g0000.npy")
    assert np.array_equal(got, arr)
    assert not streaming._enc_complete(d, 2)
    assert streaming._atomic_save(d, "g0001.npy", arr)
    assert streaming._enc_complete(d, 2)
    assert not any(f.endswith(".tmp") for f in os.listdir(d))
