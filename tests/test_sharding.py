"""Multi-device sharded execution on the 8-device CPU mesh."""

import numpy as np
import pytest
import jax

pytestmark = pytest.mark.slow

from image_matching.ckks.params import SchemeParams, compute_required_depth
from image_matching.ckks.context import CkksContext
from image_matching.matching.config import MatchConfig
from image_matching.matching.protocol import MatchingProtocol
from image_matching.parallel.sharded import (
    make_mesh, ShardedScenario, ShardedStreamedScenario)
from image_matching.utils import io as dio

DIM = 64
RING = 512


@pytest.mark.skipif(len(jax.devices()) < 2, reason="needs multiple devices")
def test_sharded_diag_membership_matches_single():
    n_dev = 2
    cfg = MatchConfig(vector_dim=DIM, chunk_len=16, comp_depth=8)
    depth = compute_required_depth(5, cfg.comp_depth, cfg.alpha_depth)
    params = SchemeParams.create(ring_dim=RING, mult_depth=depth, security="none")
    ctx = CkksContext(params, seed=8)
    group = params.slots  # vectors per diagonal group
    query, db = dio.gen_dataset(group * n_dev, DIM, seed=8)
    proto = MatchingProtocol.setup(5, db, cfg, ctx=ctx)
    qcts = proto.encrypt_query(query)

    single = proto.membership(qcts)
    mesh = make_mesh(n_dev)
    sharded = ShardedScenario(proto.sender, mesh)
    multi = sharded.membership(qcts)

    v1 = proto.ctx.decrypt(single)[0]
    v2 = proto.ctx.decrypt(multi)[0]
    assert (v1 >= 1.0) == (v2 >= 1.0) == True  # noqa: E712
    np.testing.assert_allclose(v1, v2, atol=1e-2)

    # index flags identical across sharded/unsharded
    idx1 = proto.decrypt_index(proto.index(qcts))
    idx2 = proto.decrypt_index(sharded.index(qcts))
    assert idx1 == idx2 == [0]


@pytest.mark.skipif(len(jax.devices()) < 2, reason="needs multiple devices")
def test_sharded_uneven_groups_padded():
    """3 DB groups on a 2-device mesh: zero-ciphertext padding keeps both
    scenarios correct (membership flag and index decode unchanged)."""
    n_dev = 2
    cfg = MatchConfig(vector_dim=DIM, chunk_len=16, comp_depth=8)
    depth = compute_required_depth(5, cfg.comp_depth, cfg.alpha_depth)
    params = SchemeParams.create(ring_dim=RING, mult_depth=depth, security="none")
    ctx = CkksContext(params, seed=9)
    group = params.slots
    query, db = dio.gen_dataset(group * 3, DIM, seed=9)
    proto = MatchingProtocol.setup(5, db, cfg, ctx=ctx)
    qcts = proto.encrypt_query(query)

    mesh = make_mesh(n_dev)
    sharded = ShardedScenario(proto.sender, mesh)
    assert proto.sender.db.data.shape[0] == 3  # does not divide mesh size

    assert proto.decrypt_membership(sharded.membership(qcts)) is True
    assert proto.decrypt_index(sharded.index(qcts)) == [0]


@pytest.mark.skipif(len(jax.devices()) < 2, reason="needs multiple devices")
@pytest.mark.parametrize("n_dev,n_groups", [(2, 2), (4, 3)])
def test_sharded_streamed_matches_single(n_dev, n_groups):
    """ShardedStreamedScenario: host-RAM seed-compressed store partitioned
    across the mesh with per-device streaming (resident_budget=0); the
    (4, 3) case exercises the zeroed-c1 padding for uneven partitions."""
    cfg = MatchConfig(vector_dim=DIM, chunk_len=16, comp_depth=8)
    depth = compute_required_depth(5, cfg.comp_depth, cfg.alpha_depth)
    params = SchemeParams.create(ring_dim=RING, mult_depth=depth,
                                 security="none")
    ctx = CkksContext(params, seed=11)
    group = params.slots
    query, db = dio.gen_dataset(group * n_groups, DIM, seed=11)
    proto = MatchingProtocol.setup(5, db, cfg, ctx=ctx, streamed=True,
                                   resident_budget=0, engine="device")
    assert proto.sender.store.resident_count() == 0
    assert proto.sender.store.num_groups == n_groups
    qcts = proto.encrypt_query(query)

    single = proto.sender.run_membership(qcts)
    sharded = ShardedStreamedScenario(proto.sender, make_mesh(n_dev))
    multi = sharded.membership(qcts)

    v1 = proto.ctx.decrypt(single)[0]
    v2 = proto.ctx.decrypt(multi)[0]
    assert (v1 >= 1.0) == (v2 >= 1.0) == True  # noqa: E712
    np.testing.assert_allclose(v1, v2, atol=1e-2)

    idx1 = proto.decrypt_index(proto.sender.run_index(qcts))
    idx2 = proto.decrypt_index(sharded.index(qcts))
    assert idx1 == idx2 == [0]


@pytest.mark.skipif(len(jax.devices()) < 2, reason="needs multiple devices")
def test_sharded_hers_membership_matches_single():
    """HERS layout (dimension-major groups) sharded over the mesh."""
    n_dev = 2
    cfg = MatchConfig(vector_dim=DIM, chunk_len=16, comp_depth=8)
    depth = compute_required_depth(4, cfg.comp_depth, cfg.alpha_depth)
    params = SchemeParams.create(ring_dim=RING, mult_depth=depth, security="none")
    ctx = CkksContext(params, seed=10)
    query, db = dio.gen_dataset(params.slots * n_dev, DIM, seed=10)
    proto = MatchingProtocol.setup(4, db, cfg, ctx=ctx)
    qcts = proto.encrypt_query(query)

    single = proto.membership(qcts)
    sharded = ShardedScenario(proto.sender, make_mesh(n_dev))
    multi = sharded.membership(qcts)

    v1 = proto.ctx.decrypt(single)[0]
    v2 = proto.ctx.decrypt(multi)[0]
    assert (v1 >= 1.0) == (v2 >= 1.0) == True  # noqa: E712
    np.testing.assert_allclose(v1, v2, atol=1e-2)


@pytest.mark.skipif(len(jax.devices()) < 4, reason="needs 4 devices")
def test_chip_smoke_four_card_flags_identical():
    """chip_smoke --four's comparison at ring 512: ShardedStreamedScenario
    and ShardedScenario flags bit-identical to the one-card sender."""
    import chip_smoke
    cfg = MatchConfig(vector_dim=DIM, chunk_len=16, comp_depth=8)
    ctx = chip_smoke.make_context(5, ring=RING, cfg=cfg, seed=3)
    r = chip_smoke.four_card(log2n=10, n_devices=4, ctx=ctx, cfg=cfg, seed=3)
    assert r["groups"] == 4
    assert r["decrypted"]["one"] == [True, [0]]
    assert r["sharded_flags_identical"] and r["streamed_membership_identical"]
