"""Cost-faithful reference modes that the default batched paths
replace: per-term relin+rescale HERS scoring (reference
src/sender/sender_hers.cpp:70-72) and the non-BSGS diagonal sender using
all dim-1 hoisted rotations (reference src/sender/sender_diag.cpp:14-26).
Both must produce the same results as the optimized defaults."""

import numpy as np
import pytest

pytestmark = pytest.mark.slow

from image_matching.ckks.params import SchemeParams, compute_required_depth
from image_matching.ckks.context import CkksContext
from image_matching.matching.config import MatchConfig
from image_matching.matching.protocol import MatchingProtocol
from image_matching.matching import vector_utils as vu
from image_matching.utils import io as dio

RING = 512
DIM = 64
NVEC = 40


def _setup(approach, **cfg_kw):
    cfg = MatchConfig(vector_dim=DIM, chunk_len=16, comp_depth=8,
                      alpha_depth=2, **cfg_kw)
    depth = compute_required_depth(approach, cfg.comp_depth, cfg.alpha_depth)
    params = SchemeParams.create(ring_dim=RING, mult_depth=depth,
                                 security="none")
    ctx = CkksContext(params, seed=7)
    query, db = dio.gen_dataset(NVEC, DIM, seed=1)
    proto = MatchingProtocol.setup(approach, db, cfg, ctx=ctx)
    return proto, query, db


def _plain_sims(query, db):
    return vu.cosine_similarity(vu.normalize(query)[None, :], vu.normalize(db))


def test_faithful_hers_score_parity():
    proto, query, db = _setup(4, faithful_hers=True)
    qcts = proto.encrypt_query(query)
    scores = proto.sender.compute_similarity(qcts)
    vals = proto.receiver.decrypt_scores(scores)[:NVEC]
    np.testing.assert_allclose(vals, _plain_sims(query, db), atol=1e-4)
    assert proto.decrypt_membership(proto.membership(qcts)) is True


def test_hers_alt_query_flow():
    """encryptQueryAlt: 1-ciphertext query expanded server-side must give
    the same scores as the dim-ciphertext default (costs 1 extra level)."""
    cfg = MatchConfig(vector_dim=DIM, chunk_len=16, comp_depth=8,
                      alpha_depth=2, hers_alt_query=True)
    depth = compute_required_depth(4, cfg.comp_depth, cfg.alpha_depth) + 1
    params = SchemeParams.create(ring_dim=RING, mult_depth=depth,
                                 security="none")
    ctx = CkksContext(params, seed=7)
    query, db = dio.gen_dataset(NVEC, DIM, seed=1)
    proto = MatchingProtocol.setup(4, db, cfg, ctx=ctx)
    qcts = proto.encrypt_query(query)
    assert len(qcts) == 1  # single-ciphertext query on the wire
    scores = proto.sender.compute_similarity(qcts)
    vals = proto.receiver.decrypt_scores(scores)[:NVEC]
    np.testing.assert_allclose(vals, _plain_sims(query, db), atol=1e-4)


def test_diag_non_bsgs_matches_bsgs():
    """The 511-hoisted-rotation mode (dim-1 here) must agree with the BSGS
    default, end to end."""
    proto_nb, query, db = _setup(5, use_bsgs=False)
    assert proto_nb.sender.db.bsgs is False
    assert proto_nb.sender.required_rotations() == list(range(1, DIM))
    qcts = proto_nb.encrypt_query(query)
    scores = proto_nb.sender.compute_similarity(qcts)
    vals = proto_nb.receiver.decrypt_scores(scores)[:NVEC]
    np.testing.assert_allclose(vals, _plain_sims(query, db), atol=1e-4)

    proto_b, _, _ = _setup(5, use_bsgs=True)
    idx_nb = proto_nb.decrypt_index(proto_nb.index(qcts))
    idx_b = proto_b.decrypt_index(proto_b.index(proto_b.encrypt_query(query)))
    assert sorted(idx_nb) == sorted(idx_b)
    assert 0 in idx_nb


def test_faithful_grote_membership_matches_default():
    """faithful_grote computes-and-discards the alpha-norm colCipher in
    membership exactly like the reference (src/sender/sender_grote.cpp:23);
    the membership OUTPUT must be identical to the optimized default, and
    the segmented runner must materialize the dead work (it is returned as
    an output so XLA cannot DCE it)."""
    proto_f, query, db = _setup(2, faithful_grote=True)
    proto_d, _, _ = _setup(2)
    qf = proto_f.encrypt_query(query)
    qd = proto_d.encrypt_query(query)

    mem_f = proto_f.sender.run_membership(qf)
    mem_d = proto_d.sender.run_membership(qd)
    assert mem_f.scale == mem_d.scale
    np.testing.assert_array_equal(np.asarray(mem_f.data),
                                  np.asarray(mem_d.data))
    assert proto_f.decrypt_membership(mem_f) is True

    # segmented path: the faithful similarity segment exists and returns
    # the (scores, dead colCipher) pair
    import os
    if os.environ.get("IMTPU_FORCE_SEGMENTS"):
        keys = [k for k in getattr(proto_f.sender, "_segjits", {})
                if k and k[0] == "grote_faithful_sim"]
        assert keys, "faithful GROTE membership did not use the cost-" \
                     "faithful segment"
