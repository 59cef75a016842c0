"""Senders: server-side homomorphic similarity + compare pipelines for the
five approaches (reference src/sender/*.cpp; SURVEY.md section 2.3).

Design notes
------------
* The per-ciphertext OpenMP loops of the reference become **batched
  contractions**: a whole matrix of DB ciphertexts is multiplied against
  the (rotated/replicated) query with one deferred-reduction modular dot
  (`mont_dot`) over the ciphertext axis — one fused device kernel instead
  of 512 serialized EvalMultNoRelin calls.
* The diagonal approach (HyDia) defaults to a **BSGS split**: diagonals are
  pre-rotated at enrollment, so the sender runs ~sqrt(dim) hoisted baby
  rotations of the query plus one giant rotation per partial block — far
  fewer key-switches and rotation keys than the reference's 511 hoisted
  rotations (src/sender/sender_diag.cpp:14-26), with identical outputs.
* Identical (limbs, scale) metadata across a batch lets jax.vmap run the
  deep compare circuit once over all score ciphertexts.
"""

from __future__ import annotations

import math
from typing import List, Sequence

import numpy as np
import jax
import jax.numpy as jnp

from ..ckks.context import CkksContext, Ciphertext
from ..ckks import poly_eval
from ..ops import modmath as mm
from . import packing
from .config import MatchConfig
from .enrollers import BaseDB, BlindDB, DiagDB, HersDB


def _sim_chunk() -> int:
    """Width cap for batched per-ciphertext pipelines (raw scores, merge
    chains): HLO temps scale with the vmap width, and 512-wide stacks at
    2^14 exceed HBM at compile time.  Overridable via IMTPU_SIM_CHUNK."""
    import os
    return int(os.environ.get("IMTPU_SIM_CHUNK", "128"))


def _mod_sum_rows(rows: jnp.ndarray, q) -> jnp.ndarray:
    """Sum a small stack of residue arrays mod q (row count is static)."""
    acc = rows[0]
    for i in range(1, rows.shape[0]):
        acc = mm.mod_add(acc, rows[i], q)
    return acc


def ct_dot(ctx: CkksContext, A: jnp.ndarray, B: jnp.ndarray) -> jnp.ndarray:
    """Sum_k A_k (x) B_k for stacks of 2-component ciphertexts
    [K, 2, l, N] -> unrelinearized 3-component data [3, l, N].

    This is the hot kernel of every similarity computation — the device
    equivalent of the loops at reference src/sender/sender_diag.cpp:85-94 /
    sender_hers.cpp:61-84.  Mismatched levels are aligned by dropping the
    higher operand's top limbs (free modulus reduction)."""
    l = min(A.shape[-2], B.shape[-2])
    A = A[..., :l, :]
    B = B[..., :l, :]
    lim = ctx.q_limbs(l)
    q, qneg = ctx._qrow(lim)
    p16 = ctx.pow16[:, :l][:, :, None]
    a0, a1 = A[:, 0], A[:, 1]
    b0, b1 = B[:, 0], B[:, 1]
    c0 = mm.mont_dot(a0, b0, 0, q, qneg, p16)
    c2 = mm.mont_dot(a1, b1, 0, q, qneg, p16)
    c1 = mm.mont_dot(
        jnp.concatenate([a0, a1], axis=0),
        jnp.concatenate([b1, b0], axis=0),
        0, q, qneg, p16,
    )
    return jnp.stack([c0, c1, c2])


class Sender:
    """Abstract sender (reference include/sender.h:19-43)."""

    def __init__(self, ctx: CkksContext, cfg: MatchConfig, num_vectors: int):
        self.ctx = ctx
        self.cfg = cfg
        self.num_vectors = num_vectors

    # -- shared helpers -------------------------------------------------

    def _compare_many(self, scores: List[Ciphertext]) -> List[Ciphertext]:
        """chebyshevCompare over a batch of same-shape score ciphertexts."""
        return self._compare_many_with(scores, self.cfg.match_threshold)

    def _compare_many_with(self, scores: List[Ciphertext], thr: float) -> List[Ciphertext]:
        ctx, cfg = self.ctx, self.cfg
        if len(scores) == 1:
            return [poly_eval.chebyshev_compare(ctx, scores[0], thr, cfg.comp_depth)]
        scale = scores[0].scale
        box = [None]

        def body(data):
            out = poly_eval.chebyshev_compare(
                ctx, Ciphertext(data, scale), thr, cfg.comp_depth
            )
            box[0] = out.scale
            return out.data

        stacked = jnp.stack([s.data for s in scores])
        res = jax.vmap(body)(stacked)
        return [Ciphertext(res[i], box[0]) for i in range(len(scores))]

    def _membership_reduce(self, flags: List[Ciphertext]) -> Ciphertext:
        """EvalAddManyInPlace + EvalSum(batch) (e.g. reference
        src/sender/sender_diag.cpp:44-47)."""
        ctx = self.ctx
        acc = flags[0]
        for f in flags[1:]:
            acc = ctx.add(acc, f)
        return ctx.eval_sum(acc, ctx.slots)

    def compute_similarity(self, query: List[Ciphertext]) -> List[Ciphertext]:
        raise NotImplementedError

    def membership_scenario(self, query: List[Ciphertext]) -> Ciphertext:
        scores = self.compute_similarity(query)
        flags = self._compare_many(scores)
        return self._membership_reduce(flags)

    def index_scenario(self, query: List[Ciphertext]) -> List[Ciphertext]:
        scores = self.compute_similarity(query)
        return self._compare_many(scores)

    def required_rotations(self) -> List[int]:
        """Rotation indices whose keys must exist (power-of-two keys are
        always generated separately, matching reference src/main.cpp:195-206)."""
        return []

    # -- jitted end-to-end runners (one XLA program per scenario; eager
    # per-op dispatch would launch thousands of tiny device calls) -------

    def scenario_runner(self, kind: str):
        if not hasattr(self, "_runners"):
            self._runners = {}
        if kind not in self._runners:
            meta = {}

            def fn(state, qstack, dbd):
                old = self.db.data
                self.db.data = dbd
                try:
                    with self.ctx.bound_state(state):
                        qcts = [
                            Ciphertext(qstack[i], self.ctx.fresh_scale)
                            for i in range(qstack.shape[0])
                        ]
                        if kind == "membership":
                            out = self.membership_scenario(qcts)
                            meta["scales"] = [out.scale]
                            return out.data
                        outs = self.index_scenario(qcts)
                        meta["scales"] = [o.scale for o in outs]
                        return tuple(o.data for o in outs)
                finally:
                    self.db.data = old

            self._runners[kind] = (jax.jit(fn), meta)
        return self._runners[kind]

    # -- segmented execution: several mid-size jits instead of one giant
    # graph.  Segments compile faster and are shared: membership and index
    # reuse the similarity and compare segments, and approaches with equal
    # shapes reuse compare compilations.  On CPU the monolithic jit is kept
    # (tests exercise the single-program path). ------------------------

    def _use_segments(self) -> bool:
        import os
        if os.environ.get("IMTPU_FORCE_SEGMENTS"):
            return True
        return jax.default_backend() != "cpu"

    def _seg(self, key, builder):
        """Cached jitted segment: builder(meta) -> traceable fn.  The meta
        dict is created once per cache entry and populated during the
        first trace (static scales/levels), then reused."""
        if not hasattr(self, "_segjits"):
            self._segjits = {}
        if key not in self._segjits:
            meta = {}
            self._segjits[key] = (jax.jit(builder(meta)), meta)
        return self._segjits[key]

    def _similarity_segment(self, qstack, dbd):
        def builder(meta):
            def fn(state, qs, db):
                old = self.db.data
                self.db.data = db
                try:
                    with self.ctx.bound_state(state):
                        qcts = [
                            Ciphertext(qs[i], self.ctx.fresh_scale)
                            for i in range(qs.shape[0])
                        ]
                        scores = self.compute_similarity(qcts)
                        meta["scale"] = scores[0].scale
                        return jnp.stack([s.data for s in scores])
                finally:
                    self.db.data = old
            return fn

        fn, meta = self._seg(("sim", qstack.shape), builder)
        return fn(self.ctx.device_state(), qstack, dbd), meta

    def similarity(self, query_cts: List[Ciphertext]) -> List[Ciphertext]:
        """compute_similarity through the jitted similarity segment the
        scenarios share (eager dispatch would launch one device call per
        primitive)."""
        qstack = jnp.stack([c.data for c in query_cts])
        sdata, meta = self._similarity_segment(qstack, self.db.data)
        return [Ciphertext(sdata[i], meta["scale"])
                for i in range(sdata.shape[0])]

    def _compare_segments(self, sdata, scale: float, thr: float, state=None):
        """[G, 2, l, N] scores -> (flag stack, flag scale) via three
        vmapped jit segments (basis build / series / f4).  Large stacks are
        processed in fixed-size chunks so the Chebyshev basis (~deg/2
        ciphertexts per score) stays within the device memory left next to
        a resident streamed DB (IMTPU_COMPARE_CHUNK, default 16).  `state`
        is the device state to run with (default: the context's own; a
        mesh passes its replicated copy)."""
        import os
        G = sdata.shape[0]
        chunk = int(os.environ.get("IMTPU_COMPARE_CHUNK", "16"))
        if G > chunk:
            outs = []
            fscale = None
            for i in range(0, G, chunk):
                out, fscale = self._compare_segments(
                    sdata[i : i + chunk], scale, thr, state)
                outs.append(out)
            return jnp.concatenate(outs, axis=0), fscale
        ctx, cfg = self.ctx, self.cfg
        if state is None:
            state = ctx.device_state()
        degree = poly_eval.DEPTH_TO_DEGREE[cfg.comp_depth]
        coeffs = poly_eval.chebyshev_coefficients(
            lambda v: 1.0 if v >= thr else -1.0, degree
        )
        kbase = (thr, scale, sdata.shape)

        def b_basis(meta):
            def fn(state, stack):
                with ctx.bound_state(state):
                    def one(d):
                        datas, m = poly_eval.compare_stage_basis(
                            ctx, Ciphertext(d, scale), degree, coeffs
                        )
                        meta.update(m)
                        return datas
                    return jax.vmap(one)(stack)
            return fn

        fnB, metaB = self._seg(("cmp_basis",) + kbase, b_basis)
        bstacks = fnB(state, sdata)

        def b_series(meta):
            def fn(state, stacks):
                with ctx.bound_state(state):
                    def one(*datas):
                        y = poly_eval.compare_stage_series(ctx, datas, metaB, coeffs)
                        meta["scale"] = y.scale
                        return y.data
                    return jax.vmap(one)(*stacks)
            return fn

        fnS, metaS = self._seg(("cmp_series",) + kbase, b_series)
        ystack = fnS(state, bstacks)

        def b_f4(meta):
            def fn(state, ys):
                with ctx.bound_state(state):
                    def one(d):
                        out = poly_eval.compare_stage_f4(
                            ctx, Ciphertext(d, metaS["scale"])
                        )
                        meta["scale"] = out.scale
                        return out.data
                    return jax.vmap(one)(ys)
            return fn

        fnF, metaF = self._seg(("cmp_f4",) + kbase, b_f4)
        return fnF(state, ystack), metaF["scale"]

    def _reduce_segment(self, fstack, fscale: float):
        def builder(meta):
            def fn(state, fs):
                with self.ctx.bound_state(state):
                    flags = [
                        Ciphertext(fs[i], fscale) for i in range(fs.shape[0])
                    ]
                    out = self._membership_reduce(flags)
                    meta["scale"] = out.scale
                    return out.data
            return fn

        fn, meta = self._seg(("reduce", fscale, fstack.shape), builder)
        return fn(self.ctx.device_state(), fstack), meta

    def run_membership(self, query_cts: List[Ciphertext]) -> Ciphertext:
        qstack = jnp.stack([c.data for c in query_cts])
        if not self._use_segments():
            fn, meta = self.scenario_runner("membership")
            data = fn(self.ctx.device_state(), qstack, self.db.data)
            return Ciphertext(data, meta["scales"][0])
        sdata, smeta = self._similarity_segment(qstack, self.db.data)
        fstack, fscale = self._compare_segments(
            sdata, smeta["scale"], self.cfg.match_threshold
        )
        data, meta = self._reduce_segment(fstack, fscale)
        return Ciphertext(data, meta["scale"])

    def run_index(self, query_cts: List[Ciphertext]) -> List[Ciphertext]:
        qstack = jnp.stack([c.data for c in query_cts])
        if not self._use_segments():
            fn, meta = self.scenario_runner("index")
            datas = fn(self.ctx.device_state(), qstack, self.db.data)
            return [Ciphertext(d, s) for d, s in zip(datas, meta["scales"])]
        sdata, smeta = self._similarity_segment(qstack, self.db.data)
        fstack, fscale = self._compare_segments(
            sdata, smeta["scale"], self.cfg.match_threshold
        )
        return [Ciphertext(fstack[i], fscale) for i in range(fstack.shape[0])]


class HersSender(Sender):
    """Approach 4 (reference src/sender/sender_hers.cpp): dimension-major
    DB; score(m) = sum_j q_j (*) d_{m,j}."""

    def __init__(self, ctx, cfg, db: HersDB):
        super().__init__(ctx, cfg, db.num_vectors)
        self.db = db

    def compute_similarity(self, query: List[Ciphertext]) -> List[Ciphertext]:
        ctx = self.ctx
        if self.cfg.hers_alt_query and len(query) == 1:
            # encryptQueryAlt flow: expand the single replicated-query
            # ciphertext server-side (reference sender_hers.cpp:101-115)
            query = expand_query_alt(ctx, self.cfg, query[0])
        Q = jnp.stack([c.data for c in query])  # [dim, 2, l, N]
        sq = query[0].scale
        scores = []
        for m in range(self.db.data.shape[0]):
            if self.cfg.faithful_hers:
                # per-term relin+rescale "to match HERS paper approach"
                # (reference src/sender/sender_hers.cpp:70-72)
                def per_term(qd, dd):
                    prod = ctx.mul(
                        Ciphertext(qd, sq), Ciphertext(dd, self.db.scale)
                    )
                    out = ctx.rescale_score(ctx.relinearize(prod))
                    return out.data, out.scale
                outs = []
                out_scale = None
                for j in range(Q.shape[0]):
                    d, out_scale = per_term(Q[j], self.db.data[m, j])
                    outs.append(d)
                acc = outs[0]
                q, _ = ctx._qrow(ctx.q_limbs(acc.shape[-2]))
                for d in outs[1:]:
                    acc = mm.mod_add(acc, d, q)
                scores.append(Ciphertext(acc, out_scale))
            else:
                t3 = ct_dot(ctx, Q, self.db.data[m])
                ct = Ciphertext(t3, sq * self.db.scale)
                scores.append(ctx.rescale_score(ctx.relinearize(ct)))
        return scores


def generate_query_helper(ctx: CkksContext, cfg: MatchConfig,
                          query_ct: Ciphertext, index: int) -> Ciphertext:
    """Server-side expansion of a single replicated-query ciphertext into
    the dimension-major form: mask feature `index`, rescale, then EvalSum
    over vector_dim to fill all slots (reference generateQueryHelper,
    src/sender/sender_hers.cpp:101-115).  Lets a HERS-style sender accept
    the 1-ciphertext query of approach 1/5 (encryptQueryAlt,
    reference receiver_hers.cpp:66-77)."""
    import numpy as np

    batch = ctx.slots
    mask = np.zeros(batch)
    mask[index::cfg.vector_dim] = 1.0
    pt = ctx.encode_cached(("qh_mask", cfg.vector_dim, index), mask,
                           query_ct.limbs, ctx.params.scale)
    out = ctx.mul_plain(query_ct, pt)
    out = ctx.eval_sum(out, cfg.vector_dim)  # rotations pre-rescale
    return ctx.rescale(out)


def expand_query_alt(ctx: CkksContext, cfg: MatchConfig,
                     qct: Ciphertext) -> List[Ciphertext]:
    """All vector_dim generate_query_helper expansions as one vmapped
    mask-multiply + scanned EvalSum — the batched form of the
    reference's per-feature loop (src/sender/sender_hers.cpp:101-115)."""
    from ..ckks.context import Plaintext

    dim = cfg.vector_dim
    batch = ctx.slots
    sc = ctx.params.scale
    pt_rows = []
    for j in range(dim):
        mask = np.zeros(batch)
        mask[j::dim] = 1.0
        pt_rows.append(
            ctx.encode_cached(("qh_mask", dim, j), mask, qct.limbs, sc).data)
    pt_stack = jnp.asarray(np.stack(pt_rows))  # [dim, l, N]
    box = [None]

    def one(pt_data):
        out = ctx.mul_plain(qct, Plaintext(pt_data, sc))
        out = ctx.eval_sum(out, dim)  # rotations pre-rescale
        out = ctx.rescale(out)
        box[0] = out.scale
        return out.data

    res = jax.vmap(one)(pt_stack)
    return [Ciphertext(res[j], box[0]) for j in range(dim)]


class BaseSender(Sender):
    """Approach 1 (reference src/sender/sender_base.cpp): sequential DB,
    EvalInnerProduct per batch, then order-preserving merge."""

    def __init__(self, ctx, cfg, db: BaseDB):
        super().__init__(ctx, cfg, db.num_vectors)
        self.db = db

    def required_rotations(self) -> List[int]:
        # direct keys for the merge chain: one keyswitch per step instead
        # of the signed power-of-two decomposition (ctx.rotate_any)
        return packing.merge_chain_rotations(self.ctx.slots,
                                             self.cfg.vector_dim)

    def _raw_scores(self, query: List[Ciphertext]) -> List[Ciphertext]:
        ctx, dim = self.ctx, self.cfg.vector_dim
        qct = query[0]
        box = [None]

        def per_batch(dbd):
            prod = ctx.mul(qct, Ciphertext(dbd, self.db.scale))
            r = ctx.relinearize(prod)
            # EvalSum BEFORE rescaling: its log2(dim) rotate-add chain
            # amplifies each keyswitch's noise by ~dim; running it at the
            # full product scale (Delta^3) instead of Delta keeps that
            # noise ~2^-60 below slot values.  Same level consumption —
            # deferring rescales is free under exact scale tracking.
            # (Measured at ring 32768: raw-score max|err| 6.6e-3 -> <1e-4.)
            r = ctx.eval_sum(r, dim)
            r = ctx.rescale_score(r)
            box[0] = r.scale
            return r.data

        B = self.db.data.shape[0]
        if B == 1:
            res = per_batch(self.db.data[0])[None]
        else:
            # bounded-width batching: a flat vmap over 512 batch
            # ciphertexts keeps every intermediate of the keyswitch-heavy
            # EvalSum chain live at once (~29 GB HLO temps at 2^14,
            # observed compile-time OOM); lax.map's batch_size sequences
            # fixed-width chunks inside one jit, bounding temps to a
            # chunk's worth while keeping the graph compact
            chunk = _sim_chunk()
            if B > chunk:
                res = jax.lax.map(per_batch, self.db.data, batch_size=chunk)
            else:
                res = jax.vmap(per_batch)(self.db.data)
        return [Ciphertext(res[i], box[0]) for i in range(B)]

    def compute_similarity(self, query: List[Ciphertext]) -> List[Ciphertext]:
        scores = self._raw_scores(query)
        return packing.merge_ciphers(self.ctx, scores, self.cfg.vector_dim)


class GroteSender(BaseSender):
    """Approach 2 (reference src/sender/sender_grote.cpp): baseline scores
    + alpha-norm group testing over a near-square arrangement."""

    def required_rotations(self) -> List[int]:
        # base merge chain + the alpha-row merge chain (row_len dimension)
        row_len = 2 ** math.ceil(math.log2(self.ctx.slots) / 2)
        return sorted(set(
            BaseSender.required_rotations(self)
            + packing.merge_chain_rotations(self.ctx.slots, row_len)))

    def _alpha_squares(self, ct: Ciphertext) -> Ciphertext:
        ctx = self.ctx
        for _ in range(self.cfg.alpha_depth):
            ct = ctx.rescale(ctx.relinearize(ctx.square(ct)))
        return ct

    def alpha_norm_rows(self, scores: List[Ciphertext], row_len: int) -> List[Ciphertext]:
        """reference alphaNormRows (src/sender/sender_hers.cpp:118-132)."""
        ctx = self.ctx
        box = [None]

        def one(data):
            s = Ciphertext(data, scores[0].scale)
            a = self._alpha_squares(s)
            l = min(a.limbs, s.limbs)
            prod = ctx.mul_relin(ctx.drop_to(a, l), ctx.drop_to(s, l))
            # EvalSum before rescale: rotate-add noise suppressed by the
            # product scale (see BaseSender._raw_scores)
            prod = ctx.eval_sum(prod, row_len)
            prod = ctx.rescale(prod)
            box[0] = prod.scale
            return prod.data

        stacked = jnp.stack([s.data for s in scores])
        res = jax.vmap(one)(stacked) if len(scores) > 1 else one(stacked[0])[None]
        alist = [Ciphertext(res[i], box[0]) for i in range(len(scores))]
        return packing.merge_ciphers(ctx, alist, row_len)

    def alpha_norm_columns(self, scores: List[Ciphertext], row_len: int) -> List[Ciphertext]:
        """reference alphaNormColumns (src/sender/sender_hers.cpp:136-178)."""
        ctx = self.ctx
        batch = ctx.slots
        box = [None]
        rmask = np.zeros(batch)
        rmask[:row_len] = 1.0

        def one(data):
            s = Ciphertext(data, scores[0].scale)
            a = self._alpha_squares(s)
            l = min(a.limbs, s.limbs)
            a = ctx.mul_relin(ctx.drop_to(a, l), ctx.drop_to(s, l))
            # the doubling rotate-add chain (batch/row_len partial sums)
            # runs at the un-rescaled product scale — its keyswitch noise
            # otherwise amplifies ~batch/row_len-fold and swamps the
            # alpha-compare threshold (0.44^4)
            j = row_len
            while j < batch:
                a = ctx.add(a, ctx.binary_rotate(a, -j))
                j *= 2
            m = ctx.encode_cached(("grote_rowmask", row_len), rmask, a.limbs,
                                  ctx.params.scale)
            a = ctx.mul_plain(a, m)
            a = ctx.rescale(ctx.rescale(a))
            box[0] = a.scale
            return a.data

        stacked = jnp.stack([s.data for s in scores])
        res = jax.vmap(one)(stacked) if len(scores) > 1 else one(stacked[0])[None]
        alist = [Ciphertext(res[i], box[0]) for i in range(len(scores))]
        # pack alpha values consecutively: uniform -(i*row_len) amounts ->
        # pairwise combine tree, one fixed power-of-two keyswitch per
        # level over a halving stack (packing._tree_pack)
        out_n = math.ceil(len(scores) * row_len / batch)
        if len(alist) == 1:
            return alist
        return packing._tree_pack(ctx, alist, row_len, out_n)

    def membership_scenario(self, query: List[Ciphertext]) -> Ciphertext:
        ctx = self.ctx
        batch = ctx.slots
        row_len = 2 ** math.ceil(math.log2(batch) / 2)
        scores = self.compute_similarity(query)
        if self.cfg.faithful_grote:
            # reference computes colCipher here and never uses it
            # (src/sender/sender_grote.cpp:23).  In eager mode this is real
            # discarded work; under jit XLA would DCE it, so the segmented
            # run_membership below returns it as an output instead.
            self.alpha_norm_columns(scores, row_len)
        flags = self._compare_many(scores)
        return self._membership_reduce(flags)

    def run_membership(self, query_cts: List[Ciphertext]) -> Ciphertext:
        """Cost-faithful membership for benchmarking: when
        cfg.faithful_grote is set, the similarity segment also computes the
        dead colCipher (reference src/sender/sender_grote.cpp:23) and
        returns it as a materialized output (so XLA cannot eliminate it);
        the host blocks on it and discards it — the timed run pays exactly
        the work the reference's published GROTE membership numbers pay."""
        if not self.cfg.faithful_grote:
            return Sender.run_membership(self, query_cts)
        ctx = self.ctx
        qstack = jnp.stack([c.data for c in query_cts])
        batch = ctx.slots
        row_len = 2 ** math.ceil(math.log2(batch) / 2)
        if not self._use_segments():
            # monolithic jit (CPU / segments off): the dead colCipher must
            # still be a materialized jit OUTPUT, else XLA DCEs it and the
            # "cost-faithful" timing silently omits the work (advisor r4).
            def builder(meta):
                def fn(state, qs, db):
                    old = self.db.data
                    self.db.data = db
                    try:
                        with ctx.bound_state(state):
                            qcts = [
                                Ciphertext(qs[i], ctx.fresh_scale)
                                for i in range(qs.shape[0])
                            ]
                            scores = self.compute_similarity(qcts)
                            cols = self.alpha_norm_columns(scores, row_len)
                            flags = self._compare_many(scores)
                            out = self._membership_reduce(flags)
                            meta["scale"] = out.scale
                            return out.data, jnp.stack(
                                [c.data for c in cols])
                    finally:
                        self.db.data = old
                return fn

            fn, meta = self._seg(("grote_faithful_mono", qstack.shape),
                                 builder)
            data, dead_cols = fn(ctx.device_state(), qstack, self.db.data)
            jax.block_until_ready(dead_cols)  # materialized, then discarded
            return Ciphertext(data, meta["scale"])

        def builder(meta):
            def fn(state, qs, db):
                old = self.db.data
                self.db.data = db
                try:
                    with ctx.bound_state(state):
                        qcts = [
                            Ciphertext(qs[i], ctx.fresh_scale)
                            for i in range(qs.shape[0])
                        ]
                        scores = self.compute_similarity(qcts)
                        cols = self.alpha_norm_columns(scores, row_len)
                        meta["scale"] = scores[0].scale
                        return (
                            jnp.stack([s.data for s in scores]),
                            jnp.stack([c.data for c in cols]),
                        )
                finally:
                    self.db.data = old
            return fn

        fn, meta = self._seg(("grote_faithful_sim", qstack.shape), builder)
        sdata, dead_cols = fn(ctx.device_state(), qstack, self.db.data)
        fstack, fscale = self._compare_segments(
            sdata, meta["scale"], self.cfg.match_threshold)
        data, rmeta = self._reduce_segment(fstack, fscale)
        jax.block_until_ready(dead_cols)  # materialized, then discarded
        return Ciphertext(data, rmeta["scale"])

    def index_scenario(self, query: List[Ciphertext]) -> List[Ciphertext]:
        ctx = self.ctx
        batch = ctx.slots
        row_len = 2 ** math.ceil(math.log2(batch) / 2)
        scores = self.compute_similarity(query)
        rows = self.alpha_norm_rows(scores, row_len)
        cols = self.alpha_norm_columns(scores, row_len)
        thr = self.cfg.match_threshold
        for _ in range(self.cfg.alpha_depth):
            thr = thr * thr
        return self._compare_many_with(rows, thr) + self._compare_many_with(cols, thr)

    def run_index(self, query_cts: List[Ciphertext]) -> List[Ciphertext]:
        if not self._use_segments():
            return Sender.run_index(self, query_cts)
        ctx = self.ctx
        qstack = jnp.stack([c.data for c in query_cts])
        batch = ctx.slots
        row_len = 2 ** math.ceil(math.log2(batch) / 2)

        def builder(meta):
            def fn(state, qs, db):
                old = self.db.data
                self.db.data = db
                try:
                    with ctx.bound_state(state):
                        qcts = [
                            Ciphertext(qs[i], ctx.fresh_scale)
                            for i in range(qs.shape[0])
                        ]
                        scores = self.compute_similarity(qcts)
                        rows = self.alpha_norm_rows(scores, row_len)
                        cols = self.alpha_norm_columns(scores, row_len)
                        meta["r"] = rows[0].scale
                        meta["c"] = cols[0].scale
                        return (
                            jnp.stack([r.data for r in rows]),
                            jnp.stack([c.data for c in cols]),
                        )
                finally:
                    self.db.data = old
            return fn

        fn, meta = self._seg(("grote_alpha", qstack.shape), builder)
        rstack, cstack = fn(ctx.device_state(), qstack, self.db.data)
        thr = self.cfg.match_threshold
        for _ in range(self.cfg.alpha_depth):
            thr = thr * thr
        rf, rs = self._compare_segments(rstack, meta["r"], thr)
        cf, cs = self._compare_segments(cstack, meta["c"], thr)
        return [Ciphertext(rf[i], rs) for i in range(rf.shape[0])] + [
            Ciphertext(cf[i], cs) for i in range(cf.shape[0])
        ]


class BlindSender(Sender):
    """Approach 3 (reference src/sender/sender_blind.cpp): chunked DB,
    per-matrix chunk contraction + log rotate-add, then compression."""

    def __init__(self, ctx, cfg, db: BlindDB):
        super().__init__(ctx, cfg, db.num_vectors)
        self.db = db

    def compute_similarity(self, query: List[Ciphertext]) -> List[Ciphertext]:
        ctx, cl = self.ctx, self.cfg.chunk_len
        Q = jnp.stack([c.data for c in query])  # [cpv, 2, l, N]
        sq = query[0].scale
        box = [None]

        def per_matrix(dbd):
            t3 = ct_dot(ctx, Q, dbd)
            ct = ctx.relinearize(Ciphertext(t3, sq * self.db.scale))
            # log rotate-add over the chunk (scanned power-of-two rotations,
            # reference src/sender/sender_blind.cpp:76-81) at the full
            # product scale — see _raw_scores for the noise argument
            ct = ctx.eval_sum(ct, cl)
            ct = ctx.rescale_score(ct)
            box[0] = ct.scale
            return ct.data

        M = self.db.data.shape[0]
        if M == 1:
            res = per_matrix(self.db.data[0])[None]
        else:
            res = jax.vmap(per_matrix)(self.db.data)
        scores = [Ciphertext(res[i], box[0]) for i in range(M)]
        return packing.compress_ciphers(ctx, scores, cl)


class DiagonalSender(Sender):
    """Approach 5, HyDia (reference src/sender/sender_diag.cpp): diagonal
    matrix-vector products with hoisted rotations; BSGS variant by default."""

    def __init__(self, ctx, cfg, db: DiagDB):
        super().__init__(ctx, cfg, db.num_vectors)
        self.db = db

    def required_rotations(self) -> List[int]:
        dim = self.cfg.vector_dim
        if self.db.bsgs:
            n1 = self.db.n1
            n2 = dim // n1
            return list(range(1, n1)) + [n1 * j for j in range(1, n2)]
        return list(range(1, dim))

    def compute_similarity(self, query: List[Ciphertext]) -> List[Ciphertext]:
        ctx, dim = self.ctx, self.cfg.vector_dim
        qct = query[0]
        if self.db.bsgs:
            n1 = self.db.n1
        else:
            n1 = dim
        n2 = dim // n1
        sq = qct.scale
        l = qct.limbs
        q, _ = ctx._qrow(ctx.q_limbs(l))
        digs = ctx.hoisted_precompute(qct)
        # all baby rotations of the query: ONE vmapped hoisted keyswitch
        if n1 > 1:
            rot = ctx.hoisted_rotate_stack(qct, digs, list(range(1, n1)))
            Q = jnp.concatenate([qct.data[None], rot], axis=0)
        else:
            Q = qct.data[None]
        box = [None]

        def per_group(dbd):  # dbd: [dim, 2, l, N]
            if n2 == 1:
                t3 = ct_dot(ctx, Q, dbd)
                out = ctx.rescale_score(
                    ctx.relinearize(Ciphertext(t3, sq * self.db.scale))
                )
            else:
                blocks = dbd.reshape(n2, n1, *dbd.shape[1:])
                # all inner sums: one vmapped contraction + relin body
                t3 = jax.vmap(lambda blk: ct_dot(ctx, Q, blk))(blocks)
                prod_scale = sq * self.db.scale
                inners = jax.vmap(
                    lambda d: ctx.relinearize(Ciphertext(d, prod_scale)).data
                )(t3)  # [n2, 2, l, N]
                # giant rotations: one vmapped keyswitch over stacked rows
                rot = ctx.rotate_stack(
                    inners[1:], [n1 * j for j in range(1, n2)], prod_scale
                )
                summed = mm.mod_add(inners[0], _mod_sum_rows(rot, q), q)
                out = ctx.rescale_score(Ciphertext(summed, prod_scale))
            box[0] = out.scale
            return out.data

        G = self.db.data.shape[0]
        if G == 1:
            res = per_group(self.db.data[0])[None]
        else:
            res = jax.lax.map(per_group, self.db.data)
        return [Ciphertext(res[i], box[0]) for i in range(G)]


def make_sender(approach: int, ctx: CkksContext, cfg: MatchConfig, db) -> Sender:
    cls = {1: BaseSender, 2: GroteSender, 3: BlindSender, 4: HersSender,
           5: DiagonalSender}[approach]
    return cls(ctx, cfg, db)
