#!/usr/bin/env python
"""Smoke test of the encrypted-matching system on one NVIDIA GPU, at
production parameters (ring 32768, HEStd-128-classic, 512-dim embeddings,
COMP_DEPTH 10) with a random key and a synthetic planted-match gallery
made from a seed.

  python chip_smoke.py           # one card: phases native, a-d
  python chip_smoke.py --others  # one card: phases native, a, e only
  python chip_smoke.py --four    # four cards: the sharded path and the
                                 # one-card path it is compared with, only

--four runs approach 5 at 2^16 (one group per card) through
ShardedStreamedScenario here, while two child processes (--four-side) run
ShardedScenario on the same four cards and the one-card
StreamedDiagonalSender on card 0, on the same seeded key and gallery; every
flag ciphertext must be bit-identical to the one-card one.  The three
compile at once, each in its share of the cards' memory.

Phases (each prints one JSON line: phase, ok, seconds, card, details):
  native  rebuild the host library from native/imtpu_native.cpp
  a       JAX's first device is a GPU (no CPU fallback)
  b       kernel parity at production widths, bit-exact against numpy:
          mont_mul, shoup_mul, ct_dot (mont_dot), NTT fwd/inv, one
          automorphism
  c       approach 5 (HyDia), streamed, 2^17 gallery: membership, index,
          scores against the plaintext cosine
  d       approach 4 (HERS), streamed, 2^15 gallery with every group in
          pinned host memory; pinned->device GB/s
  e       approaches 1, 2, 3 in memory at 2^10 (--others: each compiles
          for minutes, so a-e together outrun a 20-minute budget)
The first failed phase ends the run with a non-zero exit and no result
line.  The last line is {"ok": true, "device": {...}}.
"""

import argparse
import gc
import json
import os
import sys
import time
import traceback

import numpy as np

RING = 32768
BATCH = 64          # ciphertexts per kernel call, as in tools/kernel_bench.py
SCORE_TOL = 1e-4    # CKKS approximation error of a score vs plaintext cosine


# -- configuration ------------------------------------------------------------

def production_params(approach: int, ring: int = RING, cfg=None):
    from image_matching.ckks.params import SchemeParams, compute_required_depth
    from image_matching.matching.config import MatchConfig
    cfg = cfg or MatchConfig()
    depth = compute_required_depth(approach, cfg.comp_depth, cfg.alpha_depth)
    return SchemeParams.create(ring_dim=ring, mult_depth=depth,
                               security="128c" if ring >= 32768 else "none")


def make_context(approach: int, ring: int = RING, cfg=None, seed: int = 0):
    from image_matching.ckks.context import CkksContext
    return CkksContext(production_params(approach, ring, cfg), seed=seed)


# -- phase (a) ------------------------------------------------------------------

def check_device(devices) -> dict:
    """Refuse anything but a GPU."""
    from image_matching.utils import device
    device.require_gpu(devices)
    return device.describe(devices)


# -- phase (b) ------------------------------------------------------------------

def _memory_analysis(jf, *args) -> dict:
    ma = jf.lower(*args).compile().memory_analysis()
    if ma is None:
        return {}
    return {k: int(getattr(ma, k)) for k in dir(ma)
            if k.endswith("_in_bytes") and not k.startswith("_")}


def kernel_parity(ctx, batch: int = BATCH, seed: int = 0) -> dict:
    """Device kernels vs numpy uint64 references over the context's full
    limb chain (ciphertext primes plus key-switching primes), bit-exact.
    Raises AssertionError on the first mismatch."""
    import jax
    import jax.numpy as jnp
    from image_matching.matching.senders import ct_dot
    from image_matching.ops import modmath as mm
    from image_matching.ops.ntt import host_ntt_fwd, host_ntt_inv

    rng = np.random.default_rng(seed)
    N = ctx.n
    lim = tuple(range(ctx.Ltot))
    qcol = np.asarray(ctx.all_primes, np.uint64)[:, None]          # [L, 1]
    rinv = np.array([pow(1 << 32, -1, int(q)) for q in ctx.all_primes],
                    np.uint64)[:, None]
    state = ctx.device_state()
    x = (rng.integers(0, 1 << 62, (batch, ctx.Ltot, N), dtype=np.uint64)
         % qcol).astype(np.uint32)
    y = (rng.integers(0, 1 << 62, (batch, ctx.Ltot, N), dtype=np.uint64)
         % qcol).astype(np.uint32)
    xd, yd = jnp.asarray(x), jnp.asarray(y)
    out = {}

    def mont_mul_k(s, a, b):
        with ctx.bound_state(s):
            q, qneg = ctx._qrow(lim)
            return mm.mont_mul(a, b, q, qneg)

    got = np.asarray(jax.jit(mont_mul_k)(state, xd, yd))
    # a * b * R^-1 mod q in uint64 (every product of residues < 2^62)
    want = x.astype(np.uint64) * y.astype(np.uint64) % qcol * rinv % qcol
    assert np.array_equal(got, want.astype(np.uint32)), "mont_mul mismatch"

    w = (rng.integers(0, 1 << 62, (ctx.Ltot, 1), dtype=np.uint64)
         % qcol).astype(np.uint32)
    w_sh = np.concatenate([mm.host_shoup(w[i], int(q))[None]
                           for i, q in enumerate(ctx.all_primes)])

    def shoup_k(s, a, w_, wsh):
        with ctx.bound_state(s):
            q, _ = ctx._qrow(lim)
            return mm.shoup_mul(a, w_, wsh, q)

    got = np.asarray(jax.jit(shoup_k)(state, xd, jnp.asarray(w),
                                      jnp.asarray(w_sh)))
    want = x.astype(np.uint64) * w.astype(np.uint64) % qcol
    assert np.array_equal(got, want.astype(np.uint32)), "shoup_mul mismatch"

    # ct_dot: [K, 2, l, N] x [K, 2, l, N] -> [3, l, N] over the Q chain
    l = ctx.Lq
    A, B = ((rng.integers(0, 1 << 62, (batch, 2, l, N), dtype=np.uint64)
             % qcol[:l]).astype(np.uint32) for _ in range(2))

    def ct_dot_k(s, a, b):
        with ctx.bound_state(s):
            return ct_dot(ctx, a, b)

    jf = jax.jit(ct_dot_k)
    got = np.asarray(jf(state, jnp.asarray(A), jnp.asarray(B)))
    A64, B64 = A.astype(np.uint64), B.astype(np.uint64)
    ql, rl = qcol[:l], rinv[:l]

    def dot(u, v):  # sum_k u_k v_k R^-1 mod q (each term < q, K < 2^32)
        return (u * v % ql).sum(axis=0) % ql * rl % ql

    want = np.stack([dot(A64[:, 0], B64[:, 0]),
                     (dot(A64[:, 0], B64[:, 1]) + dot(A64[:, 1], B64[:, 0])) % ql,
                     dot(A64[:, 1], B64[:, 1])])
    assert np.array_equal(got, want.astype(np.uint32)), "ct_dot mismatch"
    out["ct_dot_memory"] = _memory_analysis(jf, state, jnp.asarray(A),
                                            jnp.asarray(B))

    def fwd_k(s, a):
        with ctx.bound_state(s):
            return ctx.plan.fwd(a, lim)

    def inv_k(s, a):
        with ctx.bound_state(s):
            return ctx.plan.inv(a, lim)

    jfwd, jinv = jax.jit(fwd_k), jax.jit(inv_k)
    got_f = np.asarray(jfwd(state, xd))
    got_i = np.asarray(jinv(state, xd))
    ninv = np.asarray(ctx.plan.ninv)
    for i, q in enumerate(ctx.all_primes):
        hf = host_ntt_fwd(x[:, i].astype(np.uint64), int(q), ctx.plan.psis_np[i])
        assert np.array_equal(got_f[:, i], hf.astype(np.uint32)), \
            f"ntt fwd mismatch, limb {i}"
        hi = host_ntt_inv(x[:, i].astype(np.uint64), int(q),
                          ctx.plan.ipsis_np[i], int(ninv[i]))
        assert np.array_equal(got_i[:, i], hi.astype(np.uint32)), \
            f"ntt inv mismatch, limb {i}"
    out["ntt_fwd_memory"] = _memory_analysis(jfwd, state, xd)

    # automorphism X -> X^g (rotation by one slot) against the coefficient
    # domain: b[j*g mod 2N] = +-a[j], negated where the exponent wraps N
    g = ctx.rotation_galois(1)
    a = x[0].astype(np.int64)                                   # [L, N]
    e = np.arange(N, dtype=np.int64) * g % (2 * N)
    b = np.zeros_like(a)
    b[:, e % N] = np.where(e < N, a, -a)
    b = np.mod(b, qcol.astype(np.int64)).astype(np.uint32)
    perm = jnp.asarray(ctx.plan.auto_perm(g))

    def auto_k(s, c):
        with ctx.bound_state(s):
            return ctx.plan.inv(jnp.take(ctx.plan.fwd(c, lim), perm, axis=-1),
                                lim)

    got = np.asarray(jax.jit(auto_k)(state, xd[0]))
    assert np.array_equal(got, b), "automorphism mismatch"
    out.update({"ring": N, "limbs": ctx.Ltot, "batch": batch, "galois": g})
    return out


# -- phases (c)-(e) -------------------------------------------------------------

def _peak_bytes():
    import jax
    return (jax.devices()[0].memory_stats() or {}).get("peak_bytes_in_use")


def _timed(fn):
    import jax
    t0 = time.perf_counter()
    out = fn()
    jax.block_until_ready(out)
    return out, time.perf_counter() - t0


def main_path(approach: int, log2n: int, streamed: bool, ctx=None, cfg=None,
              seed: int = 0, steady_reps: int = 2, **stream_kw) -> dict:
    """Enroll a planted-match gallery, encrypt the query, run membership and
    index through MatchingProtocol, decrypt, and check them and the raw
    scores against the plaintext cosine oracle."""
    import jax
    from image_matching.matching import vector_utils as vu
    from image_matching.matching.config import MatchConfig
    from image_matching.matching.protocol import MatchingProtocol
    from image_matching.utils import io as dio

    cfg = cfg or MatchConfig()
    ctx = ctx or make_context(approach, cfg=cfg, seed=seed)
    query, db = dio.gen_dataset(1 << log2n, cfg.vector_dim, seed=seed)
    sims = vu.cosine_similarity(vu.normalize(query)[None, :], vu.normalize(db))
    expect = sorted(int(i) for i in np.nonzero(sims >= cfg.match_threshold)[0])

    t0 = time.perf_counter()
    proto = MatchingProtocol.setup(approach, db, cfg, ctx=ctx, seed=seed,
                                   streamed=streamed, **stream_kw)
    setup_s = time.perf_counter() - t0
    del db
    qcts = proto.encrypt_query(query)
    mem, first_s = _timed(lambda: proto.membership(qcts))
    steady = [_timed(lambda: proto.membership(qcts))[1]
              for _ in range(steady_reps)]
    member = proto.decrypt_membership(mem)
    idx_cts, index_s = _timed(lambda: proto.index(qcts))
    idx = sorted(proto.decrypt_index(idx_cts))
    scores = proto.receiver.decrypt_scores(proto.sender.similarity(qcts))
    err = float(np.max(np.abs(scores[: len(sims)] - sims)))
    out = {"approach": approach, "log2n": log2n, "streamed": streamed,
           "setup_s": setup_s, "compile_first_s": first_s, "steady_s": steady,
           "index_s": index_s, "membership": member, "index_hits": idx[:8],
           "max_score_err": err, "peak_bytes_in_use": _peak_bytes()}
    store = getattr(proto.sender, "store", None)
    if store is not None:
        out.update(groups=store.num_groups, resident=store.resident_count(),
                   pinned=store.pinned_count())
    assert member is True, "membership decrypted False"
    assert idx == expect and 0 in idx, f"index {idx[:8]} != oracle {expect[:8]}"
    assert err <= SCORE_TOL, f"score error {err} > {SCORE_TOL}"
    out["proto"] = proto
    return out


def pinned_h2d_rate(store) -> float:
    """Measured pinned-host -> device GB/s over every group of a store."""
    import jax
    from image_matching.matching import streaming
    dev = jax.devices()[0]
    sh = streaming._device_sharding(dev)
    nbytes, secs = 0, 0.0
    for grp in store.groups:
        _, dt = _timed(lambda: jax.device_put(grp, sh))
        nbytes += grp.nbytes
        secs += dt
    return nbytes / secs / 1e9


def phase_d(log2n: int = 15, **kw) -> dict:
    r = main_path(4, log2n, True, resident_budget=0, **kw)
    store = r.pop("proto").sender.store
    assert store.pinned_count() == store.num_groups, \
        f"{store.pinned_count()}/{store.num_groups} groups in pinned host memory"
    r["pinned_h2d_GBs"] = pinned_h2d_rate(store)
    return r


# -- --four ---------------------------------------------------------------------

FOUR_LOG2N = 16   # 4 groups: one per card
# each process's share of a card's memory: --four itself, and the two sides
# it starts (card 0 holds all three)
FOUR_MEM_FRACTION = {"four": "0.35", "sharded": "0.35", "one": "0.2"}


def _log(msg: str) -> None:
    print(f"# {time.strftime('%H:%M:%S')} {msg}", file=sys.stderr, flush=True)


def _digest(proto, qcts) -> str:
    """sha256 of the query ciphertexts and every gallery group: the inputs
    that a run in another process must share bit for bit."""
    import hashlib
    h = hashlib.sha256()
    for c in qcts:
        h.update(np.asarray(c.data).tobytes())
    for grp in proto.sender.store.groups:
        h.update(np.asarray(grp).tobytes())
    return h.hexdigest()


def streamed_gallery(log2n: int, ctx, cfg, seed: int = 0):
    """(protocol, encrypted query, set-up seconds) for approach 5 at
    2^log2n with every group in host memory, as the sharded streamed path
    needs it."""
    from image_matching.matching.protocol import MatchingProtocol
    from image_matching.utils import io as dio
    query, db = dio.gen_dataset(1 << log2n, cfg.vector_dim, seed=seed)
    t0 = time.perf_counter()
    proto = MatchingProtocol.setup(5, db, cfg, ctx=ctx, seed=seed,
                                   streamed=True, resident_budget=0)
    setup_s = time.perf_counter() - t0
    return proto, proto.encrypt_query(query), setup_s


def _side_result(run_membership, run_index, devices) -> dict:
    """Membership and index flags of one path as numpy arrays, with its
    compile+first and steady seconds and each card's peak memory."""
    mem, first_s = _timed(run_membership)
    _, steady_s = _timed(run_membership)
    idx = run_index()
    return {"membership": np.asarray(mem.data), "membership_scale": mem.scale,
            "index": np.stack([np.asarray(c.data) for c in idx]),
            "index_scale": idx[0].scale, "first_s": first_s,
            "steady_s": steady_s,
            "peak_bytes_in_use": np.array(
                [(d.memory_stats() or {}).get("peak_bytes_in_use", -1)
                 for d in devices], np.int64)}


def sharded_diag_db(store, mesh, axis: str = "db"):
    """In-memory DiagDB holding exactly the streamed store's ciphertexts,
    sharded over the mesh: each card's shard is built on that card, c0
    copied there from host memory and c1 expanded there from the
    enrollment seed."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P
    from image_matching.matching.enrollers import DiagDB
    from image_matching.matching.streaming import _device_sharding

    ctx = store.ctx
    devs = list(mesh.devices.flat)
    G = store.num_groups
    assert G % len(devs) == 0, "groups must divide the mesh"
    per = G // len(devs)
    shards = []
    for d, dev in enumerate(devs):
        rows = []
        for g in range(d * per, (d + 1) * per):
            c0 = jax.device_put(np.asarray(store.groups[g]),
                                _device_sharding(dev))
            with jax.default_device(dev):
                c1 = ctx.expand_c1(store.seed, g, c0.shape[0], c0.shape[1])
                rows.append(jnp.stack([c0, c1], axis=1))
        shards.append(jnp.stack(rows))
    shape = (G,) + tuple(shards[0].shape[1:])
    data = jax.make_array_from_single_device_arrays(
        shape, NamedSharding(mesh, P(axis)), shards)
    return DiagDB(data, store.num_vectors, store.scale, store.bsgs, store.n1)


def one_card_side(proto, qcts, n_devices: int) -> dict:
    """The one-card StreamedDiagonalSender on the gallery."""
    import jax
    s = proto.sender
    return _side_result(lambda: s.run_membership(qcts),
                        lambda: s.run_index(qcts), jax.devices()[:1])


def sharded_side(proto, qcts, n_devices: int) -> dict:
    """ShardedScenario over the gallery laid out in the cards' memory."""
    from image_matching.matching.senders import DiagonalSender
    from image_matching.parallel.sharded import ShardedScenario, make_mesh
    mesh = make_mesh(n_devices)
    scen = ShardedScenario(DiagonalSender(
        proto.ctx, proto.cfg, sharded_diag_db(proto.sender.store, mesh)),
        mesh)
    return _side_result(lambda: scen.membership(qcts),
                        lambda: scen.index(qcts), list(mesh.devices.flat))


FOUR_SIDES = {"one": one_card_side, "sharded": sharded_side}


def write_side(side: str, path: str, log2n: int = FOUR_LOG2N,
               ring: int = RING, cfg=None, seed: int = 0,
               n_devices: int = 4) -> dict:
    """One side of --four in a process of its own, on the same seeded
    key and gallery, saved to `path` (.npz): it compiles while --four
    compiles its own side, instead of before or after it."""
    from image_matching.matching.config import MatchConfig
    cfg = cfg or MatchConfig()
    ctx = make_context(5, ring=ring, cfg=cfg, seed=seed)
    proto, qcts, setup_s = streamed_gallery(log2n, ctx, cfg, seed)
    res = FOUR_SIDES[side](proto, qcts, n_devices)
    res.update(setup_s=setup_s, digest=_digest(proto, qcts))
    np.savez(path, **res)
    return {k: v for k, v in res.items() if k not in ("membership", "index")}


def load_side(path: str) -> dict:
    with np.load(path) as z:
        return {k: (z[k].item() if z[k].ndim == 0 else z[k]) for k in z.files}


def start_side(side: str, path: str):
    """Start `chip_smoke.py --four-side SIDE PATH` (the one-card side on
    card 0 only).  Returns (process, wait); wait() joins it and loads what
    it saved."""
    import subprocess
    env = dict(os.environ, XLA_PYTHON_CLIENT_MEM_FRACTION=FOUR_MEM_FRACTION[side])
    if side == "one":  # the first of the cards this process sees
        env["CUDA_VISIBLE_DEVICES"] = os.environ.get(
            "CUDA_VISIBLE_DEVICES", "0").split(",")[0]
    proc = subprocess.Popen([sys.executable, os.path.abspath(__file__),
                             "--four-side", side, path], env=env)

    def wait(timeout: float = 1200.0) -> dict:
        if proc.wait(timeout=timeout) != 0:
            raise RuntimeError(f"--four-side {side} exited {proc.returncode}")
        return load_side(path)

    return proc, wait


def mesh_h2d_rates(scen) -> dict:
    """Host -> card GB/s of a ShardedStreamedScenario's groups: each card
    alone, then all cards at once (as in a streamed step)."""
    import jax
    from image_matching.matching.streaming import _device_sharding
    host = scen._host_groups()
    per, _, _ = scen._partition()
    devs = list(scen.mesh.devices.flat)

    def put(gs):
        bufs, secs = _timed(lambda: [
            jax.device_put(host[g], _device_sharding(devs[g // per]))
            for g in gs])
        return sum(b.nbytes for b in bufs) / secs / 1e9

    per_card = [put(range(d * per, min((d + 1) * per, len(host))))
                for d in range(len(devs))]
    return {"h2d_GBs_per_card": per_card,
            "h2d_GBs_all_cards": put(range(len(host)))}


def four_card(log2n: int = FOUR_LOG2N, n_devices: int = 4, ctx=None,
              cfg=None, seed: int = 0, sides=None) -> dict:
    """Approach 5 at 2^log2n through ShardedStreamedScenario (here) and
    ShardedScenario on an n-card mesh vs the one-card
    StreamedDiagonalSender on the same gallery.  Index flags and the
    membership ciphertext must be bit-identical (all arithmetic and
    psum_mod are exact); decrypted results must agree.  `sides` maps
    "one" and "sharded" to a callable returning that side's result
    (`wait` of start_side); without it both run here, after this one."""
    import jax.numpy as jnp
    from image_matching.ckks.context import Ciphertext
    from image_matching.matching.config import MatchConfig
    from image_matching.parallel.sharded import (
        ShardedStreamedScenario, make_mesh)

    cfg = cfg or MatchConfig()
    ctx = ctx or make_context(5, cfg=cfg, seed=seed)
    proto, qcts, setup_s = streamed_gallery(log2n, ctx, cfg, seed)
    digest = _digest(proto, qcts)
    out = {"log2n": log2n, "devices": n_devices, "setup_s": setup_s,
           "groups": proto.sender.store.num_groups}
    _log(f"four: set up {out['groups']} groups in {setup_s:.1f} s")

    mesh = make_mesh(n_devices)
    streamed = ShardedStreamedScenario(proto.sender, mesh)
    res = {"streamed": _side_result(lambda: streamed.membership(qcts),
                                    lambda: streamed.index(qcts),
                                    list(mesh.devices.flat))}
    res["streamed"]["digest"] = digest
    _log(f"four: sharded streamed first {res['streamed']['first_s']:.1f} s")
    if sides is None:
        sides = {k: (lambda f=f: dict(f(proto, qcts, n_devices),
                                      digest=digest))
                 for k, f in FOUR_SIDES.items()}
    for k in ("one", "sharded"):
        res[k] = sides[k]()
        _log(f"four: {k} side done")
    # the h2d rates once the other processes have left the cards
    out.update(mesh_h2d_rates(streamed))

    one = res["one"]
    for k, r in res.items():
        out[f"{k}_first_s"], out[f"{k}_steady_s"] = r["first_s"], r["steady_s"]
        out[f"{k}_peak_bytes_in_use"] = [int(b) for b in r["peak_bytes_in_use"]]
        out[f"{k}_inputs_identical"] = r["digest"] == digest
        out[f"{k}_flags_identical"] = np.array_equal(one["index"], r["index"])
        out[f"{k}_membership_identical"] = np.array_equal(
            one["membership"], r["membership"])
    dec = {}
    for k, r in res.items():
        m = Ciphertext(jnp.asarray(r["membership"]), r["membership_scale"])
        idx = [Ciphertext(jnp.asarray(d), r["index_scale"]) for d in r["index"]]
        dec[k] = (proto.decrypt_membership(m), sorted(proto.decrypt_index(idx)))
    out["decrypted"] = {k: [v[0], v[1][:8]] for k, v in dec.items()}
    bad = [k for k, v in out.items()
           if k.endswith(("_identical")) and v is not True]
    assert not bad, f"differ from the one-card run: {bad}"
    assert dec["one"][0] is True and 0 in dec["one"][1], "one-card result wrong"
    assert dec["one"] == dec["streamed"] == dec["sharded"], "decrypts differ"
    return out


# -- main -----------------------------------------------------------------------

def _run_phase(name: str, card, fn, *args, **kw) -> dict:
    t0 = time.perf_counter()
    try:
        res = fn(*args, **kw)
    except Exception:
        traceback.print_exc()
        print(json.dumps({"phase": name, "ok": False,
                          "seconds": time.perf_counter() - t0, "card": card}),
              file=sys.stderr, flush=True)
        sys.exit(1)
    res = dict(res or {})
    res.pop("proto", None)
    print(json.dumps({"phase": name, "ok": True,
                      "seconds": time.perf_counter() - t0, "card": card,
                      **res}, default=str), flush=True)
    gc.collect()
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--four", action="store_true",
                      help="run only the four-card sharded path and its "
                           "one-card comparison")
    mode.add_argument("--others", action="store_true",
                      help="run only phase (e), approaches 1-3 at 2^10")
    mode.add_argument("--four-side", nargs=2, metavar=("SIDE", "NPZ"),
                      help="one side of --four (one or sharded), saved to "
                           "NPZ; --four starts both")
    args = ap.parse_args(argv)
    # a cold run: no on-disk enrollment cache is read or written
    os.environ["IMTPU_STORE_DIR"] = ""

    from image_matching.utils import device, native
    card = device.card_info()
    if args.four_side:
        import jax
        from image_matching.utils.jaxcfg import enable_compilation_cache
        _run_phase("a_device", card, check_device, jax.devices())
        enable_compilation_cache()
        side, path = args.four_side
        _run_phase(f"four_side_{side}", card, write_side, side, path)
        return 0

    print(f"card: {card}", flush=True)
    _run_phase("native", card, native.build, force=True)
    children = []
    try:
        if args.four:
            import tempfile
            os.environ.setdefault("XLA_PYTHON_CLIENT_MEM_FRACTION",
                                  FOUR_MEM_FRACTION["four"])
            tmp = tempfile.mkdtemp()
            sides = {}
            for side in ("one", "sharded"):
                proc, sides[side] = start_side(
                    side, os.path.join(tmp, f"{side}.npz"))
                children.append(proc)

        import jax
        from image_matching.utils.jaxcfg import enable_compilation_cache
        devs = jax.devices()
        desc = _run_phase("a_device", card, check_device, devs)
        enable_compilation_cache()
        if args.four:
            if len(devs) < 4:
                print(f"--four needs 4 GPUs, found {len(devs)}",
                      file=sys.stderr)
                return 1
            _run_phase("four_card", card, four_card, sides=sides)
        elif args.others:
            for a in (3, 1, 2):  # cheapest compile first
                _run_phase(f"e_approach{a}_2^10", card, main_path, a, 10,
                           False, steady_reps=1)
        else:
            ctx5 = make_context(5)
            _run_phase("b_kernel_parity", card, kernel_parity, ctx5)
            _run_phase("c_hydia_streamed_2^17", card,
                       main_path, 5, 17, True, ctx=ctx5)
            del ctx5
            _run_phase("d_hers_pinned_2^15", card, phase_d)
    finally:
        for proc in children:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    print(json.dumps({"ok": True, "device": desc}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
