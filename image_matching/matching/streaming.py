"""Host-streamed encrypted databases: enroll once, keep ciphertexts in host
RAM (seed-compressed to c0-only), stream groups to device memory per query
with double-buffered async device_put overlapped with per-group compute.

This is the device equivalent of the reference's per-operation DB streaming
from disk (reference src/sender/sender_hers.cpp:88-98 and
sender_diag.cpp:85-94): the reference deserializes each ciphertext file
inside the timed server loop; here the serialized form is the raw c0 limb
array in host memory and "deserialization" is an async h2d copy plus
on-device PRNG expansion of the seeded c1 (see
CkksContext.encrypt_seeded_batch).  Groups that fit the device-memory
budget stay device-resident across queries, mirroring the reference's OS
page cache.

Sizing (ring 32768, 14 limbs, dim 512): one diagonal group holds 512
ciphertexts covering 16384 vectors; c0-only is 0.94 GB.  A 2^20 DB is 64
groups = 60 GB c0-only — about what JAX may use of an 80 GB card, so the
groups past the budget stream from pinned host memory.
"""

from __future__ import annotations

import hashlib
import json
import math
import os
from typing import List, Optional, Sequence

import numpy as np
import jax
import jax.numpy as jnp

from ..ckks.context import CkksContext, Ciphertext
from ..ops import modmath as mm
from .config import MatchConfig
from .enrollers import diag_bsgs_n1, diag_group_vals
from .senders import Sender, ct_dot, _mod_sum_rows
from .vector_utils import normalize


class _SeededStore:
    """Seed-compressed encrypted DB: groups[g] is the c0 stack [dim, L, N]
    (uint32 Montgomery/eval) — a jnp array for device-resident groups,
    numpy (host RAM) otherwise.  The matching c1 for group g is
    `ctx.expand_c1(seed, g, dim, L)` (Threefry stream, ops/prng.py)."""

    layout = "base"

    def __init__(self, ctx: CkksContext, num_vectors: int, scale: float,
                 seed: int):
        self.ctx = ctx
        self.num_vectors = num_vectors
        self.scale = scale
        self.seed = seed
        self.groups: List = []

    @property
    def num_groups(self) -> int:
        return len(self.groups)

    def group_bytes(self) -> int:
        g = self.groups[0]
        return int(np.prod(g.shape)) * 4

    def resident_count(self) -> int:
        dev = jax.devices()[0]
        return sum(1 for g in self.groups if _on_device(g, dev))

    def pinned_count(self) -> int:
        dev = jax.devices()[0]
        return sum(1 for g in self.groups
                   if isinstance(g, jax.Array) and not _on_device(g, dev))


class DiagStore(_SeededStore):
    """Diagonal (HyDia) layout: group g holds the `dim` generalized
    diagonals of `slots/dim` square matrices, BSGS-pre-rotated when
    requested (reference src/enroller/enroller_diag.cpp)."""

    layout = "diag"

    def __init__(self, ctx: CkksContext, num_vectors: int, scale: float,
                 bsgs: bool, n1: int, seed: int):
        super().__init__(ctx, num_vectors, scale, seed)
        self.bsgs = bsgs
        self.n1 = n1


class HersStore(_SeededStore):
    """Dimension-major (HERS) layout: group m holds feature-ciphertexts
    d_{m,j} of `slots` consecutive DB vectors (reference
    src/enroller/enroller_hers.cpp:41-89); the reference streams these
    per-op from disk (sender_hers.cpp:88-98)."""

    layout = "hers"


def _pinned_sharding(dev=None):
    """Sharding for the device's pinned host memory, or None when the
    backend has no such tier (CPU).  Groups past the device budget are
    staged here once during enrollment and cross to the device by DMA per
    query — the analog of the reference streaming its serialized DB from
    the OS page cache (src/sender/sender_diag.cpp:85-94)."""
    if dev is None:
        dev = jax.devices()[0]
    try:
        kinds = [m.kind for m in dev.addressable_memories()]
    except Exception:
        return None
    if "pinned_host" not in kinds:
        return None
    from jax.sharding import SingleDeviceSharding
    return SingleDeviceSharding(dev, memory_kind="pinned_host")


def _device_sharding(dev):
    """Explicit default-memory sharding: device_put of a pinned-host array
    to a bare Device raises a memory-kind mismatch; the target memory must
    be named."""
    from jax.sharding import SingleDeviceSharding
    try:
        return SingleDeviceSharding(dev, memory_kind=dev.default_memory().kind)
    except Exception:
        return dev


def _on_device(arr, dev) -> bool:
    """True if `arr` already lives in the device's default memory."""
    if not isinstance(arr, jax.Array):
        return False
    try:
        kind = getattr(arr.sharding, "memory_kind", None)
        return kind is None or kind == dev.default_memory().kind
    except Exception:
        return True


def _hbm_budget_bytes(ctx: CkksContext, dev=None) -> int:
    """Device-memory bytes available for resident DB groups: the device's
    `bytes_limit` (what JAX may allocate) minus a working-set reserve
    (keys, per-group similarity workspace, compare stack), overridable via
    IMTPU_HBM_BUDGET_GB.  A device that reports no memory stats is an
    error: guessing would either stream everything or run out of memory."""
    env = os.environ.get("IMTPU_HBM_BUDGET_GB")
    if env is not None:
        return int(float(env) * 2**30)
    dev = dev or jax.devices()[0]
    limit = (dev.memory_stats() or {}).get("bytes_limit", 0)
    if not limit:
        raise RuntimeError(
            f"{dev.device_kind} reports no memory bytes_limit; set "
            "IMTPU_HBM_BUDGET_GB to size the resident DB groups")
    # reserve: keys + NTT tables (~1.5 GB at production parameters) plus
    # ~8x one group's c0 bytes for the expanded (c0+c1+product) similarity
    # workspace
    reserve = 2 * 2**30 + 8 * ctx.Lq * ctx.n * 4 * 512
    return max(0, int(limit) - reserve)


def _cache_dir() -> Optional[str]:
    """Directory for the on-disk enrolled-DB cache (IMTPU_STORE_DIR;
    empty string disables).  Default: <repo>/.dbcache."""
    d = os.environ.get("IMTPU_STORE_DIR")
    if d == "":
        return None
    if d is None:
        d = os.path.join(os.path.dirname(__file__), "..", "..", ".dbcache")
    return os.path.abspath(d)


def _db_fingerprint(db: np.ndarray) -> str:
    h = hashlib.sha1()
    h.update(repr(db.shape).encode())
    step = max(1, db.shape[0] // 256)
    h.update(np.ascontiguousarray(db[::step]).tobytes()[: 1 << 22])
    return h.hexdigest()[:16]


def _store_cache_path(ctx: CkksContext, cfg: MatchConfig, db: np.ndarray,
                      seed: int, bsgs: bool, n1: int,
                      layout: str = "diag") -> Optional[str]:
    """Cache key covers everything that determines the c0 bytes: scheme
    primes, ring, context seed (-> secret key), layout, and the plaintext
    DB content.  Mirrors the reference's offline enroll-to-disk
    (reference src/enroller/enroller_diag.cpp + READ_FROM_SERIAL): the
    timed query path streams a pre-enrolled DB."""
    root = _cache_dir()
    if root is None:
        return None
    material = [
        int(ctx.n), [int(q) for q in ctx.q_np[: ctx.Lq]],
        float(ctx.fresh_scale), int(getattr(ctx, "seed", 0)),
        int(cfg.vector_dim), int(db.shape[0]), int(seed), bool(bsgs),
        int(n1), _db_fingerprint(db),
    ]
    if layout != "diag":  # keep pre-existing diag cache keys valid
        material.append(layout)
    key = hashlib.sha1(json.dumps(material).encode()).hexdigest()[:20]
    return os.path.join(root, f"{layout}_{db.shape[0]}_{key}")


def _enc_cache_path(ctx: CkksContext, cfg: MatchConfig, db: np.ndarray,
                    cache_extra, layout: str) -> Optional[str]:
    """Cache of the pre-encoded (hi, lo) coefficient transfer form — the
    enroller-side, key-independent half of seeded enrollment.  ~134 MB per
    group instead of ~1 GB of c0, and loading it turns re-enrollment into
    pure upload + on-device encryption (the fast path for the pinned
    tier, where c0 never returns to this host)."""
    root = _cache_dir()
    if root is None:
        return None
    material = [
        "enc-v1", int(ctx.n), float(ctx.fresh_scale), int(cfg.vector_dim),
        int(db.shape[0]), bool(cache_extra[0]), int(cache_extra[1]),
        _db_fingerprint(db), layout,
    ]
    key = hashlib.sha1(json.dumps(material).encode()).hexdigest()[:20]
    return os.path.join(root, f"enc_{layout}_{db.shape[0]}_{key}")


def _atomic_save(dirpath: str, fname: str, arr: np.ndarray) -> bool:
    """tmp + fsync + rename so a present file is always complete."""
    try:
        os.makedirs(dirpath, exist_ok=True)
        final = os.path.join(dirpath, fname)
        tmp = f"{final}.{os.getpid()}.tmp"
        with open(tmp, "wb") as f:
            np.save(f, arr)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, final)
        dfd = os.open(dirpath, os.O_RDONLY)
        os.fsync(dfd)
        os.close(dfd)
        return True
    except OSError:
        return False


def _enc_complete(enc_path: Optional[str], num_groups: int) -> bool:
    if enc_path is None or not os.path.isdir(enc_path):
        return False
    return all(os.path.exists(os.path.join(enc_path, f"g{g:04d}.npy"))
               for g in range(num_groups))


def _promote_resident(store: DiagStore, resident_budget: int) -> None:
    """Move leading groups to HBM until the budget is spent (fast h2d)."""
    gbytes = store.group_bytes()
    dev = jax.devices()[0]
    budget_left = resident_budget
    dev_sh = _device_sharding(dev)
    for g, grp in enumerate(store.groups):
        if budget_left < gbytes:
            break
        if not _on_device(grp, dev):
            if not isinstance(grp, jax.Array):
                grp = np.ascontiguousarray(grp)
            store.groups[g] = jax.device_put(grp, dev_sh)
        budget_left -= gbytes


def _load_cached_store(path: str, store: _SeededStore,
                       resident_budget: int, verbose: bool
                       ) -> Optional[_SeededStore]:
    """Fill an empty store from a completed on-disk enrollment cache."""
    ctx = store.ctx
    meta_p = os.path.join(path, "meta.json")
    if not os.path.exists(meta_p):
        return None
    with open(meta_p) as f:
        meta = json.load(f)
    dim = meta.get("dim")
    for g in range(meta["num_groups"]):
        arr = np.load(os.path.join(path, f"g{g:04d}.npy"), mmap_mode="r")
        if arr.dtype != np.uint32 or arr.ndim != 3 or arr.shape[1:] != (
                ctx.Lq, ctx.n) or (dim and arr.shape[0] != dim):
            return None  # stale/foreign cache layout: re-enroll
        store.groups.append(arr)
    _promote_resident(store, resident_budget)
    if verbose:
        import sys
        print(f"# enrolled DB loaded from cache {path} "
              f"({meta['num_groups']} groups, "
              f"{store.resident_count()} resident)", file=sys.stderr)
    return store


def enroll_diag_streamed(ctx: CkksContext, cfg: MatchConfig, db: np.ndarray,
                         bsgs: Optional[bool] = None, seed: int = 1234,
                         resident_budget: Optional[int] = None,
                         engine: str = "auto",
                         verbose: bool = False) -> DiagStore:
    """Enroll a (possibly huge) plaintext DB into a DiagStore.

    engine="native": per group, host FFT encode -> C++ seeded encryption
    (utils/native.enroll_group) straight into host RAM — no device traffic
    at all, and the only engine that writes the on-disk c0 cache.
    Host-resident groups are then promoted to the device up to the
    resident budget.

    engine="device": on-device seeded encryption (compact (hi, lo)
    coefficient transfer up, c0 down only for spilled groups).

    engine="pinned": on-device seeded encryption; groups past the budget
    are offloaded to the device's pinned host memory (no numpy copy).

    engine="auto": pinned on an accelerator with a pinned-host tier when
    the store will not be fully device-resident, else native when the C++
    library is available and the store will not be fully resident, else
    device."""
    dim = cfg.vector_dim
    mpb = ctx.slots // dim
    if bsgs is None:
        bsgs = cfg.use_bsgs
    n1 = diag_bsgs_n1(dim) if bsgs else 1
    store = DiagStore(ctx, db.shape[0], ctx.fresh_scale, bsgs, n1, seed)

    def vals_fn(rows: np.ndarray) -> np.ndarray:
        sq = np.zeros((mpb, dim, dim))
        sq.reshape(-1, dim)[: rows.shape[0]] = rows
        return diag_group_vals(sq, dim, mpb, bsgs, n1)  # [dim, batch]

    return _enroll_streamed(ctx, cfg, db, store, vals_fn,
                            cache_extra=(bsgs, n1), seed=seed,
                            resident_budget=resident_budget, engine=engine,
                            verbose=verbose)


def enroll_hers_streamed(ctx: CkksContext, cfg: MatchConfig, db: np.ndarray,
                         seed: int = 1234,
                         resident_budget: Optional[int] = None,
                         engine: str = "auto",
                         verbose: bool = False) -> HersStore:
    """Enroll into the dimension-major HERS layout, seed-compressed and
    host-streamed — covers the reference's 2^16-2^20 HERS column
    (src/enroller/enroller_hers.cpp:41-89 + sender_hers.cpp:88-98) beyond
    the device-resident HersDB's HBM reach."""
    dim = cfg.vector_dim
    batch = ctx.slots
    store = HersStore(ctx, db.shape[0], ctx.fresh_scale, seed)

    def vals_fn(rows: np.ndarray) -> np.ndarray:
        full = np.zeros((batch, dim))
        full[: rows.shape[0]] = rows
        return np.ascontiguousarray(full.T)  # [dim, batch]: feature-major

    if resident_budget is None:
        # the HERS query is `dim` full ciphertexts (reference
        # receiver_hers.cpp:13-24): the caller keeps the 512 individual
        # ciphertexts alive across both scenarios AND the sender stacks
        # them into one [dim, 2, l, N] array — together ~8x one group's
        # c0 bytes.  The generic budget reserve does not know the layout,
        # so carve that out here; without it the 2^20 run OOMs right
        # after enrollment (round-4 verdict item 1 risk, observed).
        gbytes = dim * ctx.Lq * ctx.n * 4
        resident_budget = max(0, _hbm_budget_bytes(ctx) - 8 * gbytes)

    return _enroll_streamed(ctx, cfg, db, store, vals_fn,
                            cache_extra=(False, 0), seed=seed,
                            resident_budget=resident_budget, engine=engine,
                            verbose=verbose)


def _enroll_streamed(ctx: CkksContext, cfg: MatchConfig, db: np.ndarray,
                     store: _SeededStore, vals_fn, cache_extra, seed: int,
                     resident_budget: Optional[int], engine: str,
                     verbose: bool) -> _SeededStore:
    """Layout-generic streamed enrollment: per group of `slots` vectors,
    compute the slot values via `vals_fn(rows) -> [dim, batch]`, seeded-
    encrypt to a c0 stack, cache/resume on disk, and keep leading groups
    device-resident up to the HBM budget."""
    dim = cfg.vector_dim
    nvec = db.shape[0]
    group_rows = ctx.slots  # vectors covered per group, every layout
    num_groups = math.ceil(nvec / group_rows)
    if resident_budget is None:
        resident_budget = _hbm_budget_bytes(ctx)
    gbytes = dim * ctx.Lq * ctx.n * 4
    # disk cache: enrollment is offline work (the reference enrolls to disk
    # and streams, src/sender/sender_diag.cpp:85-94); big DBs enroll once
    cache_on = (nvec >= (1 << 16)) or bool(os.environ.get("IMTPU_STORE_DIR"))
    cache_path = (_store_cache_path(ctx, cfg, db, seed, *cache_extra,
                                    layout=store.layout)
                  if cache_on else None)
    pin = None
    all_resident = resident_budget >= gbytes * num_groups
    if engine == "auto":
        from ..utils import native
        if not all_resident and jax.default_backend() != "cpu" \
                and not os.environ.get("IMTPU_NO_PINNED"):
            pin = _pinned_sharding()
        if pin is not None:
            engine = "pinned"
        elif native.available() and not all_resident:
            engine = "native"
        else:
            engine = "device"
    elif engine == "pinned":
        pin = _pinned_sharding()
        assert pin is not None, "pinned_host memory tier not available"
    enc_path = None
    if engine == "pinned":
        # device-side enrollment straight into pinned host RAM: only the
        # compact (hi, lo) encode coefficients go up, and they are cached
        # on disk instead of the 7x larger c0 stack.
        if cache_on:
            enc_path = _enc_cache_path(ctx, cfg, db, cache_extra,
                                       store.layout)
        cache_path = None
    if cache_path is not None:
        cached = _load_cached_store(cache_path, store, resident_budget,
                                    verbose)
        if cached is not None:
            return cached
        store.groups = []  # partially-filled by a failed load
    enc_hit_all = _enc_complete(enc_path, num_groups)
    db_normalized = False
    if not enc_hit_all:
        db = normalize(db)  # full encode cache never touches the rows
        db_normalized = True
    budget_left = resident_budget
    dev = jax.devices()[0]
    if engine == "pinned":
        return _enroll_pinned(ctx, cfg, db, db_normalized, store, vals_fn,
                              enc_path, seed, num_groups, budget_left,
                              pin, verbose)
    # resumable enrollment: trust complete per-group files from an
    # interrupted earlier run (written via tmp+rename+fsync, so any
    # g####.npy present is complete) — except the newest one, which an
    # older writer may have left half-written; re-enroll that one.  Only
    # the native engine consumes the cache (it is the only writer).
    resume_upto = -1
    if engine == "native" and cache_path is not None \
            and os.path.isdir(cache_path):
        have = sorted(f for f in os.listdir(cache_path)
                      if f.startswith("g") and f.endswith(".npy"))
        contiguous = [f"g{g:04d}.npy" for g in range(len(have))]
        if have and have == contiguous:
            resume_upto = len(have) - 2  # newest file is suspect
        if verbose and resume_upto >= 0:
            import sys
            print(f"# resuming enrollment: groups 0..{resume_upto} cached",
                  file=sys.stderr)
    for g in range(num_groups):
        if engine == "native" and cache_path is not None and g <= resume_upto:
            try:
                c0 = np.load(os.path.join(cache_path, f"g{g:04d}.npy"),
                             mmap_mode="r")
                ok = (c0.dtype == np.uint32
                      and c0.shape == (dim, ctx.Lq, ctx.n))
            except (ValueError, OSError):
                ok = False
            if not ok:
                resume_upto = g - 1  # torn/foreign file: re-enroll from here
            else:
                if budget_left >= gbytes:
                    c0 = jax.device_put(np.ascontiguousarray(c0), dev)
                    budget_left -= gbytes
                store.groups.append(c0)
                continue
        lo_r = g * group_rows
        hi_r = min(nvec, (g + 1) * group_rows)
        vals = vals_fn(db[lo_r:hi_r])  # [dim, batch]
        if engine == "native":
            c0 = ctx.encrypt_seeded_batch_host(vals, seed, g)
            assert c0 is not None, "native engine requested but unavailable"
            if cache_path is not None:
                try:
                    os.makedirs(cache_path, exist_ok=True)
                    final = os.path.join(cache_path, f"g{g:04d}.npy")
                    # writer-unique tmp so concurrent enrollments of the
                    # same DB never interleave into one tmp file
                    tmp = f"{final}.{os.getpid()}.tmp"
                    fm = np.lib.format.open_memmap(
                        tmp, mode="w+", dtype=np.uint32, shape=c0.shape)
                    fm[:] = c0
                    fm.flush()
                    del fm
                    # fsync file + dir so present => complete holds across
                    # power loss, not just process crashes
                    fd = os.open(tmp, os.O_RDONLY)
                    os.fsync(fd)
                    os.close(fd)
                    os.replace(tmp, final)  # atomic: present => complete
                    dfd = os.open(cache_path, os.O_RDONLY)
                    os.fsync(dfd)
                    os.close(dfd)
                    c0 = np.load(final, mmap_mode="r")
                except OSError:  # out of disk: keep going uncached
                    cache_path = None
            if budget_left >= gbytes:
                c0 = jax.device_put(np.ascontiguousarray(c0), dev)
                budget_left -= gbytes
        else:
            c0 = ctx.encrypt_seeded_batch(vals, seed, g)
            if budget_left >= gbytes:
                c0.block_until_ready()
                budget_left -= gbytes
            else:
                c0 = np.asarray(c0)  # d2h spill to host RAM
        store.groups.append(c0)
        if verbose and (g % 8 == 0 or g == num_groups - 1):
            import sys
            print(f"# enroll group {g + 1}/{num_groups} engine={engine} "
                  f"(resident {store.resident_count()})", file=sys.stderr)
    if engine == "native" and cache_path is not None:
        # meta.json written last = completeness marker
        with open(os.path.join(cache_path, "meta.json"), "w") as f:
            json.dump({"num_groups": num_groups, "nvec": nvec, "dim": dim,
                       "layout": store.layout, "seed": seed}, f)
    return store


def _enroll_pinned(ctx: CkksContext, cfg: MatchConfig, db: np.ndarray,
                   db_normalized: bool, store: _SeededStore, vals_fn,
                   enc_path: Optional[str], seed: int, num_groups: int,
                   budget_left: int, pin, verbose: bool) -> _SeededStore:
    """Pinned-tier enrollment with a pipelined host side.

    A serial cold path would alternate {numpy FFT encode of group g} ->
    {upload + device encrypt of group g} -> {encode g+1} ...  Here the
    host half (encode-cache load, else vals_fn + encode_split + cache
    save) runs on a 2-worker executor with a two-group lookahead,
    overlapping the device encrypt + pinned-offload of group g — the host
    FFT is the bottleneck and pocketfft releases the GIL."""
    import threading
    from concurrent.futures import ThreadPoolExecutor

    dim = cfg.vector_dim
    nvec = db.shape[0]
    group_rows = ctx.slots
    gbytes = dim * ctx.Lq * ctx.n * 4
    state = {"db": db, "normalized": db_normalized, "enc_path": enc_path}
    norm_lock = threading.Lock()

    def prepare(g):
        """Host-side half for group g -> (hi, lo) encode coefficients."""
        ep = state["enc_path"]
        if ep is not None:
            try:
                a = np.load(os.path.join(ep, f"g{g:04d}.npy"),
                            mmap_mode="r")
                if a.dtype == np.uint32 and a.shape == (2, dim, ctx.n):
                    return (np.ascontiguousarray(a[0]),
                            np.ascontiguousarray(a[1]))
            except (OSError, ValueError):
                pass
        # cache miss (including a file evicted/corrupted mid-run after
        # _enc_complete said the cache was whole): encode this group,
        # normalizing the rows lazily on the first miss — db is untouched
        # while every group hits.
        with norm_lock:
            if not state["normalized"]:
                state["db"] = normalize(state["db"])
                state["normalized"] = True
        lo_r = g * group_rows
        hi_r = min(nvec, (g + 1) * group_rows)
        vals = vals_fn(state["db"][lo_r:hi_r])
        hl = ctx.encode_split(vals)
        if ep is not None and not _atomic_save(
                ep, f"g{g:04d}.npy", np.stack(hl)):
            state["enc_path"] = None  # out of disk: keep going uncached
        return hl

    lookahead = 2
    with ThreadPoolExecutor(max_workers=2) as ex:
        futs = {g: ex.submit(prepare, g)
                for g in range(min(lookahead + 1, num_groups))}
        for g in range(num_groups):
            hl = futs.pop(g).result()
            nxt = g + lookahead + 1
            if nxt < num_groups:
                futs[nxt] = ex.submit(prepare, nxt)
            c0 = ctx.encrypt_seeded_from_split(hl[0], hl[1], seed, g)
            if budget_left >= gbytes:
                budget_left -= gbytes
            else:
                c0 = jax.device_put(c0, pin)  # HBM -> host pinned (DMA)
            # cap in-flight device work at ~2 groups so the async encrypt
            # + offload queue never spikes HBM
            if store.groups:
                jax.block_until_ready(store.groups[-1])
            store.groups.append(c0)
            if verbose and (g % 8 == 0 or g == num_groups - 1):
                import sys
                print(f"# enroll group {g + 1}/{num_groups} engine=pinned "
                      f"(resident {store.resident_count()})",
                      file=sys.stderr)
    return store


class _StreamedSender(Sender):
    """Shared streamed-sender machinery: per-group Python loop with async
    h2d prefetch of the next group's c0 overlapping the current group's
    similarity segment, c1 expanded on-device from the enrollment seed —
    the device equivalent of the reference's per-op DB deserialization
    (src/sender/sender_hers.cpp:88-98, sender_diag.cpp:85-94).
    Subclasses provide `_query_stack` and `_group_segment`."""

    def __init__(self, ctx: CkksContext, cfg: MatchConfig,
                 store: _SeededStore):
        super().__init__(ctx, cfg, store.num_vectors)
        self.store = store

    def _query_stack(self, query: List[Ciphertext]) -> jnp.ndarray:
        raise NotImplementedError

    def _group_segment(self):
        raise NotImplementedError

    def _similarity_stream(self, query: List[Ciphertext]):
        """Stream all groups through the similarity segment with one-group
        lookahead prefetch.  Returns (score stack [G, 2, l', N], scale)."""
        ctx = self.ctx
        Q = self._query_stack(query)
        fn, meta = self._group_segment()
        state = ctx.device_state()
        dev = jax.devices()[0]
        G = self.store.num_groups

        dev_sh = _device_sharding(dev)

        def fetch(g):
            grp = self.store.groups[g]
            if _on_device(grp, dev):
                return grp
            # async h2d: pinned-host groups go by DMA; numpy groups are
            # staged through a pageable host buffer first
            return jax.device_put(grp, dev_sh)

        nxt = fetch(0)
        outs = []
        for g in range(G):
            cur, nxt = nxt, (fetch(g + 1) if g + 1 < G else None)
            out = fn(state, Q, cur, jnp.uint32(g))
            outs.append(out)
            del cur
        scores = jnp.stack(outs) if G > 1 else outs[0][None]
        return scores, meta["scale"]

    def _stream_and_compare(self, query: List[Ciphertext], thr: float):
        """Stream groups through the similarity segment AND dispatch the
        compare segment per chunk of scores inside the same loop.

        At 2^20 the query splits between the pinned-host->device stream
        and the compare circuit; running compare only after the last group
        has streamed serializes the two.  Dispatching each compare chunk as
        soon as its scores exist lets the compare kernels fill the
        transfer-bound gaps: the next groups' h2d copies (issued before the
        compare dispatch) proceed on the copy engine while the SMs run the
        sign approximation.  Same math, same jit segments, same chunk
        shapes (compile-cache hits); only the dispatch order moves.

        Returns (flag stack [G, 2, l'', N], flag scale)."""
        import os
        ctx = self.ctx
        Q = self._query_stack(query)
        fn, meta = self._group_segment()
        state = ctx.device_state()
        dev = jax.devices()[0]
        G = self.store.num_groups
        chunk = int(os.environ.get("IMTPU_COMPARE_CHUNK", "16"))
        dev_sh = _device_sharding(dev)

        def fetch(g):
            grp = self.store.groups[g]
            if _on_device(grp, dev):
                return grp
            return jax.device_put(grp, dev_sh)

        nxt = fetch(0)
        outs, flags, fscale = [], [], None
        for g in range(G):
            cur, nxt = nxt, (fetch(g + 1) if g + 1 < G else None)
            outs.append(fn(state, Q, cur, jnp.uint32(g)))
            del cur
            if len(outs) == chunk or g == G - 1:
                sstack = jnp.stack(outs) if len(outs) > 1 else outs[0][None]
                f, fscale = self._compare_segments(sstack, meta["scale"], thr)
                flags.append(f)
                outs = []
        fstack = (jnp.concatenate(flags, axis=0) if len(flags) > 1
                  else flags[0])
        return fstack, fscale

    # -- scenario entry points -------------------------------------------

    def compute_similarity(self, query: List[Ciphertext]) -> List[Ciphertext]:
        sdata, scale = self._similarity_stream(query)
        return [Ciphertext(sdata[i], scale) for i in range(sdata.shape[0])]

    similarity = compute_similarity  # already jitted per group

    def run_membership(self, query_cts: List[Ciphertext]) -> Ciphertext:
        fstack, fscale = self._stream_and_compare(
            query_cts, self.cfg.match_threshold)
        data, meta = self._reduce_segment(fstack, fscale)
        return Ciphertext(data, meta["scale"])

    def run_index(self, query_cts: List[Ciphertext]) -> List[Ciphertext]:
        fstack, fscale = self._stream_and_compare(
            query_cts, self.cfg.match_threshold)
        return [Ciphertext(fstack[i], fscale) for i in range(fstack.shape[0])]


class StreamedDiagonalSender(_StreamedSender):
    """Approach 5 (HyDia) over a DiagStore: identical math to
    DiagonalSender (reference src/sender/sender_diag.cpp) with the
    streamed per-group loop of _StreamedSender."""

    def required_rotations(self) -> List[int]:
        dim = self.cfg.vector_dim
        if self.store.bsgs:
            n1 = self.store.n1
            n2 = dim // n1
            return list(range(1, n1)) + [n1 * j for j in range(1, n2)]
        return list(range(1, dim))

    # -- jit segments ----------------------------------------------------

    def _query_stack(self, query: List[Ciphertext]) -> jnp.ndarray:
        """All baby rotations of the query as one hoisted-keyswitch
        segment: [n1, 2, l, N]."""
        qct = query[0]
        n1 = self.store.n1 if self.store.bsgs else self.cfg.vector_dim

        def builder(meta):
            def fn(state, qd):
                with self.ctx.bound_state(state):
                    q = Ciphertext(qd, self.ctx.fresh_scale)
                    if n1 == 1:
                        return q.data[None]
                    digs = self.ctx.hoisted_precompute(q)
                    rot = self.ctx.hoisted_rotate_stack(
                        q, digs, list(range(1, n1)))
                    return jnp.concatenate([q.data[None], rot], axis=0)
            return fn

        fn, _ = self._seg(("stream_qstack", qct.data.shape), builder)
        return fn(self.ctx.device_state(), qct.data)

    def _group_compute(self, Q, c0, g, valid=None):
        """Similarity for one streamed group (ctx state already bound):
        expand the seeded c1, diagonal BSGS matvec against the hoisted
        query rotations, relinearize, rescale.  Returns (data, scale).
        `valid` (uint32 0/1) zeroes c1 for all-zero padding groups so they
        stay exact encryptions of 0 (sharded uneven-group padding)."""
        ctx, cfg = self.ctx, self.cfg
        dim = cfg.vector_dim
        n1 = self.store.n1 if self.store.bsgs else dim
        n2 = dim // n1
        sq = ctx.fresh_scale
        sdb = self.store.scale
        l = c0.shape[-2]
        c1 = ctx.expand_c1(self.store.seed, g, c0.shape[0], l)
        if valid is not None:
            c1 = c1 * valid
        dbd = jnp.stack([c0, c1], axis=1)  # [dim, 2, l, N]
        q, _ = ctx._qrow(ctx.q_limbs(l))
        if n2 == 1:
            t3 = ct_dot(ctx, Q, dbd)
            out = ctx.rescale_score(
                ctx.relinearize(Ciphertext(t3, sq * sdb)))
        else:
            blocks = dbd.reshape(n2, n1, *dbd.shape[1:])
            t3 = jax.vmap(lambda blk: ct_dot(ctx, Q, blk))(blocks)
            prod_scale = sq * sdb
            inners = jax.vmap(
                lambda d: ctx.relinearize(
                    Ciphertext(d, prod_scale)).data
            )(t3)
            rot = ctx.rotate_stack(
                inners[1:], [n1 * j for j in range(1, n2)],
                prod_scale)
            summed = mm.mod_add(
                inners[0], _mod_sum_rows(rot, q), q)
            out = ctx.rescale_score(Ciphertext(summed, prod_scale))
        return out.data, out.scale

    def _group_segment(self):
        ctx = self.ctx

        def builder(meta):
            def fn(state, Q, c0, g):
                with ctx.bound_state(state):
                    data, scale = self._group_compute(Q, c0, g)
                    meta["scale"] = scale
                    return data
            return fn

        return self._seg(("stream_group", self.store.groups[0].shape), builder)


class StreamedHersSender(_StreamedSender):
    """Approach 4 (HERS) over a HersStore: score(m) = sum_j q_j (*) d_{m,j}
    (reference src/sender/sender_hers.cpp:61-84) with the DB streamed
    per-group exactly like the reference's computeSimilaritySerial
    (sender_hers.cpp:88-98).  The 512-ciphertext query stays device-
    resident across groups; only c0 stacks stream."""

    def _query_stack(self, query: List[Ciphertext]) -> jnp.ndarray:
        return jnp.stack([c.data for c in query])  # [dim, 2, l, N]

    def _group_compute(self, Q, c0, g, valid=None):
        ctx = self.ctx
        l = c0.shape[-2]
        c1 = ctx.expand_c1(self.store.seed, g, c0.shape[0], l)
        if valid is not None:
            c1 = c1 * valid
        dbd = jnp.stack([c0, c1], axis=1)  # [dim, 2, l, N]
        t3 = ct_dot(ctx, Q, dbd)
        out = ctx.rescale_score(
            ctx.relinearize(Ciphertext(t3, ctx.fresh_scale * self.store.scale)))
        return out.data, out.scale

    def _group_segment(self):
        ctx = self.ctx

        def builder(meta):
            def fn(state, Q, c0, g):
                with ctx.bound_state(state):
                    data, scale = self._group_compute(Q, c0, g)
                    meta["scale"] = scale
                    return data
            return fn

        return self._seg(
            ("stream_hers_group", self.store.groups[0].shape), builder)
