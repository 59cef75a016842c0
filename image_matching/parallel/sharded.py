"""Multi-device execution: shard the encrypted database across a device mesh.

The reference's only parallelism is OpenMP threads over independent
ciphertexts inside one box (SURVEY.md section 2.6).  The device
equivalent is data parallelism over the DB's matrix/group axis: each card
holds a shard of the encrypted DB, computes its scores + compare flags
locally, and the membership reduction becomes a modular psum over the
interconnect (NVLink between the cards of one host) — the cross-device
analog of EvalAddManyInPlace + EvalSum (reference
src/sender/sender_hers.cpp:52-54).

The cards of one host reach each other all to all, so the mesh is one flat
axis.  The device state (keys, NTT tables) is replicated onto the mesh once
per scenario object, not shipped from device 0 on every call, and a
streamed store feeds each card from that card's own pinned host memory.

Residues are uint32 mod q with q < 2^31, so a raw lax.psum could wrap for
more than 2 shards; `psum_mod` splits into 16-bit halves, psums those, and
refolds mod q.
"""

from __future__ import annotations

from typing import List

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ckks.context import CkksContext, Ciphertext
from ..ops import modmath as mm


def make_mesh(n_devices: int | None = None, axis: str = "db") -> Mesh:
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.array(devs), (axis,))


def replicated_state(ctx: CkksContext, mesh: Mesh):
    """The context's device state, copied once onto every card of `mesh`."""
    return jax.device_put(ctx.device_state(), NamedSharding(mesh, P()))


def psum_mod(x: jnp.ndarray, q: jnp.ndarray, qneg: jnp.ndarray,
             p16: jnp.ndarray, axis_name: str) -> jnp.ndarray:
    """Modular all-reduce sum of residues < q < 2^31 across a mesh axis.

    A raw lax.psum of uint32 residues can wrap; instead psum the 16-bit
    halves (exact for up to 2^16 shards) and refold with the same
    Montgomery power-of-2^16 constants used by mont_dot.  Montgomery form
    is preserved: the sum of Montgomery forms is the Montgomery form of
    the sum."""
    lo = jax.lax.psum(x & jnp.uint32(0xFFFF), axis_name)
    hi = jax.lax.psum(x >> 16, axis_name)
    return mm.mod_add(
        mm.mont_mul(lo, p16[0], q, qneg),
        mm.mont_mul(hi, p16[1], q, qneg),
        q,
    )


class _MeshScenario:
    """What the sharded scenarios share: a score stack [G', 2, l, N] laid
    over the mesh's group axis goes through the sender's compare segments
    (run with the replicated device state); index returns the flags,
    membership sums each card's flags, psum_mods them over the mesh and
    runs EvalSum.  Subclasses provide `_scores`.  Compare and reduce are
    the same programs for both subclasses, so the second one to compile
    them finds them in the persistent compilation cache."""

    def __init__(self, sender, mesh: Mesh, axis: str = "db"):
        self.sender = sender
        self.mesh = mesh
        self.axis = axis
        self._fns = {}
        self._state = None

    def _replicated_state(self):
        if self._state is None:
            self._state = replicated_state(self.sender.ctx, self.mesh)
        return self._state

    def _scores(self, query_cts: List[Ciphertext]):
        """(score stack sharded on axis 0, its scale)."""
        raise NotImplementedError

    def _membership_mask(self, n_flags: int):
        """uint32 0/1 per flag position entering the membership sum, or
        None to sum them all."""
        return None

    def _flags(self, query_cts: List[Ciphertext]):
        scores, scale = self._scores(query_cts)
        return self.sender._compare_segments(
            scores, scale, self.sender.cfg.match_threshold,
            self._replicated_state())

    def _reduce_fn(self, fscale: float, shape):
        key = ("reduce", fscale, shape)
        if key not in self._fns:
            ctx, axis = self.sender.ctx, self.axis
            meta = {}

            def local(state, fs):
                with ctx.bound_state(state):
                    l = fs.shape[-2]
                    q, qneg = ctx._qrow(ctx.q_limbs(l))
                    acc = fs[0]
                    for i in range(1, fs.shape[0]):
                        acc = mm.mod_add(acc, fs[i], q)
                    p16 = ctx.pow16[:, :l][:, :, None]
                    summed = psum_mod(acc, q, qneg, p16, axis)
                    out = ctx.eval_sum(
                        Ciphertext(summed, fscale), ctx.slots)
                    meta["scale"] = out.scale
                    return out.data

            fn = jax.jit(jax.shard_map(
                local, mesh=self.mesh, in_specs=(P(), P(axis)),
                out_specs=P(), check_vma=False))
            self._fns[key] = (fn, meta)
        return self._fns[key]

    def membership(self, query_cts: List[Ciphertext]) -> Ciphertext:
        fstack, fscale = self._flags(query_cts)
        mask = self._membership_mask(fstack.shape[0])
        if mask is not None:
            # ct * {0,1} stays an exact encryption (0 zeroes both parts)
            fstack = fstack * mask[:, None, None, None]
        fn, meta = self._reduce_fn(fscale, tuple(fstack.shape))
        data = fn(self._replicated_state(), fstack)
        return Ciphertext(data, meta["scale"])

    def index(self, query_cts: List[Ciphertext]) -> List[Ciphertext]:
        fstack, fscale = self._flags(query_cts)
        return [Ciphertext(fstack[i], fscale) for i in range(fstack.shape[0])]


class ShardedScenario(_MeshScenario):
    """Runs a sender's membership/index scenario with the DB group axis
    sharded over a mesh: similarity under shard_map on each card's shard,
    then the shared compare and reduce.  Every layout's leading db.data
    axis is an independent batch of DB groups, so this works for the
    diagonal and HERS layouts unconditionally; for blind/base index
    decoding, each shard's local scores must pack into whole ciphertexts
    (slots | local work), and GROTE's group-testing index path is
    inherently global (membership only here — matching its reference cost
    model, src/sender/sender_grote.cpp:13-36).

    Group counts that do not divide the mesh size are padded with all-zero
    ciphertext groups: a zero ciphertext is a valid encryption of 0, its
    scores sit far below the match threshold, its compare flags are ~0, and
    its slot positions map past num_vectors so receivers already filter
    them."""

    def __init__(self, sender, mesh: Mesh, axis: str = "db"):
        super().__init__(sender, mesh, axis)
        self._db = None

    def _mesh_inputs(self):
        """(replicated device state, DB sharded over the mesh), placed once:
        a DB already laid out on the mesh stays where it is."""
        if self._db is None:
            data = self.sender.db.data
            n = self.mesh.shape[self.axis]
            g = data.shape[0]
            if g % n:
                pad = n - g % n
                zeros = jnp.zeros((pad,) + data.shape[1:], dtype=data.dtype)
                data = jnp.concatenate([data, zeros], axis=0)
            self._db = jax.device_put(
                data, NamedSharding(self.mesh, P(self.axis)))
        return self._replicated_state(), self._db

    def _similarity_fn(self, qshape):
        key = ("sim", qshape)
        if key not in self._fns:
            sender, ctx = self.sender, self.sender.ctx
            meta = {}

            def local(state, db_local, qstack):
                old = sender.db.data
                sender.db.data = db_local
                try:
                    with ctx.bound_state(state):
                        qcts = [Ciphertext(qstack[i], ctx.fresh_scale)
                                for i in range(qstack.shape[0])]
                        scores = sender.compute_similarity(qcts)
                        meta["scale"] = scores[0].scale
                        return jnp.stack([s.data for s in scores])
                finally:
                    sender.db.data = old

            fn = jax.jit(jax.shard_map(
                local, mesh=self.mesh, in_specs=(P(), P(self.axis), P()),
                out_specs=P(self.axis), check_vma=False))
            self._fns[key] = (fn, meta)
        return self._fns[key]

    def _scores(self, query_cts: List[Ciphertext]):
        qstack = jnp.stack([c.data for c in query_cts])
        fn, meta = self._similarity_fn(qstack.shape)
        return fn(*self._mesh_inputs(), qstack), meta["scale"]


class ShardedStreamedScenario(_MeshScenario):
    """Multi-chip × beyond-HBM: stream a host-RAM seed-compressed store
    (matching.streaming._SeededStore) across the mesh.

    The store's group list is partitioned into contiguous blocks — device d
    owns groups [d*per, (d+1)*per) — and each step s ships one group per
    device (its own h2d lane) with one-step lookahead prefetch, then runs
    the group similarity under shard_map; compare and the membership
    reduction are the shared ones.  This composes the reference's two
    scaling tricks — OpenMP fan-out and per-op DB streaming
    (src/sender/sender_diag.cpp:70-94) — into one path for DBs that fit
    neither one card's memory nor its host link.

    Every card is fed from host memory of its own: on first use each group
    is copied once into the pinned host memory of the card that owns it
    (numpy where the backend has no such tier), and from there it crosses
    to that card by DMA on every query.  The copies live as long as this
    object, so the host holds the store twice meanwhile.  The store must be
    host-resident (enrolled with resident_budget=0: numpy or pinned-host
    groups); a group resident on one card is refused rather than pulled
    back through it.

    Groups whose index falls past the store (uneven partition) are padded
    with all-zero c0 AND a zeroed seeded c1 (`valid=0` in _group_compute),
    i.e. exact encryptions of 0: their flags decode to non-matches and
    their slot ids land past num_vectors, which receivers already filter.
    Their flags are zeroed before the membership sum: compare of an exact
    encryption of 0 is only ~approx-error-close to 0 per slot, which across
    `slots` slots visibly skews the total."""

    def __init__(self, sender, mesh: Mesh, axis: str = "db"):
        super().__init__(sender, mesh, axis)
        self._host = None

    def _partition(self):
        import math
        n = self.mesh.shape[self.axis]
        G = self.sender.store.num_groups
        return math.ceil(G / n), n, G

    def _host_groups(self):
        """Group g as a [1, dim, L, N] host buffer on the card that owns it
        (pinned host memory of devs[g // per]), placed once."""
        if self._host is None:
            from ..matching.streaming import _on_device, _pinned_sharding
            per, _, _ = self._partition()
            devs = list(self.mesh.devices.flat)
            host = []
            for g, arr in enumerate(self.sender.store.groups):
                if isinstance(arr, jax.Array) and _on_device(
                        arr, next(iter(arr.devices()))):
                    raise ValueError(
                        f"group {g} is resident on a device; enroll the "
                        "store with resident_budget=0 to shard it")
                buf = np.ascontiguousarray(np.asarray(arr))[None]
                dev = devs[g // per]
                pin = _pinned_sharding(dev)
                if pin is not None:
                    # host -> card -> the card's pinned host memory: the
                    # offload direction enrollment already uses
                    buf = jax.device_put(jax.device_put(buf, dev), pin)
                host.append(buf)
            self._host = host
        return self._host

    def _step_arrays(self, s: int, per: int, n: int, G: int):
        """Sharded c0 [n, dim, L, N] + group-index/valid vectors for step
        s: shard d is group d*per+s, copied (async) from its card's own
        host buffer to that card."""
        from ..matching.streaming import _device_sharding
        host = self._host_groups()
        devs = list(self.mesh.devices.flat)
        shape0 = tuple(host[0].shape[1:])
        sharding = NamedSharding(self.mesh, P(self.axis))
        bufs, gidx, valid = [], [], []
        zeros = None
        for d in range(n):
            g = d * per + s
            dev_sh = _device_sharding(devs[d])
            if g < G and s < per:
                bufs.append(jax.device_put(host[g], dev_sh))
                gidx.append(g)
                valid.append(1)
            else:
                if zeros is None:
                    zeros = np.zeros((1,) + shape0, np.uint32)
                bufs.append(jax.device_put(zeros, dev_sh))
                gidx.append(0)
                valid.append(0)
        c0 = jax.make_array_from_single_device_arrays(
            (n,) + shape0, sharding, bufs)
        g_arr = jax.device_put(np.asarray(gidx, np.uint32), sharding)
        v_arr = jax.device_put(np.asarray(valid, np.uint32), sharding)
        return c0, g_arr, v_arr

    def _step_fn(self):
        if "step" not in self._fns:
            sender, ctx, axis = self.sender, self.sender.ctx, self.axis
            meta = {}

            def local(state, Q, c0, g, valid):
                with ctx.bound_state(state):
                    data, scale = sender._group_compute(
                        Q, c0[0], g[0], valid[0])
                    meta["scale"] = scale
                    return data[None]

            fn = jax.jit(jax.shard_map(
                local, mesh=self.mesh,
                in_specs=(P(), P(), P(axis), P(axis), P(axis)),
                out_specs=P(axis), check_vma=False))
            self._fns["step"] = (fn, meta)
        return self._fns["step"]

    def _scores(self, query_cts: List[Ciphertext]):
        per, n, G = self._partition()
        state = self._replicated_state()
        Q = jax.device_put(self.sender._query_stack(query_cts),
                           NamedSharding(self.mesh, P()))
        fn, meta = self._step_fn()
        nxt = self._step_arrays(0, per, n, G)
        outs = []
        for s in range(per):
            cur, nxt = nxt, (self._step_arrays(s + 1, per, n, G)
                             if s + 1 < per else None)
            outs.append(fn(state, Q, *cur))
        # [n, per, 2, l', N] sharded on axis 0 -> flat global group order
        # (stack index k = d*per + s = the group id by construction)
        stacked = jnp.stack(outs, axis=1)
        return stacked.reshape((n * per,) + outs[0].shape[1:]), meta["scale"]

    def _membership_mask(self, n_flags: int):
        # flag positions k >= num_groups are pads (k = d*per + s = group id)
        G = self.sender.store.num_groups
        if n_flags > G:
            return (jnp.arange(n_flags, dtype=jnp.uint32) < G).astype(jnp.uint32)
        return None
