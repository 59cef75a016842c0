"""Slot-packing operations: order-preserving merge and order-permuting
compression (reference src/openFHE_wrapper.cpp:188-312).

Both repack scattered similarity scores into dense ciphertexts using
plaintext masks (multiplicative levels) and rotate-adds.  Rotations with
identical factors across many ciphertexts are batched with jax.vmap so the
device executes one fused keyswitch over a stacked axis instead of a Python
loop of small ops.
"""

from __future__ import annotations

import math
from typing import List

import numpy as np
import jax
import jax.numpy as jnp

from ..ckks.context import CkksContext, Ciphertext


def merge_chain_rotations(slots: int, dimension: int) -> List[int]:
    """Rotation amounts of merge_single's doubling chain for `dimension`
    ((dimension-1)*2^j, reference mergeSingleCipher's rotationFactor loop)
    — senders request direct keys for these via required_rotations so each
    chain step is ONE keyswitch instead of a signed binary decomposition."""
    out = []
    output_size = slots // dimension
    i = 1
    while i < output_size:
        out.append((dimension - 1) * i)
        i *= 2
    return out


def merge_mask(ctx: CkksContext, dimension: int, segment: int, limbs: int,
               scale: float):
    """Mask with `segment` ones every dimension*segment slots (reference
    generateMergeMask, src/openFHE_wrapper.cpp:253-268)."""
    batch = ctx.slots
    mask = np.zeros(batch)
    i = 0
    while i < batch:
        mask[i : i + segment] = 1.0
        i += dimension * segment
    return ctx.encode_cached(("merge_mask", dimension, segment), mask, limbs, scale)


def merge_single(ctx: CkksContext, ct: Ciphertext, dimension: int,
                 defer: bool = False):
    """Pack every dimension-th slot to the front (reference
    mergeSingleCipher, src/openFHE_wrapper.cpp:223-249).  Consumes 2 levels.

    Rescales are DEFERRED past the rotate-add chain: each rotation's
    keyswitch noise is amplified by the doubling partial sums, so running
    the chain at the un-rescaled mask-product scale (s*Delta..s*Delta^2)
    keeps it ~2^-30..2^-60 below slot values (the same high-scale-rotation
    discipline the diagonal sender uses).  Level consumption is unchanged.
    With defer=True, returns (ct, pending_rescales) so a caller can keep
    the high scale through its own downstream rotations."""
    batch = ctx.slots
    output_size = batch // dimension
    padding = 1
    rot_factor = dimension - 1
    pending = 0
    i = 1
    while i < output_size:
        if i >= padding:
            m = merge_mask(ctx, dimension, i, ct.limbs, ctx.params.scale)
            ct = ctx.mul_plain(ct, m)
            pending += 1
            padding = i * dimension
        ct = ctx.add(ct, ctx.rotate_any(ct, rot_factor * i))
        i *= 2
    m = merge_mask(ctx, dimension, output_size, ct.limbs, ctx.params.scale)
    ct = ctx.mul_plain(ct, m)
    pending += 1
    # guard future call sites: every current caller has dimension >=
    # sqrt(slots) so pending stays <= 2; a smaller dimension would grow the
    # accumulated scale s*Delta^pending past the modulus headroom unchecked
    assert pending <= 2, (
        f"merge_single accumulated {pending} deferred rescales "
        f"(dimension {dimension} < sqrt(slots)); rescale earlier")
    if defer:
        return ct, pending
    for _ in range(pending):
        ct = ctx.rescale(ct)
    return ct


def _batched(ctx: CkksContext, fn, cts: List[Ciphertext]) -> List[Ciphertext]:
    """vmap a single-ciphertext op over a list of same-shape ciphertexts,
    with the width capped (lax.map batch_size) so the rotation-heavy
    merge chains never hold a 512-wide stack of keyswitch temps at once
    (compile-time HBM OOM at 2^14 — see senders._sim_chunk)."""
    if len(cts) == 1:
        return [fn(cts[0])]
    from .senders import _sim_chunk
    scale = cts[0].scale
    stacked = jnp.stack([c.data for c in cts])
    out_scale = [None]

    def body(data):
        out = fn(Ciphertext(data, scale))
        out_scale[0] = out.scale
        return out.data

    chunk = _sim_chunk()
    if len(cts) > chunk:
        res = jax.lax.map(body, stacked, batch_size=chunk)
    else:
        res = jax.vmap(body)(stacked)
    return [Ciphertext(res[i], out_scale[0]) for i in range(len(cts))]


def _rotate_and_pack(ctx: CkksContext, cts: List[Ciphertext],
                     amounts: List[int], out_idx: List[int],
                     out_n: int) -> List[Ciphertext]:
    """Rotate ct[i] left by amounts[i] (one scanned batched keyswitch,
    ctx.rotate_rows_binary) and mod-add the rows into out_n output
    ciphertexts per out_idx — the shared tail of merge/compress/alpha
    packing.  Replaces per-ciphertext binary_rotate loops, whose unrolled
    graphs grow with the ciphertext count (tens of MB of HLO and minutes of
    compilation at ~128 ciphertexts)."""
    from ..ops import modmath as mm

    stacked = jnp.stack([c.data for c in cts])
    rotated = ctx.rotate_rows_binary(stacked, amounts)
    q, _ = ctx._qrow(ctx.q_limbs(stacked.shape[-2]))
    datas: List = [None] * out_n
    for i, oc in enumerate(out_idx):
        datas[oc] = rotated[i] if datas[oc] is None else \
            mm.mod_add(datas[oc], rotated[i], q)
    return [Ciphertext(d, cts[0].scale) for d in datas]


def _tree_pack(ctx: CkksContext, cts: List[Ciphertext],
               step: int, out_n: int) -> List[Ciphertext]:
    """Pack rows whose target amounts follow the uniform pattern
    amounts[i] = -(step*i) mod slots, out_idx[i] = (step*i)//slots — the
    merge/alpha layout — via a pairwise combine tree:

        T^(l+1)_j = T^(l)_{2j} + rot(T^(l)_{2j+1}, -step*2^l)

    Each level is ONE fixed-amount keyswitch over a halving stack, and
    every level amount step*2^l is a power of two (step = slots/dimension
    is a power of two), so the existing +-2^k keys cover it.  Total
    keyswitch work is R-1 single-row equivalents vs the bit-staged
    rotate_rows_binary's ~log2(slots/step)*R — ~9x less at R=128 — and
    each original row still receives exactly popcount(position) rotation
    keyswitches, the same noise budget as its binary-decomposed amount.
    """
    from ..ops import modmath as mm

    batch = ctx.slots
    data = jnp.stack([c.data for c in cts])
    R = data.shape[0]
    gsz = batch // step  # rows per output ciphertext
    pad = out_n * gsz - R
    if pad:
        # zero rows are exact encryptions of 0: rotations and adds keep
        # them inert, so short tails cost only wasted lanes
        data = jnp.concatenate(
            [data, jnp.zeros((pad,) + data.shape[1:], data.dtype)])
    q, _ = ctx._qrow(ctx.q_limbs(data.shape[-2]))
    cur = data.reshape(out_n, gsz, *data.shape[1:])
    lvl = 0
    while cur.shape[1] > 1:
        even = cur[:, 0::2]
        odd = cur[:, 1::2]
        # move the odd subtree RIGHT by step*2^l slots = left-rotate by
        # its negative; step*2^l mod batch stays a power of two, so the
        # standing -2^k rotation keys cover every level
        s = (step << lvl) % batch
        r = -s
        if s:
            g = ctx.rotation_galois(r)
            _, key = ctx._rot_entry(g)
            perm = ctx.plan.auto_perm(g)
            flat = odd.reshape(-1, *data.shape[1:])

            def one(d):
                c0 = jnp.take(d[0], perm, axis=-1)
                c1 = jnp.take(d[1], perm, axis=-1)
                d0, d1 = ctx.keyswitch(c1, key)
                return jnp.stack([mm.mod_add(c0, d0, q), d1])

            odd = jax.vmap(one)(flat).reshape(odd.shape)
        cur = mm.mod_add(even, odd, q)
        lvl += 1
    return [Ciphertext(cur[oc, 0], cts[0].scale) for oc in range(out_n)]


def merge_ciphers(ctx: CkksContext, cts: List[Ciphertext], dimension: int) -> List[Ciphertext]:
    """Merge many ciphertexts' every-dimension-th slots into few dense
    ciphertexts, order preserving (reference mergeCiphers,
    src/openFHE_wrapper.cpp:191-218).  The output-packing rotations sum
    one noise term per input ciphertext into every slot, so they run at
    the deferred (pre-rescale) scale; the pending rescales land on the
    few packed outputs instead."""
    batch = ctx.slots
    per = batch // dimension
    out_n = math.ceil(per * len(cts) / batch)
    pend = [0]

    def one(c):
        out, p = merge_single(ctx, c, dimension, defer=True)
        pend[0] = p
        return out

    merged = _batched(ctx, one, cts)
    if len(merged) == 1:
        outs = merged
    else:
        outs = _tree_pack(ctx, merged, per, out_n)
    done = []
    for o in outs:
        for _ in range(pend[0]):
            o = ctx.rescale(o)
        done.append(o)
    return done


def compress_ciphers(ctx: CkksContext, cts: List[Ciphertext], dimension: int) -> List[Ciphertext]:
    """Blind-Match compression: keep every dimension-th slot, permuted
    packing (reference compressCiphers, src/openFHE_wrapper.cpp:273-312;
    arXiv:2312.11575).  Consumes 1 level."""
    batch = ctx.slots
    out_n = math.ceil(len(cts) / dimension)
    maskv = np.zeros(batch)
    maskv[::dimension] = 1.0

    def mask_one(c: Ciphertext) -> Ciphertext:
        # rescale deferred past the packing rotations (see merge_ciphers)
        m = ctx.encode_cached(("compress_mask", dimension), maskv, c.limbs, ctx.params.scale)
        return ctx.mul_plain(c, m)

    masked = _batched(ctx, mask_one, cts)
    if len(masked) == 1:
        return [ctx.rescale(masked[0])]
    batch = ctx.slots
    amounts = [-(i % dimension) % batch for i in range(len(masked))]
    out_idx = [i // dimension for i in range(len(masked))]
    outs = _rotate_and_pack(ctx, masked, amounts, out_idx, out_n)
    return [ctx.rescale(o) for o in outs]
