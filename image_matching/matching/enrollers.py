"""Enrollers: encrypted-database encoding, one packing layout per approach
(reference src/enroller/*.cpp; SURVEY.md section 2.2).

Each enroller normalizes the plaintext vectors, lays them out into slot
matrices with pure numpy reshapes/rolls, and batch-encrypts the whole thing
(one vectorized FFT + one device NTT pass over the full stack) — the
batched replacement for the reference's OpenMP encrypt-and-serialize
loops.  The result is a dataclass of device arrays, ready for the senders'
batched contractions.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import jax.numpy as jnp

from ..ckks.context import CkksContext
from .config import MatchConfig
from .vector_utils import normalize


@dataclasses.dataclass
class BaseDB:
    """Vector-sequential layout (approaches 1-2): ciphertext i holds
    slots/dim whole vectors back-to-back (reference enroller_base.cpp:13-57)."""
    data: jnp.ndarray  # [num_batches, 2, L, N]
    num_vectors: int
    scale: float


@dataclasses.dataclass
class HersDB:
    """Dimension-major layout (approach 4): ciphertext (m, j) holds feature
    j of `slots` consecutive vectors (reference enroller_hers.cpp:41-122)."""
    data: jnp.ndarray  # [num_matrices, dim, 2, L, N]
    num_vectors: int
    scale: float


@dataclasses.dataclass
class BlindDB:
    """Chunk-column layout (approach 3): ciphertext (m, j) holds chunk j of
    slots/chunk_len vectors (reference enroller_blind.cpp:13-90)."""
    data: jnp.ndarray  # [num_matrices, chunks_per_vector, 2, L, N]
    num_vectors: int
    scale: float


@dataclasses.dataclass
class DiagDB:
    """Diagonalized layout (approach 5, HyDia): square dim x dim matrices
    turned into generalized diagonals, diagonals of matrices_per_batch
    matrices concatenated per ciphertext (reference enroller_diag.cpp:12-166).

    When `bsgs` is set, diagonal (g*j + b) is pre-rotated by +g*j slots at
    enrollment so the sender only needs baby-step rotations of the query
    plus one giant rotation per partial sum (triple-hoisted BSGS idea)."""
    data: jnp.ndarray  # [groups, dim, 2, L, N]; dim axis = (j, b) if bsgs
    num_vectors: int
    scale: float
    bsgs: bool
    n1: int  # baby steps (bsgs only)


def _encrypt_stack(ctx: CkksContext, values: np.ndarray, chunk: int = 64) -> jnp.ndarray:
    """Encrypt [B, slots] -> [B, 2, L, N] in manageable batches."""
    outs = []
    for i in range(0, values.shape[0], chunk):
        outs.append(ctx.encrypt_batch(values[i : i + chunk]))
    return jnp.concatenate(outs, axis=0) if len(outs) > 1 else outs[0]


def enroll_base(ctx: CkksContext, cfg: MatchConfig, db: np.ndarray) -> BaseDB:
    dim = cfg.vector_dim
    batch = ctx.slots
    per = batch // dim
    nvec = db.shape[0]
    nb = math.ceil(nvec / per)
    db = normalize(db)
    flat = np.zeros((nb * per, dim))
    flat[:nvec] = db
    vals = flat.reshape(nb, per * dim)
    return BaseDB(_encrypt_stack(ctx, vals), nvec, ctx.fresh_scale)


def enroll_hers(ctx: CkksContext, cfg: MatchConfig, db: np.ndarray) -> HersDB:
    dim = cfg.vector_dim
    batch = ctx.slots
    nvec = db.shape[0]
    nm = math.ceil(nvec / batch)
    db = normalize(db)
    full = np.zeros((nm * batch, dim))
    full[:nvec] = db
    # values[m, j, k] = db[m*batch + k][j]
    vals = full.reshape(nm, batch, dim).transpose(0, 2, 1).reshape(nm * dim, batch)
    data = _encrypt_stack(ctx, vals).reshape(nm, dim, 2, -1, ctx.n)
    return HersDB(data, nvec, ctx.fresh_scale)


def enroll_blind(ctx: CkksContext, cfg: MatchConfig, db: np.ndarray) -> BlindDB:
    dim, cl = cfg.vector_dim, cfg.chunk_len
    batch = ctx.slots
    cpb = batch // cl  # vectors ("chunks") per batch
    cpv = dim // cl    # chunks per vector
    nvec = db.shape[0]
    nm = math.ceil(nvec / cpb)
    db = normalize(db)
    full = np.zeros((nm * cpb, dim))
    full[:nvec] = db
    # values[m, j, i*cl + t] = full[m*cpb + i][j*cl + t]
    vals = (
        full.reshape(nm, cpb, cpv, cl)
        .transpose(0, 2, 1, 3)
        .reshape(nm * cpv, batch)
    )
    data = _encrypt_stack(ctx, vals).reshape(nm, cpv, 2, -1, ctx.n)
    return BlindDB(data, nvec, ctx.fresh_scale)


def diag_group_vals(sq: np.ndarray, dim: int, mpb: int, bsgs: bool,
                    n1: int) -> np.ndarray:
    """Slot values for one diagonal group: [mpb, dim, dim] normalized
    square matrices -> [dim, mpb*dim] generalized diagonals, BSGS
    pre-rotated when requested (reference enroller_diag.cpp:12-166)."""
    # generalized diagonals: diag[i][j] = M[j][(j+i) % dim]
    j_idx = np.arange(dim)[None, :]
    i_idx = np.arange(dim)[:, None]
    col = (j_idx + i_idx) % dim  # [dim(i), dim(j)]
    diags = sq[:, j_idx.ravel(), col.reshape(dim, dim)]  # [mpb, dim(i), dim(j)]
    vals = diags.transpose(1, 0, 2).reshape(dim, mpb * dim)
    if bsgs:
        n2 = dim // n1
        out = np.empty_like(vals)
        for j in range(n2):
            blk = vals[n1 * j : n1 * (j + 1), :]
            out[n1 * j : n1 * (j + 1), :] = np.roll(blk, n1 * j, axis=-1)
        vals = out
    return vals


def diag_bsgs_n1(dim: int) -> int:
    return 1 << math.ceil(math.log2(dim) / 2)


def enroll_diag(ctx: CkksContext, cfg: MatchConfig, db: np.ndarray,
                bsgs: Optional[bool] = None) -> DiagDB:
    dim = cfg.vector_dim
    batch = ctx.slots
    mpb = batch // dim  # matrices per batch/ciphertext
    nvec = db.shape[0]
    if bsgs is None:
        bsgs = cfg.use_bsgs
    db = normalize(db)
    nmat = math.ceil(nvec / dim)
    groups = math.ceil(nmat / mpb)
    full = np.zeros((groups * mpb * dim, dim))
    full[:nvec] = db
    sq = full.reshape(groups, mpb, dim, dim)  # square matrices
    n1 = diag_bsgs_n1(dim) if bsgs else 1
    vals = np.stack([
        diag_group_vals(sq[g], dim, mpb, bsgs, n1) for g in range(groups)
    ])
    data = _encrypt_stack(ctx, vals.reshape(groups * dim, batch))
    data = data.reshape(groups, dim, 2, -1, ctx.n)
    return DiagDB(data, nvec, ctx.fresh_scale, bsgs, n1)
