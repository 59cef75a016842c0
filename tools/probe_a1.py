"""Probe: where does the A1 score error enter at production ring?
Compares (a) raw per-batch scores (mul+relin+rescale+eval_sum(512)) and
(b) merged scores, both against the plaintext cosine oracle."""
import time
import numpy as np, jax, jax.numpy as jnp
from image_matching.utils.jaxcfg import enable_compilation_cache
enable_compilation_cache()
from image_matching.ckks.params import SchemeParams, compute_required_depth
from image_matching.ckks.context import Ciphertext
from image_matching.matching.config import MatchConfig
from image_matching.matching.protocol import MatchingProtocol
from image_matching.matching import vector_utils as vu
from image_matching.utils import io as dio

cfg = MatchConfig()
depth = compute_required_depth(1, cfg.comp_depth, cfg.alpha_depth)
params = SchemeParams.create(ring_dim=32768, mult_depth=depth, security="128c")
n = 1024
query, db = dio.gen_dataset(n, cfg.vector_dim, seed=0)
proto = MatchingProtocol.setup(1, db, cfg, params=params, seed=0)
sims = vu.cosine_similarity(vu.normalize(query)[None, :], vu.normalize(db))
qcts = proto.encrypt_query(query)
sender = proto.sender
ctx = proto.ctx

def raw_fn(state, qs, dbd):
    old = sender.db.data; sender.db.data = dbd
    try:
        with ctx.bound_state(state):
            scores = sender._raw_scores([Ciphertext(qs[i], ctx.fresh_scale) for i in range(qs.shape[0])])
            return jnp.stack([s.data for s in scores]), scores[0].scale
    finally:
        sender.db.data = old

qstack = jnp.stack([c.data for c in qcts])
jraw = jax.jit(raw_fn)
t0=time.time()
rdata, rscale = jraw(ctx.device_state(), qstack, sender.db.data)
jax.block_until_ready(rdata)
print("raw compile+run", round(time.time()-t0,1), "s", flush=True)
per = ctx.slots // cfg.vector_dim  # vectors per batch ct
errs = []
for b in range(rdata.shape[0]):
    vals = ctx.decrypt(Ciphertext(rdata[b], float(rscale)))
    got = vals[:: cfg.vector_dim][:per]
    want = sims[b*per:(b+1)*per]
    errs.append(np.abs(got[:len(want)] - want).max())
print("RAW score max err:", max(errs), flush=True)

sdata, meta = sender._similarity_segment(qstack, sender.db.data)
jax.block_until_ready(sdata)
vals = np.concatenate([ctx.decrypt(Ciphertext(sdata[i], meta["scale"])) for i in range(sdata.shape[0])])
print("MERGED score max err:", np.abs(vals[:n] - sims).max(), flush=True)
