"""Subprocess worker for test_multihost: one rank of a 2-process
jax.distributed CPU (gloo) job.  Drives multihost.init + local_rows and a
cross-process modular psum over the global mesh — the DCN analog of the
membership reduction (parallel/sharded.psum_mod)."""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main():
    rank, port = int(sys.argv[1]), sys.argv[2]
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_cpu_collectives_implementation", "gloo")

    from image_matching.parallel import multihost

    multihost.init(f"127.0.0.1:{port}", num_processes=2, process_id=rank)
    assert jax.process_count() == 2, jax.process_count()

    # host-level enrollment partitioning
    sl = multihost.local_rows(10)
    assert sl == (slice(0, 5) if rank == 0 else (slice(5, 10))), sl

    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from image_matching.ckks.params import SchemeParams
    from image_matching.ckks.context import CkksContext
    from image_matching.parallel.sharded import psum_mod

    params = SchemeParams.create(ring_dim=512, mult_depth=2, security="none")
    ctx = CkksContext(params, seed=0)
    l = 2
    q, qneg = ctx._qrow(ctx.q_limbs(l))
    p16 = ctx.pow16[:, :l][:, :, None]
    qh = np.asarray(q)  # [l, 1]

    mesh = multihost.global_mesh()
    n_local = len(jax.local_devices())
    n_total = len(jax.devices())

    def shard_for(r):
        rng = np.random.default_rng(100 + r)
        return (rng.integers(0, 2 ** 31, (n_local, l, ctx.n)).astype(np.uint32)
                % qh[None])

    local = shard_for(rank)
    garr = jax.make_array_from_process_local_data(
        NamedSharding(mesh, P("db")), local)

    fn = jax.jit(jax.shard_map(
        lambda x: psum_mod(x[0], q, qneg, p16, "db"),
        mesh=mesh, in_specs=(P("db"),), out_specs=P(), check_vma=False))
    out = np.asarray(fn(garr))

    both = np.concatenate([shard_for(0), shard_for(1)], axis=0)
    expect = np.zeros((l, ctx.n), np.uint64)
    for row in both:
        expect = (expect + row) % qh.astype(np.uint64)
    np.testing.assert_array_equal(out, expect.astype(np.uint32))
    print(f"MULTIHOST-OK rank={rank} procs=2 devices={n_total}", flush=True)


if __name__ == "__main__":
    main()
