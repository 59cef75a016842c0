"""Placement on a device mesh (8 virtual CPU devices here): keys are
replicated once, an in-memory DB is laid out across the mesh, and the
streamed sharded path feeds every device from host memory and refuses a
group resident on one device."""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from image_matching.ckks.context import CkksContext
from image_matching.ckks.params import SchemeParams
from image_matching.parallel import sharded


@pytest.fixture(scope="module")
def ctx():
    return CkksContext(SchemeParams.create(ring_dim=512, mult_depth=3,
                                           security="none"), seed=1)


def _devices_of(x):
    return {d for leaf in jax.tree_util.tree_leaves(x) for d in leaf.devices()}


def test_replicated_state_on_every_device(ctx):
    mesh = sharded.make_mesh(4)
    state = sharded.replicated_state(ctx, mesh)
    for leaf in jax.tree_util.tree_leaves(state):
        assert leaf.devices() == set(mesh.devices.flat)
        assert leaf.sharding.is_fully_replicated


@pytest.mark.parametrize("groups", [4, 3])
def test_sharded_scenario_lays_db_over_mesh(ctx, groups):
    mesh = sharded.make_mesh(4)
    data = jnp.arange(groups * 6, dtype=jnp.uint32).reshape(groups, 2, 3)
    sender = types.SimpleNamespace(ctx=ctx, db=types.SimpleNamespace(data=data))
    scen = sharded.ShardedScenario(sender, mesh)
    state, db = scen._mesh_inputs()
    assert db.shape[0] == 4  # padded to the mesh size with zero groups
    assert [s.data.shape[0] for s in db.addressable_shards] == [1] * 4
    np.testing.assert_array_equal(np.asarray(db)[:groups], np.asarray(data))
    assert not np.asarray(db)[groups:].any()
    assert scen._mesh_inputs()[1] is db  # placed once, then reused


def _streamed(ctx, groups):
    store = types.SimpleNamespace(groups=groups, num_groups=len(groups))
    sender = types.SimpleNamespace(ctx=ctx, store=store)
    return sharded.ShardedStreamedScenario(sender, sharded.make_mesh(2))


def test_streamed_step_feeds_each_device_from_host(ctx):
    groups = [np.full((2, 3), g, np.uint32) for g in range(3)]
    scen = _streamed(ctx, groups)
    per, n, G = scen._partition()
    c0, g_arr, valid = scen._step_arrays(1, per, n, G)
    shards = sorted(c0.addressable_shards, key=lambda s: s.index[0].start)
    assert [s.device for s in shards] == list(scen.mesh.devices.flat)
    np.testing.assert_array_equal(np.asarray(c0)[:, 0, 0], [1, 0])
    np.testing.assert_array_equal(np.asarray(g_arr), [1, 0])
    np.testing.assert_array_equal(np.asarray(valid), [1, 0])  # group 3 is pad


def test_streamed_groups_pinned_on_owning_device(ctx):
    groups = [np.full((2, 3), g, np.uint32) for g in range(3)]
    scen = _streamed(ctx, groups)
    host = scen._host_groups()
    devs = list(scen.mesh.devices.flat)
    for g, buf in enumerate(host):  # per = 2: groups 0, 1 -> dev 0; 2 -> dev 1
        assert buf.sharding.memory_kind == "pinned_host"
        assert buf.devices() == {devs[g // 2]}
        np.testing.assert_array_equal(np.asarray(buf), groups[g][None])
    assert scen._host_groups() is host  # placed once, then reused


def test_streamed_step_refuses_device_resident_group(ctx):
    groups = [jax.device_put(np.zeros((2, 3), np.uint32), jax.devices()[0]),
              np.zeros((2, 3), np.uint32)]
    scen = _streamed(ctx, groups)
    with pytest.raises(ValueError, match="resident_budget=0"):
        scen._step_arrays(0, *scen._partition())
