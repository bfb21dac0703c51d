"""The port's edge-partitioned ring attention and tp layout against the JAX
package, on gloo CPU worlds.

One world of 4 processes (``torch_parallel_workers.ring_world``, spawned
once for the module, torch on one thread each) runs the ring over tp = 1, 2
and 4 of its ranks on the JAX tests' inputs (tests/test_edge_partition.py:
rows 6, A 16, D 256, 8 heads with prefix masks; rows 4, A 8, D 128, 4
heads with partial masks) and on the first set with one row all masked.

* Forward against the JAX ``edge_partitioned_attention`` on the conftest's
  virtual CPU mesh of tp devices: atol 3e-5 (the JAX tests' bound). The
  all-masked row is the JAX ring's: the mean of all keys' v (its finite
  sentinel), which the dense reference does not give.
* The gradients of sum(out x g) for q, k and v against the dense plain
  math's (autograd through ``reference_masked_attention``): atol 1e-5, and
  the same on every rank of the tp group.
* The mesh layout rank = d * tp + t against ``create_device_mesh``.
* ``param_shard_dim`` against the JAX ``mesh.param_spec`` on the policy
  tree's names.
* ``bench_edges.weak_scaling`` over 1, 2 and 4 ranks at a tiny size.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp
from jax.experimental import mesh_utils
from jax.sharding import Mesh

from crowdnav_prediction_attngraph_tpu import config as jconfig
from crowdnav_prediction_attngraph_tpu.models import policy as j_policy
from crowdnav_prediction_attngraph_tpu.parallel import mesh as j_mesh
from crowdnav_prediction_attngraph_tpu.parallel.edge_partition import (
    edge_partitioned_attention as j_ring)
from crowdnav_prediction_attngraph_tpu_torch.ops.masked_attention import (
    reference_masked_attention)
from crowdnav_prediction_attngraph_tpu_torch.parallel.mesh import (
    param_shard_dim)
from crowdnav_prediction_attngraph_tpu_torch.utils.params import (
    tree_to_state_dict)

import torch_parallel_workers as workers

WORLD = 4


@pytest.fixture(scope="module")
def ring(tmp_path_factory):
    d = tmp_path_factory.mktemp("ring")
    sets = workers.ring_inputs()
    torch.save(sets, d / "inputs.pt")
    mp.spawn(workers.ring_world, nprocs=WORLD,
             args=(WORLD, str(d / "store"), str(d / "inputs.pt"),
                   str(d / "out")))
    ranks = [torch.load(f"{d / 'out'}.{r}", weights_only=False)
             for r in range(WORLD)]
    return sets, ranks


def _jax_ring(s, tp):
    dev = mesh_utils.create_device_mesh((tp,), devices=jax.devices()[:tp])
    mesh = Mesh(dev, ("tp",))
    with mesh:
        out = j_ring(jnp.asarray(s["q"]), jnp.asarray(s["k"]),
                     jnp.asarray(s["v"]), jnp.asarray(s["mask"]),
                     s["heads"], mesh)
    return np.asarray(out)


@pytest.mark.parametrize("tp", workers.RING_TP)
def test_ring_matches_jax(ring, tp):
    sets, ranks = ring
    for i, s in enumerate(sets):
        want = _jax_ring(s, tp)
        got = ranks[0]["forward"][tp, i].numpy()
        np.testing.assert_allclose(got, want, atol=3e-5,
                                   err_msg=f"tp={tp} set={i}")
        # every rank of the tp group returns the whole output
        for r in range(1, tp):
            assert torch.equal(ranks[r]["forward"][tp, i],
                               ranks[0]["forward"][tp, i])
    # the all-masked row: the mean of all keys' v, per head
    s = sets[-1]
    v = s["v"][0].mean(axis=0)
    np.testing.assert_allclose(ranks[0]["forward"][tp, len(sets) - 1][0],
                               np.broadcast_to(v, s["v"][0].shape),
                               atol=3e-5)


@pytest.mark.parametrize("tp", workers.RING_TP)
def test_ring_gradient_matches_dense(ring, tp):
    sets, ranks = ring
    for i, s in enumerate(sets):
        if "g" not in s:
            continue
        q, k, v = (torch.from_numpy(s[key]).requires_grad_()
                   for key in ("q", "k", "v"))
        out = reference_masked_attention(q, k, v, torch.from_numpy(s["mask"]),
                                         s["heads"])
        (out * torch.from_numpy(s["g"])).sum().backward()
        for r in range(tp):
            for name, got, want in zip("qkv", ranks[r]["grads"][tp, i],
                                       (q.grad, k.grad, v.grad)):
                np.testing.assert_allclose(
                    got.numpy(), want.numpy(), atol=1e-5,
                    err_msg=f"d{name} tp={tp} set={i} rank={r}")


def test_mesh_layout_matches_jax_device_mesh(ring):
    _, ranks = ring
    ids = np.vectorize(lambda dev: dev.id)(mesh_utils.create_device_mesh(
        (2, 2), devices=jax.devices()[:WORLD]))
    coords = ranks[0]["coords"]
    for d in range(2):
        for t in range(2):
            assert coords[ids[d, t]] == (d, t)


def test_weak_scaling_over_the_world(ring):
    _, ranks = ring
    res = ranks[0]["weak_scaling"]
    assert sorted(res) == [1, 2, 4]
    assert res[1]["efficiency"] == 1.0
    for r in res.values():
        assert np.isfinite(r["edges_per_s"]) and r["edges_per_s"] > 0
        assert np.isfinite(r["efficiency"]) and r["efficiency"] > 0


@pytest.mark.parametrize("make_cfg", [jconfig.gst_config,
                                      jconfig.varnum_config])
def test_shard_dim_matches_jax_param_spec(make_cfg):
    cfg = make_cfg(human_num=4)
    n, A = 2, cfg.sim.max_human_num
    example = {
        "robot_node": jnp.zeros((n, 7)),
        "temporal_edges": jnp.zeros((n, 2)),
        "spatial_edges": jnp.zeros((n, A, cfg.spatial_edge_dim)),
        "visible_masks": jnp.ones((n, A), bool),
        "detected_human_num": jnp.ones((n,), jnp.int32)}
    tree = jax.eval_shape(lambda k: j_policy.init_params(cfg, k, example),
                          jax.random.key(0))
    leaves = jax.tree_util.tree_flatten_with_path(tree["params"])[0]
    sharded = 0
    for path, leaf in leaves:
        spec = j_mesh.param_spec(path, leaf)
        flax_name = "/".join(k.key for k in path)
        # the port's name and layout of this leaf
        (name, t), = tree_to_state_dict(
            {flax_name: np.zeros(leaf.shape, np.float32)}).items()
        name = name.replace("/", ".")
        dim = param_shard_dim(name, t.shape)
        if spec == jax.sharding.PartitionSpec(None, "tp"):
            sharded += 1
            # the flax kernel's last dim is the sharded one
            assert dim is not None, name
            assert t.shape[dim] == leaf.shape[-1], name
        else:
            assert spec == jax.sharding.PartitionSpec(), name
            assert dim is None, name
    assert sharded == 6
