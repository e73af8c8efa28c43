"""The port's instance-partitioned tracing (``parallel/object_partition.py``)
on 8 gloo ranks on the CPU, held to the JAX package's on its 8 virtual
devices.

tests/test_object_partition.py's scene (6 separated instances of a sphere
and a floor quad: no cross-instance t-ties) and rays: the port's
``partition_instances`` gives each shard the JAX package's tables byte for
byte (also with more shards than instances, where a shard holds one
degenerate dummy instance); ``partitioned_closest`` / ``partitioned_any``
(each rank tracing only its own shard's tables with the plain version of
kernel B1, unsorted and sorted) equal the trace of the union scene bit for
bit, and the JAX package's (``interpret=True``): prims, instances and
occlusion exactly, t at rtol 1e-5 (tests/test_torch_trace.py's port-vs-JAX
tolerance: XLA may contract multiply-adds that PyTorch keeps apart) and the
barycentrics u, v within 5e-5 (the same rounding, divided by the
determinant: up to ~1.5e-5 apart on these rays); a shard's tables are a fraction of the
union's; dead rays never occlude."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
from jax.sharding import Mesh as JMesh  # noqa: E402

from physically_based_ray_tracer_tpu.parallel import object_partition as jop  # noqa: E402
from physically_based_ray_tracer_tpu_torch.bvh.dense import build_dense_tlas  # noqa: E402
from physically_based_ray_tracer_tpu_torch.config import BVH_FAR  # noqa: E402
from physically_based_ray_tracer_tpu_torch.ops import trace  # noqa: E402
from physically_based_ray_tracer_tpu_torch.parallel import object_partition as top  # noqa: E402
from physically_based_ray_tracer_tpu_torch.parallel.mesh import spawn_ranks  # noqa: E402
from tests import torch_ranks  # noqa: E402
from tests.test_object_partition import _rays, _scene  # noqa: E402

NDEV = 8
TMAX = 6.0
RTOL = 1e-5     # port vs JAX t (tests/test_torch_trace.py's tolerance)
UV_ATOL = 5e-5  # port vs JAX u, v: ~1.5e-5 apart at most on these rays


def _union(mesh_tris, inst_mesh, tf):
    db, _, _ = build_dense_tlas(mesh_tris, inst_mesh, tf, leaf_target=16, shape=True)
    return db


@pytest.fixture(scope="module")
def setup():
    """Per case (6 instances with 1024 rays, 3 instances with 512): the
    JAX and port partitioned scenes, the rays, the port's union table, and
    every rank's results."""
    cases = {}
    for name, n_inst, n_rays in (("six", 6, 1024), ("three", 3, 512)):
        mesh_tris, inst_mesh, tf = _scene(n_inst)
        o, d = _rays(n_rays)
        cases[name] = dict(
            jps=jop.partition_instances(mesh_tris, inst_mesh, tf, n_shards=NDEV),
            ps=top.partition_instances(mesh_tris, inst_mesh, tf, n_shards=NDEV),
            o=o, d=d, union=_union(mesh_tris, inst_mesh, tf),
            to=torch.from_numpy(np.array(o)), td=torch.from_numpy(np.array(d)))
    tmax = lambda c: torch.full((c["to"].shape[0],), TMAX)
    out = spawn_ranks(torch_ranks.partitioned, NDEV, timeout=300, args=(
        NDEV, [(c["ps"], c["to"], c["td"], tmax(c)) for c in cases.values()]))
    for i, c in enumerate(cases.values()):
        c["ranks"] = [o[i] for o in out]
    return cases


@pytest.mark.parametrize("name", ["six", "three"])
def test_partition_tables_match_jax(setup, name):
    c = setup[name]
    jps, ps = c["jps"], c["ps"]
    assert (ps.n_shards, ps.max_depth) == (jps.n_shards, jps.max_depth)
    for f in top.TABLES:
        np.testing.assert_array_equal(ps.dbvh[f], np.asarray(getattr(jps.dbvh, f)), err_msg=f)
    np.testing.assert_array_equal(ps.inst_gmap, np.asarray(jps.inst_gmap))
    np.testing.assert_array_equal(ps.prim_off, np.asarray(jps.prim_off))


@pytest.mark.parametrize("name", ["six", "three"])
def test_partitioned_closest_equals_jax_and_union(setup, name):
    c = setup[name]
    jmesh = JMesh(np.array(jax.devices()[:NDEV]), ("obj",))
    want = jop.partitioned_closest(c["jps"], jmesh, c["o"], c["d"], interpret=True,
                                   sort=False)
    union = trace.intersect_closest_dense(c["union"], c["to"], c["td"])
    assert (union.prim.numpy() >= 0).mean() > 0.3
    for got in c["ranks"]:          # the combined record is the same on every rank
        for k in ("t", "u", "v", "prim", "inst"):
            np.testing.assert_array_equal(got[k], getattr(union, k).numpy(), err_msg=k)
        for k in ("prim", "inst"):
            np.testing.assert_array_equal(got[k], np.asarray(getattr(want, k)), err_msg=k)
        np.testing.assert_allclose(got["t"], np.asarray(want.t), rtol=RTOL)
        for k in ("u", "v"):
            np.testing.assert_allclose(got[k], np.asarray(getattr(want, k)), rtol=0,
                                       atol=UV_ATOL, err_msg=k)
        np.testing.assert_array_equal(got["sorted_t"], got["t"])
        np.testing.assert_array_equal(got["sorted_prim"], got["prim"])


def test_partitioned_any_equals_jax_and_union(setup):
    c = setup["six"]
    jmesh = JMesh(np.array(jax.devices()[:NDEV]), ("obj",))
    jt = jnp.full((c["o"].shape[0],), TMAX, jnp.float32)
    want = np.asarray(jop.partitioned_any(c["jps"], jmesh, c["o"], c["d"], jt,
                                          interpret=True, sort=False))
    union = trace.intersect_any_dense(c["union"], c["to"], c["td"],
                                      torch.full((c["to"].shape[0],), TMAX)).numpy()
    assert 0 < union.mean() < 1
    for got in c["ranks"]:
        np.testing.assert_array_equal(got["occ"], want)
        np.testing.assert_array_equal(got["occ"], union)
        np.testing.assert_array_equal(got["occ_sorted"], union)
        assert not got["occ0"].any()          # dead rays never occlude


def test_partitioned_memory_scales_and_empty_shards_miss(setup):
    c = setup["six"]
    union_bytes = top.table_bytes(c["union"])
    for got in c["ranks"]:
        assert got["bytes"] < union_bytes, (got["bytes"], union_bytes)
    assert c["ps"].dbvh["groups"].shape[1] < c["union"].groups.shape[0]
    # 3 instances on 8 shards: shards 3-7 hold the dummy and never win
    e = setup["three"]
    assert (e["ranks"][0]["inst"] < 3).all()
    found = e["ranks"][0]["t"] < BVH_FAR * 0.5
    np.testing.assert_array_equal(found, e["ranks"][0]["prim"] >= 0)
