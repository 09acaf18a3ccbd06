"""The port's row-sharded descriptor DB (``descriptors/base.ShardedDB``,
``Mapper.shard_database``), the counterparts of ``tests/test_sharded_db.py``
in two gloo ranks (``torch_rank_tasks.sharded_db_scenarios``, spawned once
for the module): Scan Context queries and a vector family's (M2DP, GRSD,
FPFH and SHOT share ``geometric.vector_query``) on a DB of which each rank
holds half, held against the whole DB and against the JAX package's query;
an insert on the owning rank; the keyframe pipeline with eviction on a
sharded DB against the unsharded one; a checkpoint of the sharded mapper,
which has the whole DB; and ``dryrun_multichip(2, "cpu", "gloo")``.

Tolerances: the sharded answers equal the whole DB's bit for bit (the
candidates' rows come back as 32-bit words); against JAX the matched index
is equal and the distance within 1e-6 (another library's sums), as
``test_torch_scan_context.py`` holds the unsharded query.
"""
import numpy as np
import pytest

import jax.numpy as jnp

from scl_slam_tpu.descriptors import base as jbase
from scl_slam_tpu.descriptors import geometric as jgeo
from scl_slam_tpu.descriptors import scan_context as jsc
from scl_slam_tpu_torch.parallel import dryrun, multihost
from test_torch_kernels import release_jax_programs  # noqa: F401 (autouse)
import torch_rank_tasks

VEC_THRESHOLD = 0.5


def _sc_db(n):
    rng = np.random.RandomState(0)
    imgs = rng.uniform(0, 8, (n, 20, 60)).astype(np.float32)
    return {"descriptors": imgs, "keys": imgs.mean(axis=2), "robot": np.zeros(n, np.int32),
            "index": np.arange(n, dtype=np.int32), "count": np.int32(n)}


def _vec():
    rng = np.random.RandomState(1)
    v = rng.uniform(0, 1, (256, 192)).astype(np.float32)
    v[130] = v[37]           # a tie across the shards goes to the lower row
    db = {"descriptors": v, "keys": v, "robot": np.zeros(256, np.int32),
          "index": np.arange(256, dtype=np.int32), "count": np.int32(256)}
    q = (v[37] + rng.normal(scale=1e-3, size=192)).astype(np.float32)
    return db, q[None], np.array([200], np.int32)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    vec_db, vec_q, vec_qi = _vec()
    data = {"sc_db": _sc_db(256), "sc_db_128": _sc_db(128), "vec_db": vec_db,
            "vec_query": vec_q, "vec_query_index": vec_qi, "vec_threshold": VEC_THRESHOLD,
            "ckpt_dir": str(tmp_path_factory.mktemp("ckpt"))}
    return data, multihost.spawn(torch_rank_tasks.sharded_db_scenarios, 2, (data,),
                                 device="cpu", threads=2,
                                 workdir=str(tmp_path_factory.mktemp("ranks")))


def _same(a, b):
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def _jax_db(d):
    return jbase.DescriptorDB(*(jnp.asarray(d[k]) for k in
                                ("descriptors", "keys", "robot", "index", "count")))


def test_sharded_db_query_matches_unsharded(runs):
    data, outs = runs
    for out in outs:
        assert out["rows_local"] == (128,)   # each rank holds half the rows
        for key in ("sc_query", "sc_inter"):
            _same(*out[key])
        _same(outs[0]["sc_query"][0], out["sc_query"][0])
    got = outs[0]["sc_query"][0]
    assert bool(got["found"][0]) and int(got["index"][0]) == 37  # the exact self-match
    d = data["sc_db"]
    img = jnp.asarray(d["descriptors"][37])
    q = jsc.ScanContext(img, jnp.asarray(d["keys"][37]), jnp.mean(img, axis=0))
    cfg = jsc.ScanContextConfig(exclude_recent=5, num_candidates=8)
    ref = jsc.query(_jax_db(d), q, jnp.array(0), jnp.array(200), cfg, mode="intra")
    assert bool(ref.found) and int(ref.index) == 37 == int(got["db_pos"][0])
    np.testing.assert_allclose(got["distance"][0], float(ref.distance), atol=1e-6)
    ref = jsc.query(_jax_db(d), q, jnp.array(1), jnp.array(0), cfg, mode="inter")
    inter = outs[0]["sc_inter"][0]
    assert bool(inter["found"][0]) == bool(ref.found) and int(inter["index"][0]) == int(ref.index)


def test_sharded_vector_query_matches_unsharded(runs):
    data, outs = runs
    for out in outs:
        _same(*out["vec_query"])
    got = outs[0]["vec_query"][0]
    assert bool(got["found"][0]) and int(got["index"][0]) == 37   # 130 ties it, higher
    ref = jgeo.vector_query(_jax_db(data["vec_db"]), jnp.asarray(data["vec_query"][0]),
                            jnp.array(0), jnp.array(200), num_candidates=5, exclude_recent=3,
                            threshold=VEC_THRESHOLD, mode="intra")
    assert int(ref.index) == 37 and int(ref.db_pos) == int(got["db_pos"][0])
    np.testing.assert_allclose(got["distance"][0], float(ref.distance), atol=1e-6)


def test_sharded_db_insert_roundtrip(runs):
    _, outs = runs
    for out in outs:
        for k, (got, ref) in out["insert"].items():
            np.testing.assert_array_equal(got, ref, err_msg=k)
        assert int(out["insert"]["robot"][0][64]) == 1
        assert int(out["insert"]["count"][0]) == 129


def test_pipeline_matches_unsharded(runs):
    _, outs = runs
    for out in outs:
        p = out["pipeline"]
        assert p["counts"][0] == p["counts"][1] <= 32
        assert p["evicted"][0] == p["evicted"][1] > 0    # 40 keyframes: eviction ran
        assert p["still_sharded"] and p["local_rows"] == (16,)
        for k, (got, ref) in p["db"].items():
            np.testing.assert_array_equal(got, ref, err_msg=k)
        assert p["queue"][0] == p["queue"][1]
        (p1, s1), (p2, s2) = p["full"]
        np.testing.assert_array_equal(s1, s2)
        np.testing.assert_array_equal(p1, p2)
        assert len(s1) == 40
    np.testing.assert_array_equal(outs[0]["pipeline"]["full"][0][0],
                                  outs[1]["pipeline"]["full"][0][0])


def test_checkpoint_of_a_sharded_mapper_is_whole(runs):
    _, outs = runs
    for out in outs:
        c = out["checkpoint"]
        np.testing.assert_array_equal(c["plain"], c["ref"])
        np.testing.assert_array_equal(c["shard"], c["ref"])
        assert c["still_sharded"]


def test_dryrun_multichip_two_ranks_on_gloo(tmp_path):
    outs = dryrun.dryrun_multichip(2, "cpu", "gloo", threads=2, workdir=str(tmp_path))
    assert [o["rank"] for o in outs] == [0, 1]
    for o in outs:
        assert o["A"]["loops"] >= 1 and np.isfinite(o["A"]["chi2"]).all()
        assert o["B"]["counts"][:2] == [8, 3]
        assert o["C"]["evicted"] > 0 and o["C"]["keyframes"] == o["C"]["resident"] + o["C"]["evicted"]
        assert o["D"]["counts"] == [8, 8]
