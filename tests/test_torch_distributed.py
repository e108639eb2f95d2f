"""The port's multi-device BLEST (``repro_torch.core.distributed``) against
the JAX package's and the oracle, on CPU device slots.

A slot group here is ``[torch.device("cpu")] * P``, the counterpart of
``repro``'s forced host devices.  ``build_row_sharded`` field by field
against ``repro``'s at every shard count; ``bfs_row_parallel`` and
``bfs_graph_parallel`` against the oracle and the port's single-device
``Blest.bfs`` on every family; ``closeness_source_parallel`` against
``repro``'s on a one-device mesh in this process and against itself across
slot counts.  The four-device comparison with ``repro`` runs in a
subprocess that forces four host devices.  Levels, words and sums are
integers and closeness is the same float64 formula: equality is exact
(tolerance 0).
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.core import blest as j_blest  # noqa: E402
from repro.core import distributed as j_dist  # noqa: E402
from repro.core.bvss import build_bvss as j_build_bvss  # noqa: E402
from repro.data import graphs as j_graphs  # noqa: E402
from repro_torch.core import blest, distributed, ref_bfs  # noqa: E402
from repro_torch.core.bvss import build_bvss  # noqa: E402
from repro_torch.core.pipeline import Blest  # noqa: E402
from repro_torch.data import graphs  # noqa: E402
from test_torch_msbfs import _port_bd_of  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
UNREACHED = ref_bfs.UNREACHED
RS_SIZES = ("n", "n_pad", "rows_per", "num_sets", "sets_per", "nv_max",
            "sigma", "tau", "n_shards")


def _eq(a, b, msg=""):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=msg)


def _stacked(parts) -> np.ndarray:
    return np.stack([t.cpu().numpy() for t in parts])


@pytest.mark.parametrize("family", ["kron", "road", "rgg", "ring"])
def test_build_row_sharded_matches_reference(family):
    """Every field of the port's row-sharded BVSS equals repro's at shard
    counts 1, 2, 3, 4 and 8, shard_bytes too; shard k lies on slot k."""
    b = build_bvss(graphs.make(family, 8, seed=2))
    jb = j_build_bvss(j_graphs.make(family, 8, seed=2))
    for shards in (1, 2, 3, 4, 8):
        rs = distributed.build_row_sharded(b, shards, [CPU] * shards)
        jrs = j_dist.build_row_sharded(jb, shards)
        for f in RS_SIZES:
            assert getattr(rs, f) == getattr(jrs, f), (shards, f)
        for f in ("masks", "row_ids", "v2r"):
            want = np.asarray(getattr(jrs, f))
            got = _stacked(getattr(rs, f))
            assert got.dtype == want.dtype, (shards, f)
            _eq(got, want, f"{shards} {f}")
        assert rs.shard_bytes == jrs.shard_bytes
        assert len(rs.masks) == shards and rs.devices == (CPU,) * shards


@pytest.mark.parametrize("family", sorted(graphs.FAMILIES))
def test_graph_parallel_bfs_matches_oracle_and_blest(family):
    """Row-partitioned and replicated-V BFS over 1-4 CPU slots equal the
    oracle and the single-device Blest.bfs, from two sources; with
    max_levels=2 they stop after level 2."""
    g = graphs.make(family, 7, seed=1)
    bl = Blest.preprocess(g, device="cpu")
    srcs = [0, g.n // 3]
    want = {s: ref_bfs.bfs_levels(g, s) for s in srcs}
    for s in srcs:
        _eq(bl.bfs(s), want[s])
    for shards in (1, 2, 3, 4):
        slots = [CPU] * shards
        rs = distributed.build_row_sharded(bl.bvss, shards, slots)
        for s in srcs:
            bd_src = int(bl.perm[s])
            for name, lv in (
                    ("row", distributed.bfs_row_parallel(rs, bd_src, slots)),
                    ("graph", distributed.bfs_graph_parallel(
                        bl.bd, bd_src, slots))):
                _eq(lv[bl.perm], want[s], f"{name} {shards} from {s}")
        clip = np.where(want[srcs[1]] <= 2, want[srcs[1]], UNREACHED)
        bd_src = int(bl.perm[srcs[1]])
        _eq(distributed.bfs_row_parallel(rs, bd_src, slots,
                                         max_levels=2)[bl.perm], clip)
        _eq(distributed.bfs_graph_parallel(bl.bd, bd_src, slots,
                                           max_levels=2)[bl.perm], clip)


def test_closeness_source_parallel_matches_reference():
    """On one substrate: repro's source-parallel closeness over its one
    device in this process equals the port's over one slot, in far and
    reach (int64); the port's over 2 and 4 slots equals its own over one,
    also for a source subset that no slot count divides evenly; and
    closeness_from_far equals repro's in both normalisations."""
    jg = j_graphs.make("social", 7, seed=4)
    jbd = j_blest.to_device(j_build_bvss(jg))
    bd = _port_bd_of(jbd)
    mesh = jax.make_mesh((1, 1), ("data", "model"))
    jfar, jreach = j_dist.closeness_source_parallel(
        jbd, mesh, ("data",), kappa=16, use_pallas=False)
    far, reach = distributed.closeness_source_parallel(bd, [CPU], kappa=16)
    assert far.dtype == np.int64 and reach.dtype == np.int64
    _eq(far, jfar)
    _eq(reach, jreach)
    subset = np.arange(3, jg.n, 5, dtype=np.int32)
    one = distributed.closeness_source_parallel(bd, [CPU], kappa=16,
                                                sources=subset)
    for shards in (2, 4):
        _eq(distributed.closeness_source_parallel(bd, [CPU] * shards,
                                                  kappa=16), (far, reach))
        _eq(distributed.closeness_source_parallel(
            bd, [CPU] * shards, kappa=16, sources=subset), one)
    for norm in ("classic", "component"):
        got = distributed.closeness_from_far(jg.n, far, reach, norm)
        _eq(got, j_dist.closeness_from_far(jg.n, jfar, jreach, norm), norm)
    cc = distributed.closeness_from_far(jg.n, far, reach)
    np.testing.assert_allclose(
        cc, ref_bfs.closeness_centrality(graphs.make("social", 7, seed=4)),
        rtol=1e-12)


def test_slot_groups_refuse_what_they_cannot_hold(monkeypatch):
    """No fallback: an empty group, a group mixing cpu and cuda, and a
    CUDA slot on a host without it raise; so does a slot count unequal to
    the shard count."""
    with pytest.raises(ValueError, match="at least one device"):
        distributed.check_slots([])
    with pytest.raises(ValueError, match="one device type"):
        distributed.check_slots([CPU, torch.device("cuda")])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        distributed.check_slots([torch.device("cuda")])
    b = build_bvss(graphs.make("ring", 5))
    with pytest.raises(ValueError, match="2 shards need as many slots"):
        distributed.row_sharded_from_numpy(
            distributed._row_sharded_numpy(b, 2), [CPU] * 3)
    rs = distributed.build_row_sharded(b, 2, [CPU] * 2)
    with pytest.raises(ValueError, match="2 shards need as many slots"):
        distributed.bfs_row_parallel(rs, 0, [CPU])


# ---------------------------------------------------------------------------
# four host devices: repro in a subprocess, the port on four CPU slots
# ---------------------------------------------------------------------------


_REPRO_4 = textwrap.dedent("""
    import json, numpy as np, jax
    from jax.sharding import Mesh
    from repro.data import graphs
    from repro.core.bvss import build_bvss
    from repro.core import blest, distributed
    from repro.serve import mesh as mesh_mod
    assert jax.device_count() == 4
    g = graphs.make("kron", 7, seed=5)
    b = build_bvss(g)
    bd = blest.to_device(b)
    rs = distributed.build_row_sharded(b, 4)
    mesh = jax.make_mesh((1, 4), ("data", "model"))
    out = {"row": [distributed.bfs_row_parallel(
               rs, s, mesh, use_pallas=False).tolist() for s in (0, 77)],
           "graph": distributed.bfs_graph_parallel(
               bd, 77, mesh, use_pallas=False).tolist()}
    smesh = jax.make_mesh((4, 1), ("data", "model"))
    far, reach = distributed.closeness_source_parallel(
        bd, smesh, ("data",), kappa=16, use_pallas=False)
    out["far"], out["reach"] = far.tolist(), reach.tolist()
    m = Mesh(np.array(jax.devices()), (mesh_mod.AXIS,))
    sg = mesh_mod.ShardedGraph(rs=mesh_mod._shard_sharded_arrays(rs, m),
                               mesh=m)
    sbd = mesh_mod.ShardBd(
        n=b.n, n_pad=rs.n_pad, n_ext=rs.n_pad + rs.sigma,
        num_sets=rs.num_sets, num_sets_ext=rs.num_sets + 1,
        num_vss=b.num_vss, num_vss_pad=rs.nv_max * 4, sigma=rs.sigma,
        tau=rs.tau)
    r = mesh_mod.ShardedLaneRunner(sg, sbd, 32, layout="packed")
    src = (np.arange(32) * 5 % g.n).astype(np.int32)
    st = r.reseed(r.init_state(), np.ones(32, bool), src, 0)
    news = []
    for ell in (1, 2, 3):
        st, new = r.level(st, ell)
        news.append(np.asarray(new).tolist())
    out["news"] = news
    out["v"] = np.asarray(st.v).view(np.int32).tolist()
    out["levels"] = np.asarray(st.levels).tolist()
    print(json.dumps(out))
""")


def test_four_devices_match_reference_subprocess():
    """repro on four forced host devices (a subprocess) and the port on
    four CPU slots, on one graph: row-partitioned BFS from two sources,
    replicated-V BFS, source-parallel closeness, and three levels of the
    packed sharded lane runner (new counts, visited words, level stamps)."""
    from repro_torch.serve import mesh as mesh_mod

    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = os.path.join(REPO, "src")
    proc = subprocess.run([sys.executable, "-c", _REPRO_4], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-4000:]
    want = json.loads(proc.stdout.strip().splitlines()[-1])

    slots = [CPU] * 4
    g = graphs.make("kron", 7, seed=5)
    b = build_bvss(g)
    bd = blest.to_device(b, device="cpu")
    rs = distributed.build_row_sharded(b, 4, slots)
    for s, lv in zip((0, 77), want["row"]):
        _eq(distributed.bfs_row_parallel(rs, s, slots), lv)
    _eq(distributed.bfs_graph_parallel(bd, 77, slots), want["graph"])
    far, reach = distributed.closeness_source_parallel(bd, slots, kappa=16)
    _eq(far, want["far"])
    _eq(reach, want["reach"])
    sg = mesh_mod.ShardedGraph(rs=rs, slots=tuple(
        mesh_mod.Slot(k, d) for k, d in enumerate(slots)))
    sbd = mesh_mod.ShardBd(
        n=b.n, n_pad=rs.n_pad, n_ext=rs.n_pad + rs.sigma,
        num_sets=rs.num_sets, num_sets_ext=rs.num_sets + 1,
        num_vss=b.num_vss, num_vss_pad=rs.nv_max * 4, sigma=rs.sigma,
        tau=rs.tau, device=CPU)
    r = mesh_mod.ShardedLaneRunner(sg, sbd, 32, layout="packed")
    src = (np.arange(32) * 5 % g.n).astype(np.int32)
    st = r.reseed(r.init_state(), np.ones(32, bool), src, 0)
    for ell, news in zip((1, 2, 3), want["news"]):
        st, new = r.level(st, ell)
        _eq(new, news, f"level {ell}")
    _eq(_stacked(st.v), want["v"])
    _eq(_stacked(st.levels), want["levels"])
