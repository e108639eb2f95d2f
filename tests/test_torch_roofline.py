"""The port's dry-run, analytic cost, roofline and report launchers
(``repro_torch.launch.{analytic,roofline,dryrun,report}``) against the
JAX package, on the CPU.

``cell_cost`` and ``bfs_cell_cost`` equal repro's bit for bit on every
assigned config, applicable shape (also with an fp8 KV cache) and BFS
level; ``roofline_terms`` scales with the H100's constants as repro's
with its own; ``apply_overrides`` equals repro's.  Dry-run cells of four
reduced configs on one slot and on (2, 2) slots: the argument bytes are
the pieces ``sharding`` really makes, the counted FLOPs equal
``forward_flops`` exactly for the dense forward (the MoE, SSM-decode and
remat counts pinned), and ``collective_stats`` equals a counter around
a real ``_MeshStep`` on ``[cpu] * 4``.  The BFS levels, run on CPU
tensors, equal repro's level bodies bit for bit; the report's rows are
fixed.
"""
from __future__ import annotations

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.configs as r_configs  # noqa: E402
from repro.configs import (  # noqa: E402,F401  (every config registered)
    blest_bfs as r_blest_bfs, internvl2_26b, llama4_maverick, mamba2_370m,
    musicgen_large, qwen2_moe_a2_7b, qwen3_4b, stablelm_3b, stablelm_12b,
    tinyllama_1_1b, zamba2_7b)
from repro.configs.base import SHAPES as R_SHAPES  # noqa: E402
from repro.kernels import ref as r_kref  # noqa: E402
from repro.kernels.pull_ms_packed import (  # noqa: E402
    pull_ms_packed_ref as r_pull_packed)
from repro.kernels.scatter_or import (  # noqa: E402
    scatter_or_ref as r_scatter_or)
from repro.launch import analytic as r_analytic  # noqa: E402
from repro.launch import roofline as r_roofline  # noqa: E402
import repro_torch.configs as t_configs  # noqa: E402
from repro_torch.configs.base import (  # noqa: E402
    SHAPES, ShapeConfig, shape_applicable)
from repro_torch.data import synthetic  # noqa: E402
from repro_torch.launch import analytic, dryrun, report, roofline  # noqa: E402
from repro_torch.launch import mesh as t_mesh  # noqa: E402
from repro_torch.models import model as t_model  # noqa: E402
from repro_torch.serve import serve_loop  # noqa: E402
from repro_torch.train import optimizer as t_opt  # noqa: E402
from repro_torch.train import sharding as S  # noqa: E402
from repro_torch.train import train_loop as t_train  # noqa: E402

HBM = 80 << 30
FP8 = "kv_cache_dtype=float8_e4m3fn"
SMALL = {k: ShapeConfig(k, 16, 4, k) for k in ("train", "prefill", "decode")}
CELL_ARCHS = ("tinyllama-1.1b", "qwen2-moe-a2.7b", "mamba2-370m",
              "zamba2-7b")
OPT = t_opt.AdamWConfig(lr=1e-4, warmup_steps=2)


def _mesh(slots: int):
    return t_mesh.make_local_mesh(model=1 if slots == 1 else 2,
                                  devices=["cpu"] * slots)


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


# ------------------------------------------------------- analytic parity --
LM_CASES = [(a, s, o) for a in t_configs.ASSIGNED
            for s, sh in SHAPES.items()
            if shape_applicable(t_configs.get(a), sh) for o in (None, FP8)]
BFS_CASES = [("blest-bfs", s, c) for s in dryrun.BFS_LEVELS
             for c in (1, 256, 512)]


@pytest.mark.parametrize("arch,shape,extra", LM_CASES + BFS_CASES)
def test_cost_equals_repro_bit_for_bit(arch, shape, extra):
    if arch == "blest-bfs":
        geo = dryrun.Geometry.blest()
        assert (geo.n, geo.nv, geo.tau, geo.sigma) == (
            r_blest_bfs.N_VERTICES, r_blest_bfs.NUM_VSS, r_blest_bfs.TAU,
            r_blest_bfs.SIGMA)
        got = analytic.bfs_cell_cost(shape, geo.n, geo.nv, geo.tau,
                                     geo.sigma, chips=extra)
        want = r_analytic.bfs_cell_cost(shape, geo.n, geo.nv, geo.tau,
                                        geo.sigma, chips=extra)
    else:
        cfg = dryrun.apply_overrides(t_configs.get(arch), extra)
        rcfg = r_configs.get(arch)
        if extra:
            rcfg = dataclasses.replace(rcfg, kv_cache_dtype="float8_e4m3fn")
        got = analytic.cell_cost(cfg, SHAPES[shape])
        want = r_analytic.cell_cost(rcfg, R_SHAPES[shape])
    assert got.flops == want.flops
    assert got.hbm_bytes == want.hbm_bytes
    assert got.detail == want.detail
    assert got.to_json() == want.to_json()


# ------------------------------------------------------- roofline terms --
@pytest.mark.parametrize("flops,nbytes,wire,chips", [
    (1.0, 1.0, 1.0, 1), (3.3e15, 7.1e11, 2.9e9, 256),
    (1.17e16, 4.07e11, 2.65e12, 512), (5e6, 9e13, 0.0, 16)])
def test_roofline_terms_scale_with_the_constants(flops, nbytes, wire, chips):
    got = roofline.roofline_terms(flops, nbytes, wire, chips)
    want = r_roofline.roofline_terms(flops, nbytes, wire, chips)
    for term, mine, theirs in (
            ("compute_s", roofline.PEAK_FLOPS, r_roofline.PEAK_FLOPS),
            ("memory_s", roofline.HBM_BW, r_roofline.HBM_BW),
            ("collective_s", roofline.LINK_BW, r_roofline.LINK_BW)):
        assert got[term] * mine == pytest.approx(want[term] * theirs,
                                                 rel=1e-12)
    assert got["bound_s"] == max(got["compute_s"], got["memory_s"],
                                 got["collective_s"])


def test_roofline_dominance_on_h100_constants():
    """repro's three dominance cases, on the port's constants."""
    t = roofline.roofline_terms(flops=989e12 * 256, bytes_accessed=1.0,
                                collective_wire_bytes=1.0, chips=256)
    assert t["dominant"] == "compute" and abs(t["compute_s"] - 1.0) < 1e-9
    t = roofline.roofline_terms(1.0, 3.35e12 * 256, 1.0, 256)
    assert t["dominant"] == "memory"
    t = roofline.roofline_terms(1.0, 1.0, 50e9 * 256, 256)
    assert t["dominant"] == "collective"


def test_h100_constants_and_repros_factors():
    assert (roofline.PEAK_FLOPS, roofline.HBM_BW, roofline.LINK_BW) == (
        989e12, 3.35e12, 50e9)
    assert roofline.BF16_FLOPS_PER_S == roofline.PEAK_FLOPS
    assert roofline.HBM_BYTES_PER_S == roofline.HBM_BW
    assert (roofline.ALU_OPS_PER_S, roofline.INT8_MMA_OPS_PER_S) == (
        67e12, 1979e12)
    for kind, factor in r_roofline._COLLECTIVE_FACTORS.items():
        assert roofline._COLLECTIVE_FACTORS[kind] == factor
    for n, tokens, kind in ((1_100_048_384, 8192, "train"),
                            (2_700_000_000, 1, "decode")):
        assert roofline.model_flops(n, tokens, kind) == \
            r_roofline.model_flops(n, tokens, kind)


def test_apply_overrides_equals_repro():
    """repro's dry-run module sets XLA_FLAGS when imported: import it
    after the backend has started, and restore the environment."""
    jax.devices()
    saved = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch.dryrun import apply_overrides as r_apply
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    spec = ("remat=dots;moe.dispatch_dtype=bfloat16;attn_block_k=512;"
            "moe.capacity_factor=1.5;" + FP8)
    name = "llama4-maverick-400b-a17b"
    got = dryrun.apply_overrides(t_configs.get(name), spec)
    want = r_apply(r_configs.get(name), spec)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.moe.dispatch_dtype == "bfloat16" and got.remat == "dots"
    assert t_configs.get(name).remat == "full"


# ------------------------------------------------------------ LM cells ----
# FlopCounterMode's counts of the reduced configs at SMALL (4 rows x 16
# positions), pinned: the dense and SSM forwards equal forward_flops; the
# MoE counts the dispatch and combine products the closed form models
# per routing group, and the SSM decode the state update it counts as 3
# products
PINNED_COUNTS = {
    ("qwen2-moe-a2.7b", "prefill"): 13_959_168,
    ("qwen2-moe-a2.7b", "decode"): 782_336,
    ("qwen2-moe-a2.7b", "train"): 40_566_784,
    ("mamba2-370m", "decode"): 608_256,
    ("zamba2-7b", "decode"): 1_946_624,
}


def _forward(cfg, kind) -> float:
    return analytic.forward_flops(cfg, 4, 1 if kind == "decode" else 16, 16)


@pytest.mark.parametrize("slots", (1, 4))
@pytest.mark.parametrize("kind", ("train", "prefill", "decode"))
@pytest.mark.parametrize("arch", CELL_ARCHS)
def test_lm_cell_bytes_and_flops(arch, kind, slots):
    cfg = t_configs.get(arch).reduced()
    shape, mesh = SMALL[kind], _mesh(slots)
    cell = dryrun.lm_cell(cfg, shape, mesh, HBM)
    mem, coord = cell["memory"], (0, 0)
    assert cell["status"] == "ok" and cell["chips"] == slots
    # the argument bytes: the pieces sharding.shard makes for the slot
    model = t_model.init_params(cfg, seed=0, device="cpu")
    if kind == "train":
        opt = t_opt.init_opt_state(model, OPT)
        params, mopt = t_train.place_state(cfg, model, opt, mesh)
        assert mem["opt_bytes"] == _nbytes(mopt["step"]) + sum(
            _nbytes(p[coord]) for m in ("mu", "nu")
            for p in mopt[m].pieces.values())
    else:
        params = serve_loop.place_params(cfg, model, mesh)
    assert mem["param_bytes"] == sum(_nbytes(p[coord])
                                     for p in params.pieces.values())
    n = cell["data_shards"]
    rows = 4 // n
    assert n == (2 if slots == 4 and (kind != "decode" or cfg.moe is None)
                 else 1)
    if kind == "decode":
        cache = serve_loop.place_cache(
            cfg, t_model.init_cache(cfg, 4, 16, "cpu"), mesh, shape)
        assert mem["cache_bytes"] == sum(_nbytes(p[coord])
                                         for p in cache.pieces.values())
        assert mem["batch_bytes"] == 4 * rows + 4   # tokens, cache_len
        parts = mem["param_bytes"] + mem["cache_bytes"]
    else:
        batch = t_train.to_batch(synthetic.batch_for_step(
            cfg, shape, synthetic.DataConfig(), 0), "cpu")
        keys = ("tokens", "targets") if kind == "train" else ("tokens",)
        assert mem["batch_bytes"] == sum(_nbytes(batch[k][:rows])
                                         for k in keys)
        parts = mem["param_bytes"] + mem.get("opt_bytes", 0)
    assert mem["argument_bytes"] == parts + mem["batch_bytes"]
    assert mem["gathered_bytes"] == sum(_nbytes(p)
                                        for p in model.parameters())
    assert mem["peak_bytes"] == (mem["argument_bytes"]
                                 + mem["gathered_bytes"]
                                 + mem["live_peak_bytes"])
    assert mem["fits"] is True and mem["hbm_bytes"] == HBM
    # the counted FLOPs against the closed form's forward
    fwd = _forward(cfg, kind)
    want = PINNED_COUNTS.get((arch, kind),
                             3 * fwd if kind == "train" else fwd)
    assert cell["counted_flops"] == want
    assert cell["slot_counted_flops"] * n == cell["counted_flops"]
    assert cell["flops"] == analytic.cell_cost(cfg, shape).flops
    assert cell["counted_ratio"] == want / cell["flops"]
    terms = roofline.roofline_terms(
        cell["flops"], cell["hbm_bytes"],
        cell["collectives"]["wire_bytes"] * slots, slots)
    assert cell["roofline"] == terms


@pytest.mark.parametrize("remat,count", (("full", 44_040_192),
                                         ("dots", 36_700_160)))
def test_remat_counts_pinned(remat, count):
    """Reduced tinyllama's train step with remat: "full" recomputes every
    layer's forward (3.652 forwards at this shape against the closed
    form's 4), "dots" the products it does not keep."""
    cfg = dataclasses.replace(t_configs.get("tinyllama-1.1b").reduced(),
                              remat=remat)
    cell = dryrun.lm_cell(cfg, SMALL["train"], _mesh(1), 1 << 20)
    assert cell["counted_flops"] == count
    assert cell["memory"]["fits"] is False   # over a 1 MiB device
    assert cell["flops"] == analytic._train_mult(cfg) * _forward(cfg,
                                                                 "train")


class _Counter:
    """What one data slot of a real ``_MeshStep`` moves, counted at the
    calls that move it: ``sharding.gather`` in ``Replicas.load``, the
    gradients of ``train_loop._grads`` and ``sharding.shard`` in the
    update."""

    def __init__(self, cfg, mesh, step):
        self.cfg, self.mesh, self.step = cfg, mesh, step
        self.slots = S.data_slots(mesh)
        self.leaves = len(S.mesh_param_specs(cfg, mesh))
        self.counts: dict = {}
        self.result_bytes: dict = {}
        self.loading = None
        self.computing = 0

    def add(self, kind, nbytes, count=1):
        if nbytes > 0:
            self.counts[kind] = self.counts.get(kind, 0) + count
            self.result_bytes[kind] = (self.result_bytes.get(kind, 0)
                                       + nbytes)

    def install(self, monkeypatch):
        load, gather = S.Replicas.load, S.gather
        grads, shard = t_train._grads, S.shard
        counter = self

        def counted_load(replicas, i, params):
            counter.loading = i
            counter.computing = max(counter.computing, i + 1)
            try:
                return load(replicas, i, params)
            finally:
                counter.loading = None

        def counted_gather(pieces, spec, mesh, device):
            out = gather(pieces, spec, mesh, device)
            if counter.loading == counter.counted():
                own = pieces[counter.slots[counter.loading]]
                counter.add("all-gather", _nbytes(out) - _nbytes(own))
            return out

        def counted_grads(cfg, model, batch, loss_of=None):
            loss, g = grads(cfg, model, batch, loss_of)
            models = counter.step.replicas.models
            if counter.computing > 1 and models.get(
                    counter.counted()) is model:
                counter.add("all-reduce", sum(4 * v.numel()
                                              for v in g.values()),
                            counter.leaves)
            return loss, g

        def counted_shard(leaf, spec, mesh):
            pieces = shard(leaf, spec, mesh)
            slot = counter.slots[counter.counted()]
            if counter.computing > 1:
                counter.add("scatter", _nbytes(pieces[slot]))
            else:
                counter.add("scatter", _nbytes(leaf) - _nbytes(pieces[slot]))
            return pieces

        monkeypatch.setattr(S.Replicas, "load", counted_load)
        monkeypatch.setattr(S, "gather", counted_gather)
        monkeypatch.setattr(t_train, "_grads", counted_grads)
        monkeypatch.setattr(S, "shard", counted_shard)

    def counted(self) -> int:
        """The slot the counts are of: the last computing data slot."""
        return max(self.computing, 1) - 1


@pytest.mark.parametrize("slots", (1, 4))
@pytest.mark.parametrize("arch", CELL_ARCHS)
def test_collectives_equal_a_counted_mesh_step(arch, slots, monkeypatch):
    cfg = dataclasses.replace(t_configs.get(arch).reduced(),
                              dtype="float32", kv_cache_dtype="float32")
    shape, mesh = SMALL["train"], _mesh(slots)
    model = t_model.init_params(cfg, seed=0, device="cpu")
    params, mopt = t_train.place_state(
        cfg, model, t_opt.init_opt_state(model, OPT), mesh)
    step = t_train.build_train_step(cfg, OPT, mesh=mesh, shape=shape)
    counter = _Counter(cfg, mesh, step)
    counter.install(monkeypatch)
    batch = synthetic.batch_for_step(cfg, shape, synthetic.DataConfig(), 0)
    # the slots load first, so the counted slot is known before its
    # gathers: run the step once to learn it, then count a second step
    step(params, mopt, batch)
    computing = counter.computing
    counter.counts.clear()
    counter.result_bytes.clear()
    counter.computing = computing
    step(params, mopt, batch)
    got = roofline.collective_stats(cfg, shape, mesh)
    assert roofline.data_shards(cfg, shape, mesh) == computing
    assert got.counts == counter.counts
    assert got.result_bytes == counter.result_bytes
    assert got.wire_bytes == sum(
        b * roofline._COLLECTIVE_FACTORS[k]
        for k, b in counter.result_bytes.items())
    if slots == 1:
        assert got.wire_bytes == 0


def test_serving_collectives_from_the_specs():
    """Decode and prefill on (2, 2) slots: the parameters the slot lacks,
    its logits, and for decode its cache rows and its piece both ways."""
    cfg = t_configs.get("tinyllama-1.1b").reduced()
    mesh = _mesh(4)
    train = roofline.collective_stats(cfg, SMALL["train"], mesh)
    pre = roofline.collective_stats(cfg, SMALL["prefill"], mesh)
    dec = roofline.collective_stats(cfg, SMALL["decode"], mesh)
    logits = 4 * 2 * cfg.vocab
    assert pre.result_bytes == {"all-gather": train.result_bytes[
        "all-gather"], "collect": logits}
    cache = t_model.init_cache(cfg, 4, 16, "meta")
    specs = S.cache_specs(cfg, SMALL["decode"], mesh)
    moved = sum(_nbytes(S.piece(v, specs[k], mesh, (0, 0)))
                + _nbytes(v[:, :2]) for k, v in cache.items())
    assert dec.result_bytes == {"all-gather": train.result_bytes[
        "all-gather"], "collect": moved + logits, "scatter": moved}


def test_bfs_collectives_from_the_shapes():
    mesh = t_mesh.make_production_mesh()
    n, sigma = 1 << 20, 8
    msbfs = roofline.bfs_collective_stats("msbfs_k64", mesh, n, sigma)
    assert msbfs.result_bytes == {"all-reduce": 4 * (n + sigma)}
    assert msbfs.wire_bytes == 8 * (n + sigma)
    rep = roofline.bfs_collective_stats("ssbfs_replicated", mesh, n, sigma)
    assert rep.result_bytes == {"all-reduce": n + sigma}
    row = roofline.bfs_collective_stats("ssbfs_row", mesh, n, sigma)
    assert row.result_bytes == {"all-gather": n // sigma}
    assert row.counts == {"all-gather": 1}


# ----------------------------------------------------------- BFS levels ---
GEO = dryrun.Geometry(n=64, nv=16, tau=4, sigma=8)


def _level_inputs(name, rng):
    """numpy inputs of ``name``'s level at GEO on one slot."""
    n, nv, tau, sigma = GEO.n, GEO.nv, GEO.tau, GEO.sigma
    num_sets = n // sigma
    shapes = [tuple(t.shape) for t in dryrun.bfs_args(name, GEO)]
    u8 = np.uint8
    masks = rng.integers(0, 256, shapes[0], dtype=u8)
    rows_hi = n + sigma
    rows = rng.integers(0, rows_hi, shapes[1]).astype(np.int32)
    v2r = rng.integers(0, num_sets + 1, shapes[2]).astype(np.int32)
    if name.startswith("msbfs"):
        qids = rng.integers(0, nv, shapes[3]).astype(np.int32)
        if name == "msbfs_packed":
            v = rng.integers(0, 2**32, shapes[4], dtype=np.uint32)
            f = rng.integers(0, 2**32, shapes[5], dtype=np.uint32)
        else:
            v = (rng.random(shapes[4]) < 0.3).astype(u8)
            f = (rng.random(shapes[5]) < 0.3).astype(u8)
        f[-1] = 0
        far = rng.integers(0, 100, shapes[6]).astype(np.int32)
        return [masks, rows, v2r, qids, v, f, far, np.int32(3)]
    v = (rng.random(shapes[3]) < 0.3).astype(u8)
    lvl = rng.integers(-1, 4, shapes[4]).astype(np.int32)
    f = rng.integers(0, 256, shapes[5], dtype=u8)
    f[-1] = 0
    return [masks, rows, v2r, v, lvl, f, np.int32(3)]


def _repro_level(name, a):
    """repro's level bodies (``repro.launch.dryrun._lower_bfs_cell``) on
    one device, where the exchange is the identity."""
    n, sigma = GEO.n, GEO.sigma
    num_sets = n // sigma
    a = [jnp.asarray(x) for x in a]
    if name.startswith("msbfs"):
        masks, row_ids, v2r, qids, v_curr, f_in, far, ell = a
        if "queued" in name or "packed" in name:
            masks, row_ids, v2r = masks[qids], row_ids[qids], v2r[qids]
        if name == "msbfs_packed":
            kw = f_in.shape[2]
            marks = r_pull_packed(masks, f_in[v2r])
            v_next = r_scatter_or(v_curr, row_ids.reshape(-1),
                                  marks.reshape(-1, kw))
            diff = v_next & ~v_curr
            new = jax.lax.population_count(diff).sum(axis=1).astype(
                jnp.int32)
            dt, width = jnp.uint32, kw
        else:
            kappa = f_in.shape[2]
            marks = r_kref.pull_ms_ref(masks, f_in[v2r])
            v_next = v_curr.at[row_ids.reshape(-1)].max(
                marks.reshape(-1, kappa))
            diff = v_next & (1 - v_curr)
            new = diff.sum(axis=1).astype(jnp.int32)
            dt, width = jnp.uint8, kappa
        far = far + ell * new
        f = diff[:n].reshape(num_sets, sigma, width)
        f = jnp.concatenate([f, jnp.zeros((1, sigma, width), dt)])
        return v_next, f, far
    masks_l, rows_l, v2r_l, v, lvl, f_all, ell = a
    marks = r_kref.pull_ss_ref(masks_l, f_all[v2r_l])
    v_next = v.at[rows_l.reshape(-1)].max(marks.reshape(-1))
    v_new, lvl_new, f_words, _ = r_kref.frontier_sweep_ref(
        v, v_next, lvl, ell, sigma=sigma)
    f_next = jnp.concatenate([f_words[:num_sets], jnp.zeros(1, jnp.uint8)])
    return v_new, lvl_new, f_next


def _as_torch(x):
    x = np.asarray(x)
    if x.dtype == np.uint32:
        x = x.view(np.int32)
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("seed", (0, 1))
@pytest.mark.parametrize("name", ("msbfs_level", "msbfs_k64_queued",
                                  "msbfs_packed", "ssbfs_replicated",
                                  "ssbfs_row"))
def test_bfs_level_equals_repro(name, seed):
    a = _level_inputs(name, np.random.default_rng(seed))
    got = dryrun.bfs_level(name, GEO)(*[_as_torch(x) for x in a])
    want = _repro_level(name, a)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        w = _as_torch(w)
        assert g.dtype == w.dtype and torch.equal(g, w)


def test_bfs_level_traces_on_meta():
    """One slot's BFS cells at GEO on (2, 2) slots: shapes only, the
    closed form's FLOPs and the exchange of the level."""
    mesh = _mesh(4)
    for name in dryrun.BFS_LEVELS:
        cell = dryrun.bfs_cell(name, mesh, HBM, GEO)
        assert cell["status"] == "ok" and cell["memory"]["fits"]
        assert cell["flops"] == analytic.bfs_cell_cost(
            name, GEO.n, GEO.nv, GEO.tau, GEO.sigma, chips=4).flops
        assert cell["counted_flops"] > 0
        assert cell["memory"]["argument_bytes"] == sum(
            _nbytes(t) for t in dryrun.bfs_args(
                name, GEO, 1 if name.startswith("msbfs") else 2))


# ---------------------------------------------------- launcher, report ----
def test_dryrun_main_on_the_cpu(tmp_path, monkeypatch, capsys):
    out = tmp_path / "dr"
    dryrun.main(["--arch", "blest-bfs", "--shape", "ssbfs_row", "--mesh",
                 "both", "--out", str(out), "--hbm-bytes", str(HBM),
                 "--tag", "t"])
    names = sorted(p.name for p in out.iterdir())
    assert names == ["blest-bfs__ssbfs_row__16x16__t.json",
                     "blest-bfs__ssbfs_row__2x16x16__t.json"]
    cell = json.loads((out / names[0]).read_text())
    assert cell["status"] == "ok" and cell["chips"] == 256
    assert cell["memory"]["fits"] is True
    assert cell["memory"]["hbm_bytes"] == HBM
    assert {"counted_flops", "roofline", "collectives", "trace_s"} <= set(
        cell)
    assert cell["collectives"]["result_bytes"] == {
        "all-gather": dryrun.Geometry.blest().n // 8}
    capsys.readouterr()
    report.main(["--out", str(out)])
    text = capsys.readouterr().out
    assert text.startswith("2/2 cells ok")
    assert "| blest-bfs | ssbfs_row | 16x16 |" in text
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--hbm-bytes"):
        dryrun.main(["--arch", "blest-bfs", "--shape", "ssbfs_row",
                     "--out", str(out)])


def _cell(arch, shape, mesh, **kw):
    c = {"arch": arch, "shape": shape, "mesh": mesh, "status": "ok",
         "trace_s": 1.25, "counted_flops": 2.0e12, "flops": 2.5e12,
         "hbm_bytes": 3.0e10, "memory": {"fits": True},
         "collectives": {"counts": {"all-gather": 8, "all-reduce": 11}},
         "roofline": {"compute_s": 0.5, "memory_s": 2e-3,
                      "collective_s": 3e-6, "dominant": "compute",
                      "bound_s": 0.5}, "useful_flops_ratio": 0.75}
    c.update(kw)
    return c


def test_report_rows(tmp_path):
    cells = [
        _cell("tinyllama-1.1b", "train_4k", "2x16x16"),
        _cell("tinyllama-1.1b", "train_4k", "16x16",
              memory={"fits": False}),
        {"arch": "zamba2-7b", "shape": "long_500k", "mesh": "16x16",
         "status": "timeout"},
        _cell("blest-bfs", "ssbfs_row", "16x16", useful_flops_ratio=None,
              collectives={"counts": {"all-gather": 1}}),
    ]
    assert report.dryrun_table(cells).splitlines() == [
        "| arch | shape | mesh | trace | counted flops | analytic flops "
        "| HBM bytes | collectives | fits | status |",
        "|---|---|---|---|---|---|---|---|---|---|",
        "| blest-bfs | ssbfs_row | 16x16 | 1.2s | 2.00e+12 | 2.50e+12 "
        "| 3.00e+10 | gath:1 | yes | ok |",
        "| tinyllama-1.1b | train_4k | 16x16 | 1.2s | 2.00e+12 | 2.50e+12 "
        "| 3.00e+10 | gath:8 redu:11 | **no** | ok |",
        "| tinyllama-1.1b | train_4k | 2x16x16 | 1.2s | 2.00e+12 | "
        "2.50e+12 | 3.00e+10 | gath:8 redu:11 | yes | ok |",
        "| zamba2-7b | long_500k | 16x16 | - | - | - | - | - | - "
        "| **timeout** |"]
    assert report.roofline_table(cells).splitlines()[2:] == [
        "| blest-bfs | ssbfs_row | 500.00ms | 2.00ms | 3.0us | "
        "**compute** | 500.00ms | - |",
        "| tinyllama-1.1b | train_4k | 500.00ms | 2.00ms | 3.0us | "
        "**compute** | 500.00ms | 0.75 |"]
    assert [report.fmt_s(x) for x in (None, 2.5, 0.0125, 4e-6)] == [
        "-", "2.50s", "12.50ms", "4.0us"]
    for i, c in enumerate(cells):
        (tmp_path / f"{i}.json").write_text(json.dumps(c))
    assert report.load_cells(str(tmp_path)) == cells
