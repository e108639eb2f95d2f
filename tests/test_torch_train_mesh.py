"""The port's sharding rules and slot-mesh steps on the CPU.

``param_specs``, ``fix_specs``, ``cache_specs`` and ``batch_specs`` equal
repro's for every config on the production mesh sizes (16 x 16 and 2 x
16 x 16; repro on a stand-in mesh that has only axis names and sizes);
``shard`` / ``gather`` invert each other; the slot-mesh train step on
``[cpu] * 4`` at (2, 2) and (4, 1) equals the single-device step (atol
1e-5, rtol 1e-4) for a dense and an MoE config; mesh decode and prefill
equal ``mesh=None``; a checkpoint saved on one slot restores onto four.
"""
from __future__ import annotations

import dataclasses

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.configs as r_configs  # noqa: E402
from repro.configs import (  # noqa: E402,F401  (every config registered)
    internvl2_26b, llama4_maverick, mamba2_370m, musicgen_large,
    qwen2_moe_a2_7b, qwen3_4b, stablelm_3b, stablelm_12b, tinyllama_1_1b,
    zamba2_7b)
from repro.configs.base import SHAPES as R_SHAPES  # noqa: E402
from repro.models import model as r_model  # noqa: E402
from repro.train import sharding as r_sharding  # noqa: E402
import repro_torch.configs as t_configs  # noqa: E402
from repro_torch.configs.base import SHAPES, ShapeConfig  # noqa: E402
from repro_torch.data import synthetic  # noqa: E402
from repro_torch.launch import mesh as t_mesh  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.models import model as t_model  # noqa: E402
from repro_torch.serve import serve_loop  # noqa: E402
from repro_torch.train import checkpoint as t_ckpt  # noqa: E402
from repro_torch.train import optimizer as t_opt  # noqa: E402
from repro_torch.train import sharding as S  # noqa: E402
from repro_torch.train import train_loop as t_train  # noqa: E402

TOL = dict(atol=1e-5, rtol=1e-4)
F32 = dict(dtype="float32", kv_cache_dtype="float32")
SHAPE = ShapeConfig("smoke", 16, 4, "train")
OPT = t_opt.AdamWConfig(lr=1e-4, warmup_steps=2)


class FakeMesh:
    """repro's rules read ``axis_names`` and ``shape`` alone."""

    def __init__(self, mesh):
        self.axis_names, self.shape = mesh.axis_names, mesh.shape


def _norm(spec) -> tuple:
    """A spec as a tuple, one-axis tuples as the axis (jax 0.9's form)."""
    return tuple(p[0] if isinstance(p, tuple) and len(p) == 1 else
                 (tuple(p) if isinstance(p, tuple) else p) for p in spec)


def _specs(tree) -> dict:
    if isinstance(tree, dict):
        return {k: _specs(v) for k, v in tree.items()}
    return _norm(tree)


_SHAPES: dict = {}


def _repro_shapes(name):
    if name not in _SHAPES:
        cfg = r_configs.get(name)
        _SHAPES[name] = jax.eval_shape(lambda k: r_model.init_params(cfg, k),
                                       jax.random.PRNGKey(0))
    return _SHAPES[name]


@pytest.fixture(scope="module", autouse=True)
def _release():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    _SHAPES.clear()


@pytest.mark.parametrize("name", r_configs.ASSIGNED)
def test_specs_equal_repros_on_production_meshes(name):
    rcfg, tcfg = r_configs.get(name), t_configs.get(name)
    rshapes = _repro_shapes(name)
    tshapes = convert.jax_shapes(tcfg)
    assert jax.tree.map(lambda a: tuple(a.shape), rshapes) == \
        convert.map_leaves(tshapes, lambda t: tuple(t.shape))
    for multi_pod in (False, True):
        mesh = t_mesh.make_production_mesh(multi_pod=multi_pod)
        assert mesh.devices is None and mesh.size == 256 * (1 + multi_pod)
        fake = FakeMesh(mesh)
        want = r_sharding.param_specs(rcfg, rshapes, fake)
        got = S.param_specs(tcfg, tshapes, mesh)
        assert _specs(got) == jax.tree.map(
            _norm, want, is_leaf=lambda x: isinstance(x, type(want["embed"])))
        fixed = r_sharding.fix_specs(rshapes, want, fake)
        assert _specs(S.fix_specs(tshapes, got, mesh)) == jax.tree.map(
            _norm, fixed,
            is_leaf=lambda x: isinstance(x, type(want["embed"])))
        for sname, shape in SHAPES.items():
            rshape = R_SHAPES[sname]
            assert _specs(S.cache_specs(tcfg, shape, mesh)) == \
                {k: _norm(v) for k, v in
                 r_sharding.cache_specs(rcfg, rshape, fake).items()}
            assert _specs(S.batch_specs(tcfg, shape, mesh)) == \
                {k: _norm(v) for k, v in
                 r_sharding.batch_specs(rcfg, rshape, fake).items()}


@pytest.mark.parametrize("spec", [S.P("model", "data"), S.P(None, "data"),
                                  S.P(("data", "model"), None), S.P()])
def test_shard_and_gather_invert_each_other(spec):
    mesh = t_mesh.make_local_mesh(model=2, devices=["cpu"] * 4)
    x = torch.arange(7 * 5, dtype=torch.float32).reshape(7, 5)  # uneven
    pieces = S.shard(x, spec, mesh)
    assert pieces.shape == (2, 2)
    assert torch.equal(S.gather(pieces, spec, mesh, "cpu"), x)
    assert all(p.data_ptr() != x.data_ptr() for p in pieces.flat)
    if spec == S.P("model", "data"):
        # (data 0, model 1): rows 4-6 (ceil(7 / 2) a chunk), columns 0-2
        assert torch.equal(pieces[0, 1], x[4:, :3])
        assert torch.equal(pieces[1, 0], x[:4, 3:])


def test_local_mesh_checks_its_slots():
    mesh = t_mesh.make_local_mesh(model=2, devices=["cpu"] * 4)
    assert mesh.shape == {"data": 2, "model": 2}
    assert mesh.first() == torch.device("cpu")
    with pytest.raises(ValueError, match="slots"):
        t_mesh.make_local_mesh(model=3, devices=["cpu"] * 4)
    with pytest.raises(ValueError):
        t_mesh.make_local_mesh(devices=[])


def _model(name, seed=0):
    cfg = dataclasses.replace(t_configs.get(name).reduced(), **F32)
    return cfg, t_model.init_params(cfg, seed=seed, device="cpu")


@pytest.mark.parametrize("name,sizes,microbatches", [
    ("tinyllama-1.1b", (2, 2), 2), ("tinyllama-1.1b", (4, 1), 1),
    ("qwen2-moe-a2.7b", (2, 2), 1),   # 2 x 16 tokens: whole groups, split
    ("qwen2-moe-a2.7b", (4, 1), 1),   # 16 tokens a shard: kept whole
])
def test_mesh_step_equals_single_device_step(name, sizes, microbatches):
    cfg, model = _model(name)
    mesh = t_mesh.make_local_mesh(model=sizes[1], devices=["cpu"] * 4)
    opt = t_opt.init_opt_state(model, OPT)
    params, mopt = t_train.place_state(cfg, model, opt, mesh)
    single = t_train.build_train_step(cfg, OPT, microbatches=microbatches)
    meshed = t_train.build_train_step(cfg, OPT, mesh=mesh, shape=SHAPE,
                                      microbatches=microbatches)
    for s in range(2):
        b = synthetic.batch_for_step(cfg, SHAPE, synthetic.DataConfig(), s)
        want = single(model, opt, b)
        got = meshed(params, mopt, b)
        for k in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(float(got[k]), float(want[k]),
                                       err_msg=k, **TOL)
    back, bopt = t_train.gather_state(cfg, params, mopt, "cpu")
    for (k, a), b in zip(model.named_parameters(), back.parameters()):
        np.testing.assert_allclose(b.numpy(), a.numpy(), err_msg=k, **TOL)
    for k, a in opt["nu"].items():
        np.testing.assert_allclose(bopt["nu"][k].numpy(), a.numpy(),
                                   err_msg=k, **TOL)
    assert int(bopt["step"]) == 2


@pytest.mark.parametrize("name,batch", [
    ("tinyllama-1.1b", 4), ("tinyllama-1.1b", 1),   # batch, sequence split
    ("qwen2-moe-a2.7b", 4), ("zamba2-7b", 4)])
def test_mesh_decode_and_prefill_equal_single_device(name, batch):
    cfg, model = _model(name)
    mesh = t_mesh.make_local_mesh(model=2, devices=["cpu"] * 4)
    shape = ShapeConfig("decode", 32, batch, "decode")
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, (batch, 8)))
    params = serve_loop.place_params(cfg, model, mesh)
    want = serve_loop.build_prefill(cfg)(model, toks)
    got = serve_loop.build_prefill(cfg, mesh, shape)(params, toks)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)
    cache = t_model.init_cache(cfg, batch, 32, device="cpu")
    placed = serve_loop.place_cache(cfg, t_model.init_cache(
        cfg, batch, 32, device="cpu"), mesh, shape)
    step = serve_loop.build_decode_step(cfg)
    mstep = serve_loop.build_decode_step(cfg, mesh, shape)
    for t in range(4):
        want, cache = step(model, cache, toks[:, t:t + 1], t)
        got, placed = mstep(params, placed, toks[:, t:t + 1], t)
        np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)
    for k, v in cache.items():
        np.testing.assert_allclose(placed.gather(k, "cpu").float().numpy(),
                                   v.float().numpy(), err_msg=k, **TOL)


def test_checkpoint_saved_on_one_slot_restores_onto_four(tmp_path):
    """The counterpart of repro's test_elastic_restore_across_device_counts,
    for the parameters alone and for (parameters, optimizer state)."""
    cfg, model = _model("tinyllama-1.1b")
    opt = t_opt.init_opt_state(model, OPT)
    t_train.build_train_step(cfg, OPT)(model, opt, synthetic.batch_for_step(
        cfg, SHAPE, synthetic.DataConfig(), 0))
    t_ckpt.save(str(tmp_path / "params"), model, 42)
    t_ckpt.save(str(tmp_path / "state"), (model, opt), 1)
    mesh = t_mesh.make_local_mesh(model=2, devices=["cpu"] * 4)
    shapes = convert.jax_shapes(cfg)
    specs = S.fix_specs(shapes, S.param_specs(cfg, shapes, mesh), mesh)
    placed, step = t_ckpt.restore_latest(
        str(tmp_path / "params"), t_model.Lm(cfg, "cpu"),
        S.to_shardings(mesh, specs))
    assert step == 42 and isinstance(placed, S.Sharded)
    embed = placed.pieces["embed"]
    assert len({tuple(p.shape) + (p.sum().item(),) for p in embed.flat}) == 4
    back = S.gather_named(cfg, placed, "cpu")
    for k, p in model.named_parameters():
        assert torch.equal(back[k], p), k
    template = (t_model.Lm(cfg, "cpu"), t_opt.init_opt_state(model, OPT))
    (params, popt), step = t_ckpt.restore_latest(
        str(tmp_path / "state"), template,
        (S.to_shardings(mesh, specs), S.to_shardings(
            mesh, S.opt_state_specs(cfg, None, specs, mesh))))
    back, bopt = t_train.gather_state(cfg, params, popt, "cpu")
    assert step == 1 and int(bopt["step"]) == 1
    for k in ("mu", "nu"):
        for n, m in opt[k].items():
            assert torch.equal(bopt[k][n], m), (k, n)


def test_launch_train_on_four_cpu_slots(capsys):
    run = launch_train.main(["--arch", "qwen2-moe-a2.7b", "--reduced",
                             "--device", "cpu", "--devices", "4",
                             "--mesh-model", "2", "--steps", "2",
                             "--seq-len", "16", "--global-batch", "4"])
    assert run.mesh.shape == {"data": 2, "model": 2}
    assert isinstance(run.out["params"], S.Sharded)
    assert len(capsys.readouterr().out.strip().splitlines()) == 2
