"""The port's LM training path against repro's on the CPU.

Weights come from repro's ``init_params`` (``PRNGKey(0)``, reduced configs
in f32) through ``convert.params_from_jax``; batches from
``data/synthetic`` (bit-equal to repro's).  The train step's loss, every
gradient (against ``jax.value_and_grad`` through ``convert.jax_tree_from``)
and the parameters and moments after three steps equal repro's
``build_train_step`` for a dense, an MoE, an SSM and a hybrid config
(atol 1e-5, rtol 1e-4), also with microbatches and bf16 moments; with
weight decay on every leaf where both packages decay alike, repro's
decay of its stacked per-layer vectors pinned; remat none / full / dots
give identical gradients; ``adamw_update`` and ``compressed_psum`` against
repro's formulas; checkpoints in repro's format both ways; ``train()``'s
resume and the launcher.
"""
from __future__ import annotations

import dataclasses
import os
import re
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.configs as r_configs  # noqa: E402
from repro.configs import (  # noqa: E402,F401  (every config registered)
    mamba2_370m, qwen2_moe_a2_7b, tinyllama_1_1b, zamba2_7b)
from repro.models import model as r_model  # noqa: E402
from repro.train import checkpoint as r_ckpt  # noqa: E402
from repro.train import optimizer as r_opt  # noqa: E402
from repro.train import train_loop as r_train  # noqa: E402
import repro_torch.configs as t_configs  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.data import synthetic  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.models import model as t_model  # noqa: E402
from repro_torch.train import checkpoint as t_ckpt  # noqa: E402
from repro_torch.train import optimizer as t_opt  # noqa: E402
from repro_torch.train import train_loop as t_train  # noqa: E402

TOL = dict(atol=1e-5, rtol=1e-4)
F32 = dict(dtype="float32", kv_cache_dtype="float32")
SHAPE = ShapeConfig("smoke", 16, 4, "train")
FAMILIES = ("tinyllama-1.1b", "qwen2-moe-a2.7b", "mamba2-370m", "zamba2-7b")
# lr 1e-4 a step (10x the atol, warmup over 2 steps); larger steps turn
# f32 rounding in tiny gradients into Adam update differences
OPT = dict(lr=1e-4, warmup_steps=2, weight_decay=0.0)
STEPS = 3


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_leaves(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = _np(v)
    return out


def _assert_trees(got, want, tol=TOL, skip=()):
    got, want = _leaves(got), _leaves(want)
    assert sorted(got) == sorted(want)
    for k in got:
        if k not in skip:
            np.testing.assert_allclose(got[k], want[k], err_msg=k, **tol)


def _batch(cfg, step):
    return synthetic.batch_for_step(cfg, SHAPE, synthetic.DataConfig(), step)


_BUILT: dict = {}


def _init(name):
    """repro's config and params, the port's config: built once."""
    if name not in _BUILT:
        rcfg = dataclasses.replace(r_configs.get(name).reduced(), **F32)
        tcfg = dataclasses.replace(t_configs.get(name).reduced(), **F32)
        params = jax.jit(lambda k: r_model.init_params(rcfg, k))(
            jax.random.PRNGKey(0))
        _BUILT[name] = (rcfg, tcfg, jax.tree.map(np.asarray, params))
    return _BUILT[name]


def _repro_step(name, opt, microbatches=1):
    key = (name, tuple(sorted(opt.items())), microbatches)
    if key not in _BUILT:
        rcfg = _init(name)[0]
        _BUILT[key] = r_train.build_train_step(
            rcfg, r_opt.AdamWConfig(**opt), microbatches=microbatches)
    return _BUILT[key]


@pytest.fixture(scope="module", autouse=True)
def _release():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    _BUILT.clear()


def _run_both(name, opt, microbatches=1, steps=STEPS):
    """repro's and the port's states after ``steps`` steps from the same
    weights: ((params, opt_state, metrics), (model, opt_state, metrics))."""
    rcfg, tcfg, tree = _init(name)
    rstep = _repro_step(name, opt, microbatches)
    rparams = jax.tree.map(jnp.asarray, tree)
    ropt = r_opt.init_opt_state(rparams, r_opt.AdamWConfig(**opt))
    model = convert.params_from_jax(tcfg, tree)
    tocfg = t_opt.AdamWConfig(**opt)
    topt = t_opt.init_opt_state(model, tocfg)
    tstep = t_train.build_train_step(tcfg, tocfg, microbatches=microbatches)
    rms, tms = [], []
    for s in range(steps):
        b = _batch(tcfg, s)
        rparams, ropt, rm = rstep(rparams, ropt, jax.tree.map(jnp.asarray, b))
        rms.append(rm)
        tms.append(tstep(model, topt, b))
    return (rparams, ropt, rms), (model, topt, tms)


def _check_run(name, ours, theirs, skip=()):
    (rparams, ropt, rms), (model, topt, tms) = theirs, ours
    tcfg = _init(name)[1]
    for rm, tm in zip(rms, tms):
        for k in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(_np(tm[k]), _np(rm[k]), err_msg=k,
                                       **TOL)
    _assert_trees(convert.jax_tree_from(tcfg, model), rparams, skip=skip)
    mine = convert.opt_state_to_jax(tcfg, topt)
    assert int(mine["step"]) == int(ropt["step"]) == len(rms)
    for k in ("mu", "nu"):
        _assert_trees(mine[k], ropt[k], skip=skip)


# ------------------------------------------------------------ the step ----
@pytest.mark.parametrize("name", FAMILIES)
def test_step_equals_repro(name):
    rcfg, tcfg, tree = _init(name)
    b = _batch(tcfg, 0)
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p, b: r_model.loss_fn(rcfg, p, b)[0]))(
            jax.tree.map(jnp.asarray, tree), jax.tree.map(jnp.asarray, b))
    model = convert.params_from_jax(tcfg, tree)
    tloss, tgrads = t_train._grads(tcfg, model, t_train.to_batch(b, "cpu"))
    np.testing.assert_allclose(_np(tloss), _np(loss), **TOL)
    _assert_trees(convert.jax_tree_from(tcfg, tgrads), grads)
    assert not any(p.requires_grad for p in model.parameters())
    theirs, ours = _run_both(name, OPT)
    _check_run(name, ours, theirs)


def test_step_with_microbatches_equals_repro():
    name = "tinyllama-1.1b"
    theirs, ours = _run_both(name, OPT, microbatches=2)
    _check_run(name, ours, theirs)


def test_step_with_bf16_moments_equals_repro():
    name = "tinyllama-1.1b"
    opt = {**OPT, "moment_dtype": "bfloat16"}
    theirs, ours = _run_both(name, opt)
    assert all(m.dtype == torch.bfloat16 for m in ours[1]["mu"].values())
    _check_run(name, ours, theirs)


def _decays_differ(path: str, ndim: int) -> bool:
    """Where repro's stacked rank and the base rank disagree on decay."""
    from repro_torch.train.sharding import stack_dims

    return (ndim >= 2) != (ndim - stack_dims(path) >= 2)


def test_weight_decay_equal_where_both_decay_alike():
    """Equal on every matrix and on final_norm; repro alone decays the
    stacked norm scales (the hybrid's unstacked shared block: below)."""
    name = "tinyllama-1.1b"
    opt = {**OPT, "weight_decay": 0.1}
    theirs, ours = _run_both(name, opt)
    rparams = _leaves(theirs[0])
    differ = {k for k, v in rparams.items() if _decays_differ(k, v.ndim)}
    assert differ  # the stacked per-layer vectors
    assert all(k.startswith("layers/") and rparams[k].ndim == 2
               for k in differ)
    _check_run(name, ours, theirs, skip=differ)
    mine = _leaves(convert.jax_tree_from(_init(name)[1], ours[0]))
    # repro took lr x 0.1 x p off them each step, the port did not
    decay = 0.1 * sum(float(m["lr"]) for m in theirs[2])
    start = _leaves(_init(name)[2])
    for k in differ:
        np.testing.assert_allclose(mine[k] - rparams[k], decay * start[k],
                                   atol=1e-6, err_msg=k)


def test_repro_decays_stacked_vectors_under_zero_grad():
    """repro's AdamW decays by the stacked rank (optimizer.py:75), so layer
    0's norm moves under a zero gradient; final_norm and the hybrid's
    unstacked shared_attn norms do not; the port leaves every vector
    alone (A_log, D, dt_bias included)."""
    name = "zamba2-7b"
    rcfg, tcfg, tree = _init(name)
    cfg = dict(OPT, lr=1e-2, weight_decay=0.1)
    sub = {"layers": {"norm": tree["layers"]["norm"]},
           "final_norm": tree["final_norm"],
           "shared_attn": {"attn_norm": tree["shared_attn"]["attn_norm"]}}
    params = jax.tree.map(jnp.asarray, sub)
    zeros = jax.tree.map(jnp.zeros_like, params)
    new, _, _ = jax.jit(r_opt.adamw_update, static_argnums=3)(
        params, zeros, r_opt.init_opt_state(params, r_opt.AdamWConfig(
            **cfg)), r_opt.AdamWConfig(**cfg))
    assert not np.array_equal(new["layers"]["norm"][0], sub["layers"]["norm"][0])
    np.testing.assert_array_equal(new["final_norm"], sub["final_norm"])
    np.testing.assert_array_equal(new["shared_attn"]["attn_norm"],
                                  sub["shared_attn"]["attn_norm"])
    model = convert.params_from_jax(tcfg, tree)
    t_opt.adamw_update(model, {k: torch.zeros_like(p) for k, p in
                               model.named_parameters()},
                       t_opt.init_opt_state(model, t_opt.AdamWConfig(**cfg)),
                       t_opt.AdamWConfig(**cfg))
    got = _leaves(convert.jax_tree_from(tcfg, model))
    for k, v in _leaves(tree).items():
        if v.ndim - (1 if k.startswith("layers/") else 0) < 2:
            np.testing.assert_array_equal(got[k], v, err_msg=k)
        else:
            assert not np.array_equal(got[k], v), k


@pytest.mark.parametrize("name", ["tinyllama-1.1b", "zamba2-7b"])
def test_remat_policies_give_identical_gradients(name):
    tcfg = _init(name)[1]
    b = t_train.to_batch(_batch(tcfg, 0), "cpu")
    out = {}
    for remat in ("none", "full", "dots"):
        cfg = dataclasses.replace(tcfg, remat=remat)
        model = convert.params_from_jax(cfg, _init(name)[2])
        out[remat] = t_train._grads(cfg, model, b)
    for remat in ("full", "dots"):
        assert torch.equal(out[remat][0], out["none"][0])
        for k, g in out["none"][1].items():
            assert torch.equal(out[remat][1][k], g), (remat, k)


# ------------------------------------------------------------ optimizer ---
def test_adamw_update_equals_repro():
    """f32 moments (bf16 ones: test_step_with_bf16_moments_equals_repro)."""
    moments = "float32"
    rng = np.random.default_rng(7)
    shapes = {"w": (6, 5), "e": (3, 4, 2), "v": (5,)}
    params = {k: rng.standard_normal(s).astype(np.float32)
              for k, s in shapes.items()}
    cfg = dict(lr=1e-2, warmup_steps=3, weight_decay=0.1, grad_clip=0.5,
               moment_dtype=moments)
    rp = jax.tree.map(jnp.asarray, params)
    ropt = r_opt.init_opt_state(rp, r_opt.AdamWConfig(**cfg))
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    topt = t_opt.init_opt_state(tp, t_opt.AdamWConfig(**cfg))
    for _ in range(4):
        g = {k: rng.standard_normal(s).astype(np.float32)
             for k, s in shapes.items()}
        rp, ropt, rm = r_opt.adamw_update(
            rp, jax.tree.map(jnp.asarray, g), ropt, r_opt.AdamWConfig(**cfg))
        tm = t_opt.adamw_update(tp, {k: torch.from_numpy(v)
                                     for k, v in g.items()}, topt,
                                t_opt.AdamWConfig(**cfg))
        for k in ("grad_norm", "lr"):
            np.testing.assert_allclose(_np(tm[k]), _np(rm[k]), rtol=1e-6)
    for k in shapes:
        np.testing.assert_allclose(_np(tp[k]), _np(rp[k]), atol=1e-6,
                                   rtol=1e-5)
        for m in ("mu", "nu"):
            np.testing.assert_allclose(_np(topt[m][k]), _np(ropt[m][k]),
                                       atol=1e-6, rtol=1e-5)
    assert int(topt["step"]) == int(ropt["step"]) == 4


def _psum_numpy(grads, noises, errors):
    """repro's compressed_psum (optimizer.py:110-135) transcribed to numpy
    over the slots, given each slot's noise."""
    xs = [g.astype(np.float32) + e for g, e in zip(grads, errors)]
    scale = np.float32(max(max(np.abs(x).max(), 1e-12) for x in xs)
                       / np.float32(127.0))
    qs = [np.clip(np.round(x / scale + n), -127, 127)
          for x, n in zip(xs, noises)]
    errs = [x - q * scale for x, q in zip(xs, qs)]
    total = np.sum([q.astype(np.int32) for q in qs], axis=0)
    return total.astype(np.float32) * scale, errs


def test_compressed_psum_on_four_cpu_slots():
    rng = np.random.default_rng(0)
    g = rng.standard_normal((4, 256)).astype(np.float32)
    slots = [{"g": torch.from_numpy(g[i].copy())} for i in range(4)]
    errors = None
    want_err = [np.zeros(256, np.float32)] * 4
    for rnd in range(2):  # the second round carries the residuals
        gen = torch.Generator().manual_seed(rnd)
        red, errs = t_opt.compressed_psum(slots, gen, errors)
        gen = torch.Generator().manual_seed(rnd)
        noises = [(torch.rand(256, generator=gen) - 0.5).numpy()
                  for _ in range(4)]
        want, want_err = _psum_numpy(g, noises, want_err)
        for i in range(4):
            np.testing.assert_allclose(_np(red[i]["g"]), want, rtol=1e-6,
                                       atol=1e-6)
            np.testing.assert_allclose(_np(errs[i]["g"]), want_err[i],
                                       rtol=1e-6, atol=1e-7)
        errors = errs
    exact = g.sum(0)
    rel = np.abs(_np(red[0]["g"]) - exact).max() / np.abs(exact).max()
    assert rel < 0.05  # int8 with a shared scale: about 1% error
    assert np.abs(_np(errs[0]["g"])).max() > 0  # residual carried


def test_quantize_int8_round_trip():
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (64, 8)).astype(np.float32))
    q, scale = t_opt.quantize_int8(x, torch.Generator().manual_seed(0))
    assert q.dtype == torch.int8 and int(q.abs().max()) <= 127
    back = t_opt.dequantize_int8(q, scale)
    assert float((back - x).abs().max()) <= float(scale)


# ----------------------------------------------------------- checkpoint ---
def _small_state(name="tinyllama-1.1b"):
    _, tcfg, tree = _init(name)
    model = convert.params_from_jax(tcfg, tree)
    return model, t_opt.init_opt_state(model, t_opt.AdamWConfig(**OPT))


def test_checkpoint_roundtrip_and_latest(tmp_path):
    model, opt = _small_state()
    t_train.build_train_step(model.cfg, t_opt.AdamWConfig(**OPT))(
        model, opt, _batch(model.cfg, 0))
    t_ckpt.save(str(tmp_path), (model, opt), 7)
    t_ckpt.save(str(tmp_path), (model, opt), 13)
    fresh, fresh_opt = _small_state()
    (m2, o2), step = t_ckpt.restore_latest(str(tmp_path), (fresh, fresh_opt))
    assert step == 13 and m2 is fresh
    for (k, a), b in zip(model.named_parameters(), m2.parameters()):
        assert torch.equal(a, b), k
    for k in ("mu", "nu"):
        for n, a in opt[k].items():
            assert torch.equal(a, o2[k][n]), (k, n)
    assert int(o2["step"]) == 1
    with open(tmp_path / "step_00000013" / "manifest.json") as f:
        keys = __import__("json").load(f)["keys"]
    assert "0/layers/attn/wq" in keys and "1/mu/embed" in keys \
        and "1/step" in keys


def test_checkpoint_detects_corruption_and_ignores_tmp(tmp_path):
    model, _ = _small_state()
    path = t_ckpt.save(str(tmp_path), model, 1)
    os.makedirs(tmp_path / "step_00000002.tmp")
    assert t_ckpt.latest_step_dir(str(tmp_path)).endswith("step_00000001")
    bad = tmp_path / "bad"
    shutil.copytree(path, bad)
    with open(bad / "arrays.npz", "r+b") as f:
        f.seek(100)
        f.write(b"\xde\xad")
    for p in (path, str(bad), str(tmp_path / "missing")):
        assert t_ckpt.verify(p) == r_ckpt.verify(p)
    assert not t_ckpt.verify(str(bad))
    with pytest.raises(IOError):
        t_ckpt.restore(str(bad), model)
    shutil.copy(bad / "arrays.npz", os.path.join(path, "arrays.npz"))
    assert t_ckpt.latest_step_dir(str(tmp_path)) is None  # refuses it


def test_checkpoint_file_is_np_savez_s_and_hashed_while_written(tmp_path):
    rng = np.random.default_rng(0)
    arrays = {f"0/layers/w{i}": rng.standard_normal((64, 1024)).astype(
        np.float32) for i in range(24)}
    arrays["1/step"] = np.asarray(np.int32(7))
    digest = t_ckpt._write_npz(str(tmp_path / "a.npz"), arrays)
    np.savez(tmp_path / "b.npz", **arrays)
    assert digest == t_ckpt._sha256(str(tmp_path / "a.npz"))
    assert os.path.getsize(tmp_path / "a.npz") == \
        os.path.getsize(tmp_path / "b.npz")
    for path in ("a.npz", "b.npz"):
        with np.load(tmp_path / path) as got:
            assert list(got.keys()) == list(arrays)
        mapped = t_ckpt._read_npz(str(tmp_path / path))
        for k, v in arrays.items():
            np.testing.assert_array_equal(mapped[k], v)


def test_checkpoint_written_by_repro_resumes_in_the_port(tmp_path):
    name = "tinyllama-1.1b"
    rcfg, tcfg, tree = _init(name)
    rstep = _repro_step(name, OPT)
    rparams = jax.tree.map(jnp.asarray, tree)
    ropt = r_opt.init_opt_state(rparams, r_opt.AdamWConfig(**OPT))
    rparams, ropt, _ = rstep(rparams, ropt,
                             jax.tree.map(jnp.asarray, _batch(tcfg, 0)))
    r_ckpt.save(str(tmp_path), (rparams, ropt), 1)
    model, opt = _small_state()
    (model, opt), step = t_ckpt.restore_latest(str(tmp_path), (model, opt))
    assert step == 1
    carried = convert.opt_state_from_jax(    # the same state, in memory
        tcfg, jax.tree.map(np.asarray, ropt))
    for k in ("mu", "nu"):
        for n, m in opt[k].items():
            assert torch.equal(carried[k][n], m), (k, n)
    assert int(carried["step"]) == 1
    b = _batch(tcfg, 1)
    rparams, ropt, rm = rstep(rparams, ropt, jax.tree.map(jnp.asarray, b))
    tm = t_train.build_train_step(tcfg, t_opt.AdamWConfig(**OPT))(
        model, opt, b)
    np.testing.assert_allclose(_np(tm["loss"]), _np(rm["loss"]), **TOL)
    _assert_trees(convert.jax_tree_from(tcfg, model), rparams)
    _assert_trees(convert.opt_state_to_jax(tcfg, opt)["nu"], ropt["nu"])


def test_checkpoint_written_by_the_port_restores_in_repro(tmp_path):
    name = "zamba2-7b"
    rcfg, tcfg, _ = _init(name)
    model, opt = _small_state(name)
    t_train.build_train_step(tcfg, t_opt.AdamWConfig(**OPT))(
        model, opt, _batch(tcfg, 0))
    t_ckpt.save(str(tmp_path), (model, opt), 5)
    params = jax.eval_shape(lambda k: r_model.init_params(rcfg, k),
                            jax.random.PRNGKey(0))
    template = (params, jax.eval_shape(
        lambda p: r_opt.init_opt_state(p, r_opt.AdamWConfig()), params))
    (rparams, ropt), step = r_ckpt.restore_latest(str(tmp_path), template)
    assert step == 5
    want = convert.opt_state_to_jax(tcfg, opt)
    _assert_trees(rparams, convert.jax_tree_from(tcfg, model),
                  tol=dict(atol=0, rtol=0))
    for k in ("mu", "nu"):
        _assert_trees(ropt[k], want[k], tol=dict(atol=0, rtol=0))
    assert int(ropt["step"]) == 1


# ---------------------------------------------------------------- train ---
def test_train_resumes_equal_to_an_uninterrupted_run(tmp_path):
    cfg = _init("tinyllama-1.1b")[1]
    kw = dict(cfg=cfg, batch_fn=lambda s: _batch(cfg, s), log_every=1,
              opt_cfg=t_opt.AdamWConfig(**OPT), device="cpu")
    whole = t_train.train(steps=4, **kw)
    first = t_train.train(steps=2, checkpoint_dir=str(tmp_path),
                          checkpoint_every=2, **kw)
    assert len(first["save_s"]) == 1  # step 2 written once
    second = t_train.train(steps=4, checkpoint_dir=str(tmp_path),
                           checkpoint_every=2, **kw)
    assert second["start_step"] == 2 and second["restore_s"] is not None
    assert [h["step"] for h in second["history"]] == [2, 3]
    for h, w in zip(second["history"], whole["history"][2:]):
        assert (h["loss"], h["grad_norm"]) == (w["loss"], w["grad_norm"])
    for a, b in zip(second["params"].parameters(),
                    whole["params"].parameters()):
        assert torch.equal(a, b)
    assert t_ckpt.latest_step_dir(str(tmp_path)).endswith("step_00000004")


def test_straggler_monitor_flags_slow_steps():
    mon = t_train.StragglerMonitor(threshold=2.0)
    for i in range(10):
        assert not mon.observe(i, 0.1)
    assert mon.observe(10, 0.5)
    assert len(mon.events) == 1


# ------------------------------------------------------------- launcher ---
LINE = re.compile(r"^step +\d+  loss \d+\.\d{4}  gnorm \d+\.\d{3}  \d+ ms$")


def test_launch_train_runs_and_resumes(tmp_path, capsys):
    argv = ["--arch", "tinyllama-1.1b", "--reduced", "--device", "cpu",
            "--seq-len", "16", "--global-batch", "4", "--log-every", "1",
            "--ckpt", str(tmp_path), "--ckpt-every", "2"]
    run = launch_train.main(argv + ["--steps", "2"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 2 and all(LINE.match(x) for x in lines), lines
    assert run.mesh is None and run.out["start_step"] == 0
    run = launch_train.main(argv + ["--steps", "3"])
    assert run.out["start_step"] == 2
    assert [h["step"] for h in run.out["history"]] == [2]


def test_launch_train_refuses_without_cuda_and_distributed(monkeypatch):
    with pytest.raises(NotImplementedError, match="NCCL"):
        launch_train.main(["--arch", "tinyllama-1.1b", "--distributed"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        launch_train.main(["--arch", "tinyllama-1.1b", "--reduced",
                           "--steps", "1"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_train.train(_init("tinyllama-1.1b")[1], steps=1,
                      batch_fn=lambda s: None)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_model.init_params(_init("tinyllama-1.1b")[1])
