"""The port's LM serving path against repro's on the CPU.

``data.synthetic`` batches bit-equal to repro's in every modality and for
two hosts, the ``Prefetcher``'s order; ``serve_loop.BatchEngine`` equal to
repro's token for token where repro is well defined (every request
admitted in the first tick), and every request equal to repro's solo run
(``slots=1``) when slots are refilled, for a dense, an SSM and a hybrid
config; repro's refilled requests pinned as differing from their solo runs
(its shared ``cache_len`` and stale slot state); ``launch.serve`` printing
repro's line; ``examples/port/serve_lm.py``; the mesh form and a missing
CUDA device refused.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.configs as r_configs  # noqa: E402
from repro.configs.base import ShapeConfig as RShape  # noqa: E402
from repro.data import synthetic as r_synthetic  # noqa: E402
from repro.models import model as r_model  # noqa: E402
from repro.serve import serve_loop as r_serve  # noqa: E402
import repro_torch.configs as t_configs  # noqa: E402
from repro_torch.configs.base import ShapeConfig as TShape  # noqa: E402
from repro_torch.data import synthetic as t_synthetic  # noqa: E402
from repro_torch.launch import serve as launch_serve  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.models import model as t_model  # noqa: E402
from repro_torch.serve import serve_loop as t_serve  # noqa: E402
from test_torch_lm_models import repro_tree  # noqa: E402

EXAMPLE = (pathlib.Path(__file__).resolve().parent.parent / "examples"
           / "port" / "serve_lm.py")
SERVED = re.compile(r"^served (\d+) requests, (\d+) tokens in [\d.]+s "
                    r"\([\d.]+ tok/s\)$")
F32 = dict(dtype="float32", kv_cache_dtype="float32")


# ------------------------------------------------------------- synthetic ---
@pytest.mark.parametrize("name,num_hosts,host_id", [
    ("tinyllama-1.1b", 1, 0), ("musicgen-large", 1, 0),
    ("internvl2-26b", 1, 0), ("tinyllama-1.1b", 2, 0),
    ("internvl2-26b", 2, 1)])
def test_batch_for_step_bit_equal(name, num_hosts, host_id):
    rcfg, tcfg = r_configs.get(name).reduced(), t_configs.get(name).reduced()
    kw = dict(seed=3, num_hosts=num_hosts, host_id=host_id)
    for step in (0, 5):
        want = r_synthetic.batch_for_step(
            rcfg, RShape("s", 32, 4, "train"), r_synthetic.DataConfig(**kw),
            step)
        got = t_synthetic.batch_for_step(
            tcfg, TShape("s", 32, 4, "train"), t_synthetic.DataConfig(**kw),
            step)
        assert sorted(got) == sorted(want)
        for key in want:
            assert got[key].dtype == want[key].dtype, key
            np.testing.assert_array_equal(got[key], want[key], key)


def test_prefetcher_gives_repros_order():
    name = "tinyllama-1.1b"
    cfg = t_configs.get(name).reduced()
    shape = TShape("s", 16, 2, "train")
    pf = t_synthetic.Prefetcher(cfg, shape, t_synthetic.DataConfig(),
                                start_step=3)
    try:
        for step in (3, 4, 5):
            want = r_synthetic.batch_for_step(
                r_configs.get(name).reduced(), RShape("s", 16, 2, "train"),
                r_synthetic.DataConfig(), step)
            got = pf.get()
            np.testing.assert_array_equal(got["tokens"], want["tokens"])
    finally:
        pf.close()
    assert not pf.thread.is_alive()


# ---------------------------------------------------------------- engine ---
_BUILT: dict = {}


def _case(name: str, repro_init: bool = False):
    """repro's config and params and the port's model on the same f32
    weights: repro's ``init_params(PRNGKey(0))`` loaded through
    ``params_from_jax`` where ``repro_init``, else the port's draw."""
    key = (name, repro_init)
    if key not in _BUILT:
        rcfg = dataclasses.replace(r_configs.get(name).reduced(), **F32)
        tcfg = dataclasses.replace(t_configs.get(name).reduced(), **F32)
        if repro_init:
            params = jax.jit(lambda k: r_model.init_params(rcfg, k))(
                jax.random.PRNGKey(0))
            model = convert.params_from_jax(
                tcfg, jax.tree.map(np.asarray, params))
        else:
            model = t_model.init_params(tcfg, seed=0, device="cpu")
            params = jax.tree.map(jnp.asarray, repro_tree(tcfg, model))
        _BUILT[key] = (rcfg, tcfg, params, model)
    return _BUILT[key]


@pytest.fixture(scope="module", autouse=True)
def _release_models():
    """One intra-op thread for these small tensors (several test workers
    share the host's cores), and the built models dropped at the end."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    _BUILT.clear()


def _requests(mod, vocab: int, n: int, max_new: int):
    rng = np.random.default_rng(0)
    return [mod.Request(rid=i, prompt=rng.integers(0, vocab, 4 + 3 * i),
                        max_new=max_new) for i in range(n)]


def _serve(mod, cfg, weights, slots, reqs, decode=None):
    eng = mod.BatchEngine(cfg, weights, slots=slots, max_seq=64, eos=-1)
    if decode is not None:  # repro: one compiled decode for every engine
        eng.decode = decode
    for r in reqs:
        eng.submit(r)
    done = eng.run_until_done()
    assert all(r.done for r in done)
    return [r.generated for r in done], eng


def _repro_solo(rcfg, params, vocab, n, max_new):
    """Each request alone in a fresh one-slot repro engine."""
    out, decode = [], None
    for req in _requests(r_serve, vocab, n, max_new):
        (gen,), eng = _serve(r_serve, rcfg, params, 1, [req], decode)
        decode = eng.decode
        out.append(gen)
    return out


@pytest.mark.parametrize("name", ["tinyllama-1.1b", "mamba2-370m",
                                  "zamba2-7b", "qwen2-moe-a2.7b"])
def test_engine_equals_repro_when_all_admitted_at_once(name):
    """Requests <= slots: every cursor moves together, so repro's shared
    cache_len is each slot's own and its engine is well defined."""
    rcfg, tcfg, params, model = _case(name)
    want, _ = _serve(r_serve, rcfg, params, 4,
                     _requests(r_serve, rcfg.vocab, 3, 5))
    got, eng = _serve(t_serve, tcfg, model, 4,
                      _requests(t_serve, tcfg.vocab, 3, 5))
    assert got == want
    assert all(len(g) == 5 for g in got)
    assert eng.ticks == 4 + 3 * 2 + 5 - 1  # the longest prompt, then 5


@pytest.mark.parametrize("name,repro_init", [
    ("tinyllama-1.1b", True), ("mamba2-370m", False), ("zamba2-7b", False)])
def test_refilled_requests_equal_repros_solo_runs(name, repro_init):
    """Four requests over two slots (requests 2 and 3 refill them): each
    one's tokens are repro's solo run's."""
    rcfg, tcfg, params, model = _case(name, repro_init)
    got, _ = _serve(t_serve, tcfg, model, 2,
                    _requests(t_serve, tcfg.vocab, 4, 6))
    assert got == _repro_solo(rcfg, params, rcfg.vocab, 4, 6)


def test_repro_refills_differ_from_their_solo_runs():
    """repro's fault, pinned: one ``cache_len = cursor.max()`` for the whole
    batch (``serve/serve_loop.py:114``), so a refilled slot is roped at the
    shared position and reads its previous occupant's K/V.  Reduced
    tinyllama, f32, PRNGKey(0), prompts of 4 + 3 i tokens from
    default_rng(0), two slots, six new tokens: requests 0 and 1 match
    their solo runs, the refills 2 and 3 do not."""
    rcfg, _, params, _ = _case("tinyllama-1.1b", repro_init=True)
    batch, _ = _serve(r_serve, rcfg, params, 2,
                      _requests(r_serve, rcfg.vocab, 4, 6))
    solo = _repro_solo(rcfg, params, rcfg.vocab, 4, 6)
    assert batch[:2] == solo[:2]
    assert batch[2] != solo[2] and batch[3] != solo[3]


def test_admission_zeroes_the_slots_recurrent_state():
    _, tcfg, _, model = _case("mamba2-370m")
    eng = t_serve.BatchEngine(tcfg, model, slots=2, max_seq=32, eos=-1)
    for key in ("ssm", "conv"):
        eng.cache[key].fill_(1.0)
    eng.submit(t_serve.Request(rid=0, prompt=np.array([3, 4]), max_new=1))
    eng._admit()
    for key in ("ssm", "conv"):
        assert (eng.cache[key][:, 0] == 0).all()
        assert (eng.cache[key][:, 1] == 1).all()


# ---------------------------------------------------- launcher, example ---
@pytest.mark.parametrize("dtype", [None, "float32"])
def test_launch_serve_prints_repros_line(dtype, capsys):
    argv = ["--arch", "tinyllama-1.1b", "--reduced", "--requests", "3",
            "--max-new", "4", "--device", "cpu"]
    served = launch_serve.main(argv + (["--dtype", dtype] if dtype else []))
    line = capsys.readouterr().out.strip().splitlines()[-1]
    m = SERVED.match(line)
    assert m, line
    assert (int(m[1]), int(m[2])) == (3, 12)
    assert all(len(r.generated) == 4 for r in served.requests)
    want = torch.float32 if dtype else torch.bfloat16  # else the config's
    assert served.model.embed.dtype == want
    assert served.engine.cache["k"].dtype == want
    assert served.engine.ticks == 4 + 2 * 1 + 4 - 1  # longest prompt + 4


def test_example_serve_lm_runs(capsys):
    spec = importlib.util.spec_from_file_location("serve_lm_example", EXAMPLE)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.main(device="cpu")
    assert "all requests served" in capsys.readouterr().out


def test_mesh_and_missing_cuda_refused(monkeypatch):
    cfg = t_configs.get("tinyllama-1.1b").reduced()
    for build in (t_serve.build_decode_step, t_serve.build_prefill):
        with pytest.raises(TypeError, match="SlotMesh"):
            build(cfg, mesh=object())
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_model.init_params(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        launch_serve.main(["--arch", "tinyllama-1.1b", "--reduced"])


def test_build_steps_match_the_model_functions():
    _, tcfg, _, model = _case("tinyllama-1.1b", repro_init=True)
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, tcfg.vocab, (2, 8)))
    want = t_model.prefill(tcfg, model, toks, 8)
    torch.testing.assert_close(t_serve.build_prefill(tcfg)(model, toks),
                               want, rtol=0, atol=0)
    cache = t_model.init_cache(tcfg, 2, 16, device="cpu")
    step = t_serve.build_decode_step(tcfg)
    for t in range(8):
        lg, cache = step(model, cache, toks[:, t:t + 1], t)
    torch.testing.assert_close(lg, want, **dict(atol=1e-4, rtol=1e-4))
