"""The port's LM models against repro's on the CPU.

The configs field for field (all eleven names, their ``reduced()``, the
parameter counts, ``SHAPES`` and ``shape_applicable``); ``layers``,
``moe`` and ``mamba2`` alone on repro's weights; and for every assigned
architecture's ``reduced()``, loaded from repro's parameter tree through
``convert.params_from_jax``: ``forward``, ``loss_fn``, ``prefill``,
``init_cache`` and teacher-forced ``decode_step`` in f32 (atol 1e-4, rtol
1e-4, greedy tokens equal) and in bf16 (atol 0.12, rtol 0.05, repro's own
bf16 tolerance for decode against forward), a float8_e4m3fn KV cache, the
fp8 cast's NaN past the format's range, and ``decode_step`` with a (B,)
``cache_len`` equal to the scalar path where every row is at the same
cursor.
"""
from __future__ import annotations

import dataclasses

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
from repro.models import layers as r_layers  # noqa: E402
from repro.models import mamba2 as r_mamba2  # noqa: E402
from repro.models import model as r_model  # noqa: E402
from repro.models import moe as r_moe  # noqa: E402
import repro_torch.configs as t_configs  # noqa: E402
from repro_torch.configs import base as t_base  # noqa: E402
from repro_torch.configs import blest_bfs as t_blest_bfs  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.models import layers as t_layers  # noqa: E402
from repro_torch.models import mamba2 as t_mamba2  # noqa: E402
from repro_torch.models import model as t_model  # noqa: E402
from repro_torch.models import moe as t_moe  # noqa: E402

F32 = dict(atol=1e-4, rtol=1e-4)
BF16 = dict(atol=0.12, rtol=0.05)
TOL = {"float32": F32, "bfloat16": BF16}
B, L, MAX_SEQ, STEPS = 2, 16, 32, 8


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _close(got, want, tol, what=""):
    np.testing.assert_allclose(_np(got), _np(want), err_msg=what, **tol)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


# --------------------------------------------------------------- configs ---
def test_registry_names_and_assigned():
    assert t_configs.names() == r_configs.names()
    assert t_configs.ASSIGNED == r_configs.ASSIGNED
    for k in ("N_VERTICES", "NUM_VSS", "KAPPA", "SIGMA", "TAU"):
        assert getattr(t_blest_bfs, k) == getattr(r_blest_bfs, k)


def _outcome(fn):
    """fn()'s value, or the type of what it raised (blest-bfs has no
    heads: its ``hd`` divides by zero in both packages)."""
    try:
        return fn()
    except ArithmeticError as e:
        return type(e)


def test_registry_loads_every_config_after_one_import(monkeypatch):
    """With only blest_bfs registered (its module imported first), repro's
    ``get`` of another name raises: its loader returns early on a non-empty
    registry.  The port's loads every module all the same."""
    monkeypatch.setattr(r_configs, "_REGISTRY",
                        {"blest-bfs": r_blest_bfs.CONFIG})
    monkeypatch.setattr(t_configs, "_REGISTRY",
                        {"blest-bfs": t_blest_bfs.CONFIG})
    with pytest.raises(KeyError):
        r_configs.get("tinyllama-1.1b")
    assert t_configs.get("tinyllama-1.1b").d_model == 2048
    assert len(t_configs.names()) == 11


@pytest.mark.parametrize("name", r_configs.names())
def test_config_field_for_field(name):
    r, t = r_configs.get(name), t_configs.get(name)
    for rc, tc in ((r, t), (r.reduced(), t.reduced())):
        assert dataclasses.asdict(tc) == dataclasses.asdict(rc)
        for attr in ("hd", "sub_quadratic", "is_attention_free"):
            assert _outcome(lambda: getattr(tc, attr)) == \
                _outcome(lambda: getattr(rc, attr)), attr
        for fn in ("param_count", "active_param_count"):
            assert _outcome(getattr(tc, fn)) == _outcome(getattr(rc, fn)), fn


def test_shapes_and_applicability():
    assert {k: dataclasses.asdict(v) for k, v in t_base.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in r_configs.SHAPES.items()}
    for name in r_configs.names():
        for shape in r_configs.SHAPES:
            assert t_base.shape_applicable(
                t_configs.get(name), t_base.SHAPES[shape]) == \
                r_configs.shape_applicable(r_configs.get(name),
                                           r_configs.SHAPES[shape])


# ---------------------------------------------------------------- layers ---
def test_rms_norm_and_rope():
    rng = np.random.default_rng(0)
    for dt in ("float32", "bfloat16"):
        x = rng.standard_normal((2, 5, 3, 16)).astype(np.float32)
        scale = rng.standard_normal(16).astype(np.float32)
        pos = rng.integers(0, 100, (2, 5)).astype(np.int32)
        xj, xt = jnp.asarray(x, dt), _t(x).to(t_layers.dtype_of(dt))
        _close(t_layers.rms_norm(xt, _t(scale)),
               r_layers.rms_norm(xj, jnp.asarray(scale)), TOL[dt], dt)
        _close(t_layers.apply_rope(xt, _t(pos), 500.0),
               r_layers.apply_rope(xj, jnp.asarray(pos), 500.0), TOL[dt], dt)


@pytest.mark.parametrize("lq,lk,h,kh,block_k,causal,q_offset,valid", [
    (9, 9, 4, 2, 4, True, 0, None),      # padded last block, GQA
    (1, 12, 4, 1, 5, False, 7, 8),       # decode: kv_valid_len mask
    (3, 10, 2, 2, 16, False, 0, 0),      # every row fully masked
    (6, 6, 4, 4, 2, True, 0, None),      # MHA, several blocks
])
def test_blockwise_attention(lq, lk, h, kh, block_k, causal, q_offset,
                             valid):
    rng = np.random.default_rng(lq * lk + h)
    q = rng.standard_normal((2, lq, h, 8)).astype(np.float32)
    k = rng.standard_normal((2, lk, kh, 8)).astype(np.float32)
    v = rng.standard_normal((2, lk, kh, 8)).astype(np.float32)
    want = jax.jit(lambda q, k, v: r_layers.blockwise_attention(
        q, k, v, causal=causal, q_offset=q_offset, kv_valid_len=valid,
        block_k=block_k))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    got = t_layers.blockwise_attention(
        _t(q), _t(k), _t(v), causal=causal, q_offset=q_offset,
        kv_valid_len=valid, block_k=block_k)
    _close(got, want, F32)
    if valid is not None:  # per-row offsets equal to the scalar
        per_row = t_layers.blockwise_attention(
            _t(q), _t(k), _t(v), causal=causal,
            q_offset=torch.full((2,), q_offset),
            kv_valid_len=torch.full((2,), valid), block_k=block_k)
        torch.testing.assert_close(per_row, got, rtol=0, atol=0)


def test_cross_entropy_with_and_without_mask():
    rng = np.random.default_rng(1)
    logits = rng.standard_normal((2, 7, 11)).astype(np.float32)
    tgt = rng.integers(0, 11, (2, 7)).astype(np.int32)
    mask = (rng.random((2, 7)) > 0.4).astype(np.float32)
    for m in (None, mask):
        want = r_layers.cross_entropy(jnp.asarray(logits), jnp.asarray(tgt),
                                      None if m is None else jnp.asarray(m))
        got = t_layers.cross_entropy(_t(logits), _t(tgt),
                                     None if m is None else _t(m))
        _close(got, want, F32)


def test_fp8_cache_cast_gives_repros_nan():
    """torch saturates to +-448 where JAX gives NaN; the port's cast
    follows JAX (464, the midpoint to 480, rounds to even: 448)."""
    vec = np.array([1000, -1000, 449, 464, 300.1, 470, -465, np.inf],
                   np.float32)
    for dt in ("float32", "bfloat16"):  # bf16 holds -465 as -464
        want = np.asarray(jnp.asarray(vec, dt).astype(jnp.float8_e4m3fn)
                          .astype(jnp.float32))
        got = t_layers.to_cache(_t(vec).to(t_layers.dtype_of(dt)),
                                torch.float8_e4m3fn)
        np.testing.assert_array_equal(got.float().numpy(), want, dt)
        assert np.isnan(want[[0, 1, 5, 7]]).all()
        assert (want[[2, 3]] == 448).all()


# ------------------------------------------------------------------- moe ---
@pytest.mark.parametrize("tokens_b,group_size,shared,dispatch", [
    ((2, 16), 8, 1, "float32"),     # 4 groups of 8, shared experts
    ((3, 5), 8, 0, "float32"),      # 15 tokens: falls back to one group
    ((2, 8), 16, 2, "bfloat16"),    # bf16 dispatch
])
def test_moe_layer(tokens_b, group_size, shared, dispatch):
    cfg_kw = dict(d_model=32, num_experts=4, top_k=2, expert_d_ff=16,
                  shared_experts=shared, group_size=group_size,
                  capacity_factor=1.0, dispatch_dtype=dispatch)
    rcfg, tcfg = r_moe.MoeConfig(**cfg_kw), t_moe.MoeConfig(**cfg_kw)
    mod = t_moe.Moe(tcfg, torch.float32)
    mod.init_(torch.Generator().manual_seed(3))
    params = jax.tree.map(jnp.asarray, _nested(mod))
    x = np.random.default_rng(2).standard_normal(
        (*tokens_b, 32)).astype(np.float32)
    want_y, want_aux = jax.jit(lambda p, x: r_moe.moe_layer(p, x, rcfg))(
        params, jnp.asarray(x))
    got_y, got_aux = t_moe.moe_layer(mod, _t(x), tcfg)
    tol = F32 if dispatch == "float32" else BF16
    _close(got_y, want_y, tol)
    _close(got_aux, want_aux, F32)


# ---------------------------------------------------------------- mamba2 ---
def test_mamba2_block_and_decode():
    kw = dict(d_model=32, d_state=8, head_dim=8, expand=2, conv_width=4,
              chunk=4)
    rcfg, tcfg = r_mamba2.Mamba2Config(**kw), t_mamba2.Mamba2Config(**kw)
    mod = t_mamba2.Mamba2(tcfg, torch.float32)
    mod.init_(torch.Generator().manual_seed(4))
    params = jax.tree.map(jnp.asarray, _nested(mod))
    x = np.random.default_rng(5).standard_normal((2, 12, 32)) \
        .astype(np.float32)
    want_y, want_s = jax.jit(lambda p, x: r_mamba2.mamba2_block(
        p, x, rcfg))(params, jnp.asarray(x))
    got_y, got_s = t_mamba2.mamba2_block(mod, _t(x), tcfg)
    _close(got_y, want_y, F32)
    _close(got_s, want_s, F32)
    rc = r_mamba2.init_mamba2_cache(2, rcfg)
    tc = t_mamba2.init_mamba2_cache(2, tcfg)
    step = jax.jit(lambda p, x, c: r_mamba2.mamba2_decode_step(p, x, c, rcfg))
    for t in range(5):
        wy, rc = step(params, jnp.asarray(x[:, t:t + 1]), rc)
        gy, tc = t_mamba2.mamba2_decode_step(mod, _t(x[:, t:t + 1]), tc, tcfg)
        _close(gy, wy, F32, f"step {t}")
        _close(tc["ssm"], rc["ssm"], F32)
        _close(tc["conv"], rc["conv"], F32)
    with pytest.raises(AssertionError):
        t_mamba2.mamba2_block(mod, _t(x[:, :10]), tcfg)  # 10 % chunk != 0


# ----------------------------------------------------------------- model ---
def _numpy(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(jnp.bfloat16)
    return t.numpy()


def _nested(module) -> dict:
    tree: dict = {}
    for name, p in module.named_parameters():
        *path, leaf = name.split(".")
        node = tree
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = _numpy(p.detach())
    return tree


def repro_tree(cfg, model) -> dict:
    """The port's weights as repro's tree (``convert.jax_tree_from``), bf16
    leaves kept as ``jnp.bfloat16``."""
    return convert.jax_tree_from(cfg, model, leaf=lambda t: _numpy(t.detach()))


_BUILT: dict = {}


def _case(name: str, dtype: str, kv_dtype: str | None = None):
    """repro's config and params and the port's model on the same weights
    (drawn by the port's ``init_params``, loaded back through
    ``params_from_jax``), built once per key."""
    key = (name, dtype, kv_dtype or dtype)
    if key not in _BUILT:
        kw = dict(dtype=dtype, kv_cache_dtype=kv_dtype or dtype)
        rcfg = dataclasses.replace(r_configs.get(name).reduced(), **kw)
        tcfg = dataclasses.replace(t_configs.get(name).reduced(), **kw)
        tree = repro_tree(tcfg, t_model.init_params(tcfg, seed=0,
                                                     device="cpu"))
        want = jax.eval_shape(lambda k: r_model.init_params(rcfg, k),
                              jax.random.PRNGKey(0))
        assert jax.tree.map(lambda a: (a.shape, a.dtype.name), tree) == \
            jax.tree.map(lambda a: (a.shape, a.dtype.name), want)
        model = convert.params_from_jax(tcfg, tree)
        _BUILT[key] = (rcfg, tcfg, jax.tree.map(jnp.asarray, tree), model)
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


def _inputs(cfg, seed=0) -> dict:
    """A batch: tokens / embeds per modality, targets."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (B, L)).astype(np.int32)
    batch = {"tokens": toks, "targets": toks}
    if cfg.modality == "embeds":
        batch = {"embeds": rng.standard_normal((B, L, cfg.d_model))
                 .astype(np.float32), "targets": toks}
    elif cfg.modality == "prefix":
        txt = toks[:, :L - cfg.prefix_len]
        batch = {"tokens": txt, "targets": txt,
                 "embeds": rng.standard_normal((B, cfg.prefix_len,
                                                cfg.d_model))
                 .astype(np.float32)}
    return batch, toks


def _repro_run(cfg, params, batch, toks, steps, everything=True):
    """repro's forward, loss_fn, prefill and ``steps`` teacher-forced
    decode steps from position 0, in one jit (one compile)."""
    def run(p, batch, toks):
        out = {"forward": r_model.forward(cfg, p, batch.get("tokens"),
                                          batch.get("embeds"))}
        if everything:
            out["loss"] = r_model.loss_fn(cfg, p, batch)
            if cfg.modality == "text":
                out["prefill"] = r_model.prefill(cfg, p, toks, MAX_SEQ)

        def body(c, t):
            lg, c = r_model.decode_step(
                cfg, p, c, jax.lax.dynamic_slice_in_dim(toks, t, 1, 1), t)
            return c, lg
        out["cache"], out["decode"] = jax.lax.scan(
            body, r_model.init_cache(cfg, B, MAX_SEQ),
            jnp.arange(steps, dtype=jnp.int32))
        return out
    return jax.jit(run)(params, {k: jnp.asarray(v) for k, v in batch.items()},
                        jnp.asarray(toks))


def _port_decode(cfg, model, toks, steps):
    cache = t_model.init_cache(cfg, B, MAX_SEQ, device="cpu")
    outs = []
    with torch.no_grad():
        for t in range(steps):
            lg, cache = t_model.decode_step(cfg, model, cache,
                                            _t(toks[:, t:t + 1]), t)
            outs.append(lg)
    return outs, cache


@pytest.mark.parametrize("name", r_configs.ASSIGNED)
def test_model_f32_equals_repro(name):
    rcfg, tcfg, params, model = _case(name, "float32")
    batch, toks = _inputs(rcfg)
    want = _repro_run(rcfg, params, batch, toks, STEPS)
    tb = {k: _t(v) for k, v in batch.items()}
    with torch.no_grad():
        got, got_aux = t_model.forward(tcfg, model, tb.get("tokens"),
                                       tb.get("embeds"))
        got_loss, got_m = t_model.loss_fn(tcfg, model, tb)
    _close(got, want["forward"][0], F32, "forward")
    _close(got_aux, want["forward"][1], F32, "aux")
    assert (_np(got).argmax(-1) == _np(want["forward"][0]).argmax(-1)).all()
    _close(got_loss, want["loss"][0], F32, "loss")
    _close(got_m["ce"], want["loss"][1]["ce"], F32, "ce")
    if rcfg.modality == "text":
        with torch.no_grad():
            got_p = t_model.prefill(tcfg, model, _t(toks), MAX_SEQ)
        _close(got_p, want["prefill"], F32, "prefill")

    outs, cache = _port_decode(tcfg, model, toks, STEPS)
    for t, got_d in enumerate(outs):
        want_d = want["decode"][t]
        _close(got_d, want_d, F32, f"decode step {t}")
        assert (_np(got_d).argmax(-1) == _np(want_d).argmax(-1)).all()
    assert sorted(cache) == sorted(want["cache"])
    for key, want_c in want["cache"].items():
        assert tuple(cache[key].shape) == want_c.shape
        assert str(cache[key].dtype).split(".")[-1] == want_c.dtype.name
        _close(cache[key], want_c, F32, f"cache {key}")


@pytest.mark.parametrize("name", r_configs.ASSIGNED)
def test_model_bf16_close_to_repro(name):
    rcfg, tcfg, params, model = _case(name, "bfloat16")
    batch, toks = _inputs(rcfg, seed=1)
    want = _repro_run(rcfg, params, batch, toks, 4, everything=False)
    tb = {k: _t(v) for k, v in batch.items()}
    with torch.no_grad():
        got, _ = t_model.forward(tcfg, model, tb.get("tokens"),
                                 tb.get("embeds"))
    _close(got, want["forward"][0], BF16, "forward")
    outs, _ = _port_decode(tcfg, model, toks, 4)
    for t, got_d in enumerate(outs):
        _close(got_d, want["decode"][t], BF16, f"decode step {t}")


def test_model_fp8_kv_cache():
    rcfg, tcfg, params, model = _case("tinyllama-1.1b", "float32",
                                      "float8_e4m3fn")
    batch, toks = _inputs(rcfg, seed=2)
    want = _repro_run(rcfg, params, batch, toks, STEPS, everything=False)
    outs, cache = _port_decode(tcfg, model, toks, STEPS)
    assert cache["k"].dtype == torch.float8_e4m3fn
    for t, got_d in enumerate(outs):
        _close(got_d, want["decode"][t], F32, f"decode step {t}")
    for key in ("k", "v"):
        np.testing.assert_array_equal(
            cache[key].float().numpy(),
            np.asarray(want["cache"][key].astype(jnp.float32)))


@pytest.mark.parametrize("name", ["tinyllama-1.1b", "zamba2-7b",
                                  "qwen2-moe-a2.7b"])
def test_decode_per_row_cache_len_equals_scalar(name):
    """A (B,) cache_len with every row at the same cursor is the scalar
    path, bit for bit, step after step."""
    _, tcfg, _, model = _case(name, "float32")
    _, toks = _inputs(tcfg, seed=3)
    scalar = t_model.init_cache(tcfg, B, MAX_SEQ, device="cpu")
    vector = t_model.init_cache(tcfg, B, MAX_SEQ, device="cpu")
    with torch.no_grad():
        for t in range(5):
            tt = _t(toks[:, t:t + 1])
            want, scalar = t_model.decode_step(tcfg, model, scalar, tt, t)
            got, vector = t_model.decode_step(
                tcfg, model, vector, tt, torch.full((B,), t))
            torch.testing.assert_close(got, want, rtol=0, atol=0)
    for key in scalar:
        torch.testing.assert_close(vector[key], scalar[key], rtol=0, atol=0)


def test_decode_per_row_rows_are_independent():
    """Rows at different cursors: each row's logits are its own run's at
    its own position (a batch of one, scalar cache_len)."""
    _, tcfg, _, model = _case("zamba2-7b", "float32")
    _, toks = _inputs(tcfg, seed=4)
    lag = 3  # row 1 starts 3 steps after row 0
    both = t_model.init_cache(tcfg, B, MAX_SEQ, device="cpu")
    solo = [t_model.init_cache(tcfg, 1, MAX_SEQ, device="cpu")
            for _ in range(B)]
    with torch.no_grad():
        for t in range(8):
            cur = torch.tensor([t, max(t - lag, 0)])
            tt = _t(np.stack([toks[0, t], toks[1, cur[1]]])[:, None])
            if t < lag:  # row 1 idles at position 0, as an empty slot does
                got, both = t_model.decode_step(tcfg, model, both, tt, cur)
                for key in ("ssm", "conv"):
                    both[key][:, 1].zero_()
                want0, solo[0] = t_model.decode_step(
                    tcfg, model, solo[0], tt[:1], t)
                torch.testing.assert_close(got[:1], want0, **F32)
                continue
            got, both = t_model.decode_step(tcfg, model, both, tt, cur)
            for row in range(B):
                want, solo[row] = t_model.decode_step(
                    tcfg, model, solo[row], tt[row:row + 1], int(cur[row]))
                torch.testing.assert_close(got[row:row + 1], want, **F32)


@pytest.mark.parametrize("part", ["attention", "mlp", "moe", "mamba2",
                                  "embed"])
def test_init_follows_repros_distributions(part):
    """The port draws each weight as repro does: N(0, 1) times repro's
    scale (std and mean within five standard errors), and the deterministic
    leaves (norms, A_log, D, dt_bias) equal."""
    gen = torch.Generator().manual_seed(0)
    key = jax.random.PRNGKey(0)
    if part == "attention":
        kw = dict(d_model=256, n_heads=4, n_kv=2, head_dim=64, qk_norm=True)
        mod = t_layers.Attention(t_layers.AttentionConfig(**kw),
                                 torch.float32)
        want = r_layers.init_attention(key, r_layers.AttentionConfig(**kw),
                                       jnp.float32)
    elif part == "mlp":
        mod = t_layers.Mlp(256, 512, torch.float32)
        want = r_layers.init_mlp(key, 256, 512, jnp.float32)
    elif part == "moe":
        kw = dict(d_model=128, num_experts=4, top_k=2, expert_d_ff=64,
                  shared_experts=2)
        mod = t_moe.Moe(t_moe.MoeConfig(**kw), torch.float32)
        want = r_moe.init_moe(key, r_moe.MoeConfig(**kw), jnp.float32)
    elif part == "mamba2":
        kw = dict(d_model=128, d_state=16, head_dim=16)
        mod = t_mamba2.Mamba2(t_mamba2.Mamba2Config(**kw), torch.float32)
        want = r_mamba2.init_mamba2(key, r_mamba2.Mamba2Config(**kw),
                                    jnp.float32)
    else:
        cfg = dataclasses.replace(t_configs.get("tinyllama-1.1b").reduced(),
                                  vocab=512, dtype="float32")
        mod = t_model.init_params(cfg, seed=0, device="cpu")
        got = {"embed": mod.embed}
        want = {"embed": r_layers.init_embedding(key, 512, 64, jnp.float32)}
    if part != "embed":
        mod.init_(gen)
        got = dict(mod.named_parameters())
        want = convert._flatten(jax.tree.map(np.asarray, want))
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        g = got[name].detach().numpy()
        w = np.asarray(w)
        assert g.shape == w.shape and g.dtype == w.dtype, name
        if w.std() == 0 or name in ("A_log",):
            np.testing.assert_allclose(g, w, rtol=1e-6, err_msg=name)
        else:  # five standard errors of the estimates over w.size values
            tol = 5 / np.sqrt(w.size)
            assert abs(g.std() / w.std() - 1) < tol, name
            assert abs(g.mean()) < tol * w.std(), name
