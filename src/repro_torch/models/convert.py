"""Between repro's parameter tree and the port's :class:`~model.Lm`.

repro keeps its parameters as nested dicts whose leaves under ``layers``
are stacked per layer (llama4: ``dense`` on (superblock, sub-layer),
``moe_sub`` on superblock), with the hybrid's ``shared_attn`` as one
block; the port holds one module per layer, and names a parameter by its
path (``layers.3.attn.wq``).  :func:`jax_tree_from` stacks the port's
tensors into repro's tree, :func:`flat_from_jax` unstacks it again; the
checkpoint format (``train/checkpoint``), the sharding rules
(``train/sharding``) and the tests all speak repro's tree.

Trees come as numpy arrays, as ``jax.tree.map(np.asarray, params)`` gives
them.  bf16 leaves arrive as ``ml_dtypes.bfloat16`` arrays (dtype name
``"bfloat16"``, two bytes); they are read through their bits, so this
module needs neither JAX nor ``ml_dtypes``.  Going the other way,
:func:`to_numpy` widens bf16 to f32, as repro's checkpoints store it.
"""
from __future__ import annotations

from typing import Callable, Mapping

import numpy as np
import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.models import model as M

OPT_KEYS = ("mu", "nu", "step")


def to_tensor(a) -> torch.Tensor:
    """A numpy array (bf16 included) as a CPU tensor of the same dtype."""
    a = np.array(a, order="C")  # a writable copy: jax's arrays are not
    if a.dtype.name == "bfloat16" and a.dtype.itemsize == 2:
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """A tensor as a host numpy array; bf16 widened to f32 (numpy has no
    bf16: repro's checkpoints widen it the same way)."""
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.cpu().numpy()


def named_params(params) -> dict:
    """``{name: tensor}`` of an :class:`~model.Lm` (its parameter names)
    or of a mapping keyed by those names (gradients, moments)."""
    if isinstance(params, nn.Module):
        return dict(params.named_parameters())
    return dict(params)


def _flatten(tree: dict, prefix: str = "") -> dict:
    out = {}
    for key, val in tree.items():
        name = f"{prefix}{key}"
        if isinstance(val, dict):
            out.update(_flatten(val, name + "."))
        else:
            out[name] = val
    return out


def _nest(flat: dict) -> dict:
    tree: dict = {}
    for name, val in flat.items():
        *path, leaf = name.split(".")
        node = tree
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = val
    return tree


def _superblocks(cfg: ArchConfig) -> bool:
    return (cfg.family in M.DENSE_FAMILIES and cfg.moe is not None
            and cfg.moe_every > 1)


def jax_plan(cfg: ArchConfig, params) -> dict:
    """repro's tree of the port's ``params`` (an :class:`~model.Lm`, or
    ``{name: tensor}`` of gradients or moments) before stacking: each leaf
    the tensor itself, or the list of per-layer tensors it stacks (lists
    of lists under llama4's ``layers/dense``); :func:`stack_plan` stacks
    one."""
    named = named_params(params)
    layers: dict = {}
    top: dict = {}
    for name, t in named.items():
        head, _, rest = name.partition(".")
        if head == "layers":
            i, _, rest = rest.partition(".")
            layers.setdefault(int(i), {})[rest] = t
        else:
            top[name] = t
    subs = [layers[i] for i in range(len(layers))]
    tree = _nest(top)

    def group(subs: list) -> dict:
        return {k: [g[k] for g in subs] for k in subs[0]}

    if _superblocks(cfg):
        me = cfg.moe_every
        supers = [subs[i:i + me] for i in range(0, len(subs), me)]
        dense = [group(sb[:-1]) for sb in supers]
        tree["layers"] = {"dense": _nest({k: [d[k] for d in dense]
                                          for k in dense[0]}),
                          "moe_sub": _nest(group([sb[-1] for sb in supers]))}
    else:
        tree["layers"] = _nest(group(subs))
    return tree


def stack_plan(entry) -> torch.Tensor:
    """One leaf of :func:`jax_plan`, stacked on its tensors' device."""
    if isinstance(entry, list):
        return torch.stack([stack_plan(e) for e in entry])
    return entry


def jax_tree_from(cfg: ArchConfig, params,
                  leaf: Callable = to_numpy) -> dict:
    """repro's tree of the port's ``params`` (an :class:`~model.Lm`, or
    ``{name: tensor}`` of gradients or moments): per-layer leaves stacked
    with ``torch.stack`` on their device, then each leaf passed through
    ``leaf`` (by default :func:`to_numpy`; ``lambda t: t`` keeps tensors)."""
    return map_leaves(jax_plan(cfg, params), lambda e: leaf(stack_plan(e)))


def map_leaves(tree: dict, fn: Callable) -> dict:
    """``tree`` (nested dicts) with ``fn`` applied to every leaf."""
    return {k: map_leaves(v, fn) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


def flat_from_jax(cfg: ArchConfig, tree: dict) -> dict:
    """``{port name: leaf}`` of repro's tree: each per-layer leaf indexed
    out of its stack (a view for tensors and numpy arrays alike)."""
    extra = set(tree) - {"embed", "final_norm", "layers", "shared_attn"}
    if extra:
        raise ValueError(f"repro's tree has leaves the port lacks: {extra}")
    out = {"embed": tree["embed"], "final_norm": tree["final_norm"]}
    stacked = tree["layers"]
    if _superblocks(cfg):
        me = cfg.moe_every
        dense, moe = _flatten(stacked["dense"]), _flatten(stacked["moe_sub"])
        for i in range(cfg.n_layers):
            s, j = divmod(i, me)
            src, idx = (dense, (s, j)) if j < me - 1 else (moe, s)
            out.update((f"layers.{i}.{k}", v[idx]) for k, v in src.items())
    else:
        for k, v in _flatten(stacked).items():
            out.update((f"layers.{i}.{k}", v[i])
                       for i in range(cfg.n_layers))
    if "shared_attn" in tree:
        out.update((f"shared_attn.{k}", v)
                   for k, v in _flatten(tree["shared_attn"]).items())
    return out


@torch.no_grad()
def load_flat(targets: Mapping[str, torch.Tensor], flat: Mapping,
              what: str = "model", cast: bool = False) -> None:
    """Copy ``flat`` (``{name: array or tensor}``) into ``targets`` (the
    port's tensors of the same names).  Every name must be covered and
    every shape equal; dtypes too unless ``cast``."""
    if set(flat) != set(targets):
        raise ValueError(f"{what}: repro's leaves {sorted(flat)} are not the "
                         f"port's {sorted(targets)}")
    for name, arr in flat.items():
        p = targets[name]
        t = arr if isinstance(arr, torch.Tensor) else to_tensor(arr)
        if t.shape != p.shape or (t.dtype != p.dtype and not cast):
            raise ValueError(f"{what}.{name}: {tuple(t.shape)} {t.dtype} "
                             f"where the port has {tuple(p.shape)} "
                             f"{p.dtype}")
        p.copy_(t)


def params_from_jax(cfg: ArchConfig, tree: dict, device="cpu") -> M.Lm:
    """An :class:`~model.Lm` on ``device`` holding repro's parameters
    ``tree`` (numpy leaves).  Every leaf must land on a parameter of the
    same shape and dtype, and every parameter must be covered."""
    model = M.Lm(cfg, device)
    load_flat(named_params(model), flat_from_jax(cfg, tree))
    return model


def jax_shapes(cfg: ArchConfig) -> dict:
    """repro's tree of ``cfg``'s parameters as stacked meta tensors (shape
    and dtype, no storage): what ``jax.eval_shape(init_params)`` gives."""
    return jax_tree_from(cfg, M.Lm(cfg, device="meta"), leaf=lambda t: t)


def opt_state_to_jax(cfg: ArchConfig, opt_state: dict,
                     leaf: Callable = to_numpy) -> dict:
    """repro's ``{"mu", "nu", "step"}`` of the port's optimizer state
    (moments keyed by parameter name)."""
    return {"mu": jax_tree_from(cfg, opt_state["mu"], leaf),
            "nu": jax_tree_from(cfg, opt_state["nu"], leaf),
            "step": leaf(opt_state["step"])}


def opt_state_from_jax(cfg: ArchConfig, tree: dict, device="cpu",
                       dtype: torch.dtype | None = None) -> dict:
    """The port's optimizer state on ``device`` from repro's ``{"mu",
    "nu", "step"}`` tree (numpy leaves), moments in ``dtype`` (their own
    dtype when None)."""
    def moments(t):
        return {k: to_tensor(v).to(device=device, dtype=dtype)
                for k, v in flat_from_jax(cfg, t).items()}

    return {"mu": moments(tree["mu"]), "nu": moments(tree["nu"]),
            "step": to_tensor(tree["step"]).to(device=device,
                                               dtype=torch.int32)}
