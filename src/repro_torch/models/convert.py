"""Load repro's parameter tree into the port's :class:`~model.Lm` (port
only: the tests hold the port against repro on the same weights).

The tree comes as numpy arrays, as ``jax.tree.map(np.asarray, params)``
gives it: nested dicts whose leaves under ``layers`` are stacked per
layer.  bf16 leaves arrive as ``ml_dtypes.bfloat16`` arrays (dtype name
``"bfloat16"``, two bytes); they are read through their bits, so this
module needs neither JAX nor ``ml_dtypes``.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.models import model as M


def to_tensor(a) -> torch.Tensor:
    """A numpy array (bf16 included) as a CPU tensor of the same dtype."""
    a = np.array(a, order="C")  # a writable copy: jax's arrays are not
    if a.dtype.name == "bfloat16" and a.dtype.itemsize == 2:
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _flatten(tree: dict, prefix: str = "") -> dict:
    out = {}
    for key, val in tree.items():
        name = f"{prefix}{key}"
        if isinstance(val, dict):
            out.update(_flatten(val, name + "."))
        else:
            out[name] = val
    return out


def _index(tree: dict, idx) -> dict:
    """Layer ``idx`` of a tree whose leaves are stacked on their leading
    axes (``idx`` an int or a tuple of ints)."""
    return {k: _index(v, idx) if isinstance(v, dict) else np.asarray(v)[idx]
            for k, v in tree.items()}


@torch.no_grad()
def _copy(p: torch.Tensor, arr, what: str) -> None:
    t = to_tensor(arr)
    if t.shape != p.shape or t.dtype != p.dtype:
        raise ValueError(f"{what}: {tuple(t.shape)} {t.dtype} where the port "
                         f"has {tuple(p.shape)} {p.dtype}")
    p.copy_(t)


def load_into(module: nn.Module, tree: dict, what: str = "module") -> None:
    """Copy repro's subtree ``tree`` (one layer's, unstacked) into
    ``module``, whose parameter names are its paths."""
    flat = _flatten(tree)
    params = dict(module.named_parameters())
    if set(flat) != set(params):
        raise ValueError(f"{what}: repro's leaves {sorted(flat)} are not the "
                         f"port's parameters {sorted(params)}")
    for name, arr in flat.items():
        _copy(params[name], arr, f"{what}.{name}")


def params_from_jax(cfg: ArchConfig, tree: dict, device="cpu") -> M.Lm:
    """An :class:`~model.Lm` on ``device`` holding repro's parameters
    ``tree`` (numpy leaves).  Every leaf must land on a parameter of the
    same shape and dtype, and every parameter must be covered."""
    extra = set(tree) - {"embed", "final_norm", "layers", "shared_attn"}
    if extra:
        raise ValueError(f"repro's tree has leaves the port lacks: {extra}")
    model = M.Lm(cfg, device)
    _copy(model.embed, tree["embed"], "embed")
    _copy(model.final_norm, tree["final_norm"], "final_norm")
    stacked = tree["layers"]
    if cfg.family in M.DENSE_FAMILIES and cfg.moe is not None \
            and cfg.moe_every > 1:
        me = cfg.moe_every
        for i, sub in enumerate(model.layers):
            s, j = divmod(i, me)
            part = (_index(stacked["dense"], (s, j)) if j < me - 1
                    else _index(stacked["moe_sub"], s))
            load_into(sub, part, f"layers[{i}]")
    else:
        for i, sub in enumerate(model.layers):
            load_into(sub, _index(stacked, i), f"layers[{i}]")
    if cfg.family == "hybrid":
        load_into(model.shared_attn, tree["shared_attn"], "shared_attn")
    return model
