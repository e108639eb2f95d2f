"""Sharding rules and their placement on a slot mesh: the counterpart of
``repro.train.sharding``.

The rules are repro's, on repro's tree: specs are computed on repro's
*stacked* leaf shapes (``convert.jax_shapes``) and keyed by repro's
paths, so :func:`fix_specs` may move a dropped axis onto the layer-stack
dim exactly as repro does.  :class:`P` stands in for
``jax.sharding.PartitionSpec`` (one entry a dim: None, an axis name or a
tuple of axis names).

Conventions (DESIGN.md §5):
  * 'model' (tensor / expert parallel): attention heads, FFN hidden,
    experts, vocab.
  * fsdp axes ('data', + 'pod' when multi-pod): the other matrix dimension
    of every large weight (ZeRO-3-style), and the batch dimension of
    activations.
  * Optimizer moments follow their parameter's spec.

Placement stands in for ``to_shardings``: :func:`shard` cuts a leaf into
one piece a slot (a dim sharded over axes of k slots in k chunks of
ceil(n / k), in slot order; slots that differ only along other axes hold
copies), :func:`gather` concatenates the pieces back in slot order, and
:class:`Sharded` keeps a flat tree placed that way.
"""
from __future__ import annotations

import math
from typing import Callable

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.models import convert
from repro_torch.models import model as M


class P(tuple):
    """A PartitionSpec: ``P(None, "model")``, ``P(("pod", "data"),
    None)``."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return "P" + tuple.__repr__(tuple(self))


def fsdp_axes(mesh):
    axes = tuple(a for a in ("pod", "data") if a in mesh.axis_names)
    return axes if axes else None


# base (unstacked) rank of each named parameter; extra leading dims are
# stack axes (1 for plain layers, 2 for llama4 superblock dense sub-layers)
_BASE_NDIM = {
    "embed": 2, "wq": 2, "wk": 2, "wv": 2, "wo": 2,
    "w_gate": 2, "w_up": 2, "w_down": 2, "in_proj": 2, "out_proj": 2,
    "router": 2, "w_in": 3, "w_out": 3, "conv": 2,
}


def _spec_for(name: str, fsdp) -> P | None:
    if name == "embed":
        return P("model", fsdp)                    # (vocab, d)
    if name in ("wq", "wk", "wv", "w_gate", "w_up", "in_proj"):
        return P(fsdp, "model")                    # (d, hidden)
    if name in ("wo", "w_down", "out_proj"):
        return P("model", fsdp)                    # (hidden, d)
    if name == "router":
        return P(fsdp, None)                       # (d, E) small
    if name == "w_in":
        return P("model", fsdp, None)              # (E, d, 2f)
    if name == "w_out":
        return P("model", None, fsdp)              # (E, f, d)
    if name == "conv":
        return P(None, "model")                    # (w, channels)
    return None


def _shape(leaf) -> tuple:
    return tuple(leaf.shape) if hasattr(leaf, "shape") else tuple(leaf)


def _map_tree(fn: Callable, tree, path=()):
    if isinstance(tree, dict):
        return {k: _map_tree(fn, v, path + (k,)) for k, v in tree.items()}
    return fn(path, tree)


def flatten(tree: dict, prefix: str = "") -> dict:
    """``{"a/b/c": leaf}`` of a nested dict (repro's checkpoint keys)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flatten(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def unflatten(flat: dict) -> dict:
    tree: dict = {}
    for key, v in flat.items():
        *path, leaf = key.split("/")
        node = tree
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = v
    return tree


def stack_dims(path: str) -> int:
    """Leading stack dims of repro's leaf at ``path``: 2 under llama4's
    ``layers/dense``, 1 elsewhere under ``layers``, else 0."""
    if path.startswith("layers/dense/"):
        return 2
    return 1 if path.startswith("layers/") else 0


def param_specs(cfg: ArchConfig, params: dict, mesh) -> dict:
    """Specs of repro's parameter tree ``params`` (leaves with a shape,
    or shape tuples)."""
    fsdp = fsdp_axes(mesh)

    def assign(path, leaf):
        ndim = len(_shape(leaf))
        name = path[-1]
        base = _BASE_NDIM.get(name)
        spec = _spec_for(name, fsdp)
        if base is None or spec is None or ndim < base:
            return P(*([None] * ndim))  # norms, scalars, unknowns
        return P(*([None] * (ndim - base)), *spec)

    return _map_tree(assign, params)


def opt_state_specs(cfg: ArchConfig, opt_state, pspecs: dict, mesh) -> dict:
    return {"mu": pspecs, "nu": pspecs, "step": P()}


def _shards(mesh, fsdp) -> int:
    n = 1
    for a in fsdp or ():
        n *= mesh.shape[a]
    return n


def batch_specs(cfg: ArchConfig, shape: ShapeConfig, mesh) -> dict:
    """Input shardings per shape kind."""
    fsdp = fsdp_axes(mesh)
    n = _shards(mesh, fsdp)
    batch_axis = fsdp if shape.global_batch % max(n, 1) == 0 \
        and shape.global_batch >= n else None
    specs = {"tokens": P(batch_axis, None), "targets": P(batch_axis, None)}
    if cfg.modality in ("embeds", "prefix"):
        specs["embeds"] = P(batch_axis, None, None)
    return specs


def cache_specs(cfg: ArchConfig, shape: ShapeConfig, mesh) -> dict:
    """KV / state cache shardings for decode shapes.

    batch >= data-shards: shard batch over fsdp axes, heads over 'model'.
    batch < data-shards (long context): batch replicated, *sequence*
    sharded over the fsdp axes, heads over 'model'.
    """
    fsdp = fsdp_axes(mesh)
    seq_parallel = shape.global_batch < _shards(mesh, fsdp)
    b_ax = None if seq_parallel else fsdp
    s_ax = fsdp if seq_parallel else None
    if cfg.family in ("dense", "moe", "audio", "vlm"):
        kv_spec = P(None, b_ax, s_ax, "model", None)  # (L, B, S, kv, hd)
        return {"k": kv_spec, "v": kv_spec}
    specs = {
        "ssm": P(None, b_ax, "model", None, None),   # (L, B, h, p, n)
        "conv": P(None, b_ax, None, "model"),        # (L, B, w, ch)
    }
    if cfg.family == "hybrid":
        specs["k"] = P(None, b_ax, s_ax, "model", None)
        specs["v"] = P(None, b_ax, s_ax, "model", None)
    return specs


def _axes(ax) -> tuple:
    return tuple(ax) if isinstance(ax, (tuple, list)) else (ax,)


def _axes_size(mesh, ax) -> int:
    if ax is None:
        return 1
    return math.prod(mesh.shape[a] for a in _axes(ax))


def fix_specs(shapes, specs, mesh):
    """Divisibility repair: drop mesh axes from dims they don't divide,
    then try to re-place each dropped axis on another (larger, divisible)
    dim.  ``shapes`` / ``specs``: one leaf and its P, or trees of them."""

    def fix(shape_leaf, spec):
        dims = list(_shape(shape_leaf))
        parts = list(spec) + [None] * (len(dims) - len(spec))
        dropped = []
        for i, ax in enumerate(parts):
            if ax is None:
                continue
            if dims[i] % _axes_size(mesh, ax) != 0:
                dropped.append(ax)
                parts[i] = None
        for ax in dropped:
            size = _axes_size(mesh, ax)
            order = sorted(range(len(dims)), key=lambda i: -dims[i])
            placed = False
            for i in order:  # empty dims first
                if parts[i] is None and dims[i] % size == 0 \
                        and dims[i] >= size:
                    parts[i] = ax
                    placed = True
                    break
            if placed:
                continue
            for i in order:  # else combine with an occupied dim
                if parts[i] is None:
                    continue
                cur = parts[i] if isinstance(parts[i], tuple) else (parts[i],)
                new = cur + (ax if isinstance(ax, tuple) else (ax,))
                if dims[i] % _axes_size(mesh, new) == 0:
                    parts[i] = new
                    break
        return P(*parts)

    if isinstance(specs, P):
        return fix(shapes, specs)
    return {k: fix_specs(shapes[k], v, mesh) for k, v in specs.items()}


# ---------------------------------------------------------------- placement
def _chunk(coord, ax, mesh) -> tuple[int, int]:
    """(index, count) of the chunk the slot at ``coord`` holds of a dim
    sharded over ``ax``: the slot's coordinates along ``ax``, major to
    minor."""
    idx, n = 0, 1
    for a in _axes(ax):
        k = mesh.axis_names.index(a)
        idx = idx * mesh.sizes[k] + coord[k]
        n *= mesh.sizes[k]
    return idx, n


def piece(leaf: torch.Tensor, spec, mesh, coord) -> torch.Tensor:
    """The piece of ``leaf`` that ``spec`` gives the slot at ``coord``,
    as a view (a dim sharded over axes of k slots in chunks of
    ceil(n / k)); on a ``meta`` leaf, its shape alone."""
    t = leaf
    for dim, ax in enumerate(spec):
        if ax is None:
            continue
        i, n = _chunk(coord, ax, mesh)
        size = -(-t.shape[dim] // n)
        lo = min(i * size, t.shape[dim])
        t = t.narrow(dim, lo, min(size, t.shape[dim] - lo))
    return t


def shard(leaf: torch.Tensor, spec, mesh) -> np.ndarray:
    """``leaf`` cut by ``spec``: an object array of the mesh's shape whose
    entry at a coordinate is that slot's piece, a copy on its device."""
    pieces = np.empty(mesh.sizes, dtype=object)
    for coord in np.ndindex(*mesh.sizes):
        pieces[coord] = piece(leaf, spec, mesh, coord).to(
            mesh.devices[coord], copy=True,
            memory_format=torch.contiguous_format)
    return pieces


def gather(pieces: np.ndarray, spec, mesh, device) -> torch.Tensor:
    """The leaf that ``pieces`` (as :func:`shard` cut it) came from, on
    ``device``: the pieces concatenated in slot order along each sharded
    dim (slots at coordinate 0 along every other axis)."""
    dims = [(d, ax) for d, ax in enumerate(spec) if ax is not None]

    def build(level, coord):
        if level == len(dims):
            return pieces[tuple(coord)].to(device)
        d, ax = dims[level]
        parts = []
        for i in range(_axes_size(mesh, ax)):
            c, rem = list(coord), i
            for a in reversed(_axes(ax)):
                k = mesh.axis_names.index(a)
                c[k], rem = rem % mesh.sizes[k], rem // mesh.sizes[k]
            parts.append(build(level + 1, c))
        return torch.cat(parts, dim=d)

    return build(0, [0] * len(mesh.sizes))


class Sharded:
    """A flat tree (``{repro path: leaf}``) placed on a slot mesh by its
    specs: ``pieces[key][coord]`` lies on ``mesh.devices[coord]``."""

    def __init__(self, mesh, specs: dict, pieces: dict):
        self.mesh, self.specs, self.pieces = mesh, specs, pieces

    @classmethod
    def place(cls, mesh, specs: dict, leaves: dict) -> "Sharded":
        return cls(mesh, specs, {k: shard(v, specs[k], mesh)
                                 for k, v in leaves.items()})

    def keys(self):
        return self.pieces.keys()

    def gather(self, key: str, device) -> torch.Tensor:
        return gather(self.pieces[key], self.specs[key], self.mesh, device)

    def gather_all(self, device) -> dict:
        return {k: self.gather(k, device) for k in self.pieces}

    @torch.no_grad()
    def assign(self, key: str, leaf: torch.Tensor) -> None:
        """Overwrite ``key``'s pieces, in place, with the pieces of
        ``leaf``."""
        for coord, piece in np.ndenumerate(shard(leaf, self.specs[key],
                                                 self.mesh)):
            self.pieces[key][coord].copy_(piece)


class Placement:
    """What ``to_shardings`` gives: a mesh and a tree of specs, where
    repro gives a tree of ``NamedSharding``."""

    def __init__(self, mesh, specs: dict):
        self.mesh, self.specs = mesh, specs


def to_shardings(mesh, specs: dict) -> Placement:
    return Placement(mesh, specs)


# ------------------------------------------------- models on a slot mesh --
def mesh_param_specs(cfg: ArchConfig, mesh) -> dict:
    """``{repro path: P}`` of ``cfg``'s parameters on ``mesh``."""
    return flatten(param_specs(cfg, convert.jax_shapes(cfg), mesh))


def place_named(cfg: ArchConfig, mesh, specs: dict, params) -> Sharded:
    """The port's ``params`` (an ``Lm`` or ``{name: tensor}``) in repro's
    tree, placed on ``mesh`` by ``specs``."""
    tree = convert.jax_tree_from(cfg, params, leaf=lambda t: t.detach())
    return Sharded.place(mesh, specs, flatten(tree))


def gather_named(cfg: ArchConfig, sharded: Sharded, device) -> dict:
    """``{port name: tensor}`` of a placed tree, gathered on ``device``."""
    full = unflatten(sharded.gather_all(device))
    return {k: v.contiguous()
            for k, v in convert.flat_from_jax(cfg, full).items()}


def data_slots(mesh) -> list:
    """The coordinate of each data slot (one for each coordinate along
    the fsdp axes, at 0 along the others), in slot order."""
    fsdp = fsdp_axes(mesh) or ()
    return list(np.ndindex(*[mesh.shape[a] if a in fsdp else 1
                             for a in mesh.axis_names]))


def split_count(cfg: ArchConfig, slots: int, batch_axis, rows: int,
                seq: int) -> int:
    """Into how many data shards a batch of ``rows`` x ``seq`` positions
    splits over ``slots`` data slots: every data slot where the batch
    spec shards the batch, the rows divide and every shard holds whole
    MoE routing groups (``moe_layer`` routes ``group_size`` tokens
    together), else 1."""
    if batch_axis is None or slots <= 1 or rows % slots:
        return 1
    moe = cfg.moe
    if moe is not None and rows // slots * seq % moe.group_size:
        return 1
    return slots


class Replicas:
    """One model a data slot, for the compute of a placed state: each
    :meth:`load` gathers the parameters onto the slot."""

    def __init__(self, cfg: ArchConfig, mesh):
        self.cfg = cfg
        self.slots = [mesh.devices[c] for c in data_slots(mesh)]
        self.models: dict = {}

    def split(self, batch_axis, rows: int, seq: int) -> int:
        """Into how many data shards a batch of ``rows`` x ``seq``
        positions splits (:func:`split_count` over this mesh's data
        slots)."""
        return split_count(self.cfg, len(self.slots), batch_axis, rows, seq)

    def load(self, i: int, params: Sharded) -> M.Lm:
        """Data slot ``i``'s model holding ``params``, gathered."""
        if i not in self.models:
            self.models[i] = M.Lm(self.cfg, self.slots[i])
        model = self.models[i]
        convert.load_flat(convert.named_params(model),
                          gather_named(self.cfg, params, self.slots[i]))
        return model
