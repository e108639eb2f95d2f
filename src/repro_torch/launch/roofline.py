"""Roofline terms on the NVIDIA H100's constants, and the collectives of
the port's slot-mesh steps: the counterpart of ``repro.launch.roofline``.

    compute term    = FLOPs / (chips * PEAK_FLOPS)
    memory term     = HBM bytes / (chips * HBM_BW)
    collective term = collective wire bytes / (chips * LINK_BW)

Hardware constants: one H100 SXM (NVIDIA's data sheet, dense rates
without sparsity, at the full 700 W power limit): 989 TFLOP/s bf16 in
the tensor cores, 3.35 TB/s HBM3.  The integer kernels of the graph path
are bound by the 67 TFLOP/s float32 rate of the CUDA cores (the highest
rate they could issue at) or, for the MMA-form pulls, by the 1,979 TOP/s
dense int8 tensor-core rate.

``LINK_BW`` is the per-GPU network rate across hosts: a DGX H100 gives
each GPU one 400 Gb/s ConnectX-7 port, 50 GB/s.  Inside a host NVLink
carries 450 GB/s each way, but the production meshes' 16-wide axes
(16 x 16 and 2 x 16 x 16 slots) span more than one 8-GPU host, so every
collective over such an axis crosses the slower link, and the roofline
takes it.

repro reads its collectives from the compiled HLO text.  The port
produces no HLO: :func:`collective_stats` counts what the port's
slot-mesh step (``train/train_loop._MeshStep``,
``serve/serve_loop.build_prefill`` / ``build_decode_step``) moves for one
data slot, from ``train/sharding``'s specs, and :func:`bfs_collective_stats`
the one exchange of a BFS level, from its shapes.  Each kind keeps
repro's wire factor: a ring all-reduce moves about twice its payload per
device, the others about once.
"""
from __future__ import annotations

import dataclasses
import math

PEAK_FLOPS = 989e12      # bf16 / chip, dense tensor cores
HBM_BW = 3.35e12         # bytes/s / chip
LINK_BW = 50e9           # bytes/s / GPU across hosts (400 Gb/s)

# the same peaks under the names the card's measurements use
BF16_FLOPS_PER_S = PEAK_FLOPS
HBM_BYTES_PER_S = HBM_BW
ALU_OPS_PER_S = 67e12        # float32 rate of the CUDA cores
INT8_MMA_OPS_PER_S = 1979e12  # dense int8 tensor-core rate

_COLLECTIVE_FACTORS = {
    "all-reduce": 2.0,        # ring: reduce-scatter + all-gather
    "all-gather": 1.0,
    "reduce-scatter": 1.0,
    "all-to-all": 1.0,
    "collective-permute": 1.0,
    "scatter": 1.0,           # slot mesh: pieces sent out from the first slot
    "collect": 1.0,           # slot mesh: pieces sent back to the first slot
}


@dataclasses.dataclass
class CollectiveStats:
    counts: dict
    result_bytes: dict
    wire_bytes: float

    def to_json(self):
        return {"counts": self.counts, "result_bytes": self.result_bytes,
                "wire_bytes": self.wire_bytes}


class _Tally:
    def __init__(self):
        self.counts: dict = {}
        self.result_bytes: dict = {}

    def add(self, kind: str, nbytes: int) -> None:
        if nbytes > 0:
            self.counts[kind] = self.counts.get(kind, 0) + 1
            self.result_bytes[kind] = self.result_bytes.get(kind, 0) + nbytes

    def stats(self) -> CollectiveStats:
        wire = sum(b * _COLLECTIVE_FACTORS[k]
                   for k, b in self.result_bytes.items())
        return CollectiveStats(self.counts, self.result_bytes, float(wire))


def _nbytes(shape, dtype) -> int:
    return math.prod(shape) * dtype.itemsize


def collective_stats(cfg, shape, mesh) -> CollectiveStats:
    """What one computing data slot of the port's slot-mesh step on
    ``mesh`` moves in one step of ``shape``, from the specs (a slot's
    pieces taken as the first slot's, the largest where a dim does not
    divide).  Where the batch splits over the data slots, the counted
    slot is one of them other than the first:

    * ``all-gather``: each leaf's pieces the slot lacks, gathered once a
      step (``Replicas.load``);
    * ``all-reduce`` (train): the f32 gradient of every leaf, summed over
      the data slots;
    * ``scatter``: (train) the slot's piece of each summed gradient,
      written back into its piece (``_MeshStep.update``); (decode) its
      rows of the gathered cache and, after the step, its piece of the
      cache cut again (``Sharded.assign``);
    * ``collect`` (prefill, decode): its last-position logits (f32) and,
      for decode, its piece of the cache (``gather_all``) and its
      updated rows, sent to the first slot.

    Where the batch stays whole, the counted slot is the first, which
    computes alone: it gathers the parameters and the cache pieces it
    lacks and sends the other slots their pieces of the gradient or of
    the cache.  Every count is one leaf's transfer."""
    import torch

    from repro_torch.models import convert
    from repro_torch.train import sharding as S

    tally = _Tally()
    coord = (0,) * len(mesh.sizes)
    specs = S.mesh_param_specs(cfg, mesh)
    b = shape.global_batch
    n = data_shards(cfg, shape, mesh)
    for k, leaf in S.flatten(convert.jax_shapes(cfg)).items():
        own = S.piece(leaf, specs[k], mesh, coord)
        own, whole = _nbytes(own.shape, own.dtype), _nbytes(leaf.shape,
                                                            leaf.dtype)
        tally.add("all-gather", whole - own)
        if shape.kind == "train" and n > 1:
            tally.add("all-reduce", _nbytes(leaf.shape, torch.float32))
            tally.add("scatter", own)
        elif shape.kind == "train":
            tally.add("scatter", whole - own)
    if shape.kind == "decode":
        from repro_torch.models import model as M

        cspecs = S.cache_specs(cfg, shape, mesh)
        for k, leaf in M.init_cache(cfg, b, shape.seq_len, "meta").items():
            own = S.piece(leaf, cspecs[k], mesh, coord)
            own = _nbytes(own.shape, own.dtype)
            if n > 1:
                rows = leaf[:, : b // n]
                moved = own + _nbytes(rows.shape, rows.dtype)
            else:
                moved = _nbytes(leaf.shape, leaf.dtype) - own
            tally.add("collect", moved)
            tally.add("scatter", moved)
    if shape.kind != "train" and n > 1:
        tally.add("collect", 4 * (b // n) * cfg.vocab)
    return tally.stats()


def data_shards(cfg, shape, mesh) -> int:
    """Over how many data slots the slot-mesh step of ``shape`` splits
    its batch (``Replicas.split`` as the steps call it: the batch spec's
    axis for train and prefill, the cache spec's batch axis for decode;
    1 where the batch stays whole on the first slot)."""
    from repro_torch.train import sharding as S

    rows, seq = shape.global_batch, shape.seq_len
    if shape.kind == "decode":
        specs = S.cache_specs(cfg, shape, mesh)
        axis, seq = next(iter(specs.values()))[1], 1
    else:
        axis = S.batch_specs(cfg, shape, mesh)["tokens"][0]
    return S.split_count(cfg, len(S.data_slots(mesh)), axis, rows, seq)


def bfs_collective_stats(shape_name: str, mesh, n: int, sigma: int
                         ) -> CollectiveStats:
    """The one exchange of a BFS level on ``mesh`` (``n`` vertices),
    from its shapes: the multi-source levels' ``psum`` of the int32
    ``far`` (n + sigma entries), ``ssbfs_replicated``'s ``pmax`` of the
    n + sigma visited bytes, ``ssbfs_row``'s tiled ``all_gather`` of the
    frontier bytes (one a slice set, the model axis's pieces together)."""
    tally = _Tally()
    if shape_name.startswith("msbfs"):
        tally.add("all-reduce", 4 * (n + sigma))
    elif shape_name == "ssbfs_replicated":
        tally.add("all-reduce", n + sigma)
    elif shape_name == "ssbfs_row":
        shards = mesh.shape["model"]
        tally.add("all-gather", shards * (n // shards // sigma))
    else:
        raise ValueError(shape_name)
    return tally.stats()


def roofline_terms(flops: float, bytes_accessed: float,
                   collective_wire_bytes: float, chips: int) -> dict:
    compute_s = flops / (chips * PEAK_FLOPS)
    memory_s = bytes_accessed / (chips * HBM_BW)
    collective_s = collective_wire_bytes / (chips * LINK_BW)
    terms = {"compute_s": compute_s, "memory_s": memory_s,
             "collective_s": collective_s}
    dominant = max(terms, key=terms.get)
    bound = max(terms.values())
    total = sum(terms.values())
    return {
        **terms,
        "dominant": dominant.replace("_s", ""),
        "bound_s": bound,
        # fraction of the ideal (dominant-term-only) time: how close the
        # other two terms are to being hidden under the dominant one
        "overlap_headroom": bound / total if total > 0 else 0.0,
    }


def model_flops(n_params_active: int, tokens: int, kind: str) -> float:
    """6·N·D for training, 2·N·D for forward-only (inference)."""
    mult = 6 if kind == "train" else 2
    return float(mult) * n_params_active * tokens
