"""Deterministic synthetic data pipeline (a copy of ``repro.data.synthetic``:
numpy only, bit-equal batches).

Design requirements at fleet scale (DESIGN.md §5):
  * **stateless**: batch(step) is a pure function of (seed, step, host), so
    restart/elastic-rescale needs no data-loader state in the checkpoint;
  * **per-host sharded**: each host materializes only its batch slice;
  * **prefetched**: a single-slot background thread hides host latency.

Token streams are hash-derived (threefry via jax.random under the hood would
be device work; here we use a numpy Philox counter stream keyed by
(seed, step)) with a Zipf-ish marginal so the CE loss has realistic headroom.
"""
from __future__ import annotations

import dataclasses
import queue
import threading

import numpy as np

from repro_torch.configs.base import ArchConfig, ShapeConfig


@dataclasses.dataclass(frozen=True)
class DataConfig:
    seed: int = 0
    zipf_a: float = 1.3
    num_hosts: int = 1
    host_id: int = 0


def batch_for_step(cfg: ArchConfig, shape: ShapeConfig, data: DataConfig,
                   step: int) -> dict:
    """Host-local batch for ``step`` (deterministic, seekable)."""
    local_b = shape.global_batch // data.num_hosts
    rng = np.random.default_rng(
        np.random.Philox(key=(data.seed << 64)
                         ^ (step << 32) ^ (data.host_id << 16) ^ 0xB1E57))
    raw = rng.zipf(data.zipf_a, size=(local_b, shape.seq_len + 1))
    tokens = (raw % cfg.vocab).astype(np.int32)
    batch = {"tokens": tokens[:, :-1], "targets": tokens[:, :-1]}
    if cfg.modality == "embeds":
        batch["embeds"] = rng.standard_normal(
            (local_b, shape.seq_len, cfg.d_model), dtype=np.float32)
        batch.pop("tokens")
        batch["targets"] = tokens[:, :-1]
    elif cfg.modality == "prefix":
        txt = shape.seq_len - cfg.prefix_len
        batch["tokens"] = tokens[:, :txt]
        batch["targets"] = tokens[:, :txt]
        batch["embeds"] = rng.standard_normal(
            (local_b, cfg.prefix_len, cfg.d_model), dtype=np.float32)
    return batch


class Prefetcher:
    """One-slot background prefetch of batch(step+1) while step runs."""

    def __init__(self, cfg: ArchConfig, shape: ShapeConfig,
                 data: DataConfig, start_step: int = 0, depth: int = 2):
        self.cfg, self.shape, self.data = cfg, shape, data
        self.q: queue.Queue = queue.Queue(maxsize=depth)
        self.next_step = start_step
        self.stop = threading.Event()
        self.thread = threading.Thread(target=self._work, daemon=True)
        self.thread.start()

    def _work(self):
        while not self.stop.is_set():
            b = batch_for_step(self.cfg, self.shape, self.data,
                               self.next_step)
            self.next_step += 1
            while not self.stop.is_set():
                try:
                    self.q.put(b, timeout=0.1)
                    break
                except queue.Full:
                    continue

    def get(self) -> dict:
        return self.q.get()

    def close(self):
        self.stop.set()
        self.thread.join(timeout=2)
