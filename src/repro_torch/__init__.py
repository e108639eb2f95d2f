"""PyTorch/CUDA port of the BLEST BFS framework (``repro``) for NVIDIA Hopper.

The package mirrors ``repro``'s layout (``core/``, ``data/``, ``kernels/``)
and names, so the counterpart of each module sits at the same relative path.
It imports ``torch`` and numpy only: never ``jax`` and never ``repro``.

Entry points run on the CUDA device unless the caller passes
``device="cpu"``; a tensor's device picks the path of every kernel (the
hand-written CUDA kernel for a CUDA tensor, its plain PyTorch version for a
CPU tensor).  Ported so far: single- and multi-source BLEST BFS and
closeness through :class:`repro_torch.core.pipeline.Blest`, the packed
multi-source layout (``core/msbfs_packed``), the serve engine
(:class:`repro_torch.serve.bfs_engine.BfsEngine`) with the analytics
kinds, the BRS baseline (``core/brs_baseline``), multi-device BLEST and
mesh serving over a group of device slots (``core/distributed``,
``serve/mesh``), and the launchers (``python -m repro_torch.launch.bfs``
/ ``.serve_bfs``).
"""
