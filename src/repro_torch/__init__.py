"""PyTorch/CUDA port of the BLEST BFS framework (``repro``) for NVIDIA Hopper.

The package mirrors ``repro``'s layout (``core/``, ``data/``, ``kernels/``)
and names, so the counterpart of each module sits at the same relative path.
It imports ``torch`` and numpy only: never ``jax`` and never ``repro``.

Entry points run on the CUDA device unless the caller passes
``device="cpu"``; a tensor's device picks the path of every kernel (the
hand-written CUDA kernel for a CUDA tensor, its plain PyTorch version for a
CPU tensor).  Ported so far: single-source BLEST BFS through
:class:`repro_torch.core.pipeline.Blest` (``preprocess`` then ``bfs``).
"""
