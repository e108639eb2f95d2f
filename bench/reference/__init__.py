"""Plain PyTorch reference of what the port computes: BFS levels, closeness
and connected components, from the benchmark's own CSC and source ids.

It imports torch and numpy only: nothing of ``repro_torch``, ``repro`` or
JAX, and none of the port's plain kernel versions.  It works everything out
again from the edges (the port's order, BVSS and permutation play no part).
"""
