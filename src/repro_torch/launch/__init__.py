"""CLI entry points of the port (``python -m repro_torch.launch.<name>``):
graph workloads (``bfs``), the batched graph-query service
(``serve_bfs``), LM serving (``serve``) and LM training (``train``), with
``repro.launch``'s flags and output lines; ``mesh`` builds the slot
meshes training and mesh serving run on.  Each runs on the CUDA device unless given ``--device
cpu``, and has a ``main(argv=None)`` that tests call in-process."""
