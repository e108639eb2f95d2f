"""CLI entry points of the port (``python -m repro_torch.launch.<name>``):
graph workloads (``bfs``), the batched graph-query service
(``serve_bfs``), LM serving (``serve``) and LM training (``train``), with
``repro.launch``'s flags and output lines; ``mesh`` builds the slot
meshes training and mesh serving run on.  Each runs on the CUDA device unless given ``--device
cpu``, and has a ``main(argv=None)`` that tests call in-process.

The dry-run and its cost model: ``roofline`` (the roofline terms on the
H100's constants, and the collectives of the slot-mesh steps counted
from the sharding specs), ``analytic`` (repro's closed-form FLOP and HBM
byte model), ``dryrun`` (each cell's step for one data slot traced on
``meta`` tensors: bytes, counted FLOPs, collectives, roofline; one
device's memory from ``--hbm-bytes`` or the CUDA device) and ``report``
(markdown tables of the dry-run's JSON)."""
