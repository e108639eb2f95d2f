"""blest-bfs: the paper's own workload as a dry-run/roofline config.

A container-independent synthetic instance sized like the paper's mid-range
graphs (com-Friendster-class after BVSS compression): n = 64M vertices,
N_v = 4M virtual slice sets (tau=128 slices each => 512M slice slots),
kappa = 256 concurrent BFSs.  The dry-run lowers one fused MS-BFS level
(stage 1 pull + scatter + stage 2 sweep) and the row-parallel SS-BFS level.
"""
from repro_torch.configs import register
from repro_torch.configs.base import ArchConfig

# Reuse ArchConfig as a carrier; BFS-specific sizes live in the dryrun driver.
CONFIG = register(ArchConfig(
    name="blest-bfs", family="graph",
    n_layers=0, d_model=0, n_heads=0, n_kv=0, d_ff=0, vocab=0,
    source="paper (Elbek & Kaya 2026): BLEST MS-BFS/closeness workload",
))

# Workload geometry for the dry-run / roofline:
N_VERTICES = 64 * 1024 * 1024
NUM_VSS = 4 * 1024 * 1024
KAPPA = 256
SIGMA = 8
TAU = 128
