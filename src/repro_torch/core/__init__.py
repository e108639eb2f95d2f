"""BLEST algorithms: graph container, BVSS, reordering, the single-source
drivers and their device layout, Eq. (6) switching, and the pipeline
facade (``preprocess`` -> ``bfs``)."""
