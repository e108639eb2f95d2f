"""``ms_per_level``: the part of the traced run's window before the
profiler starts, over the levels its completed queries ran (the query
kind's ``levels_run``, from the reference on the same sources).  It is a
host-clock time of the facade and the drivers together
(``core/pipeline.Blest`` with each query's host end, ``core/blest.FusedBfs``,
``core/msbfs.FusedMsBfs``, ``core/window.LevelWindow``), not of the level
window alone, and should move ``edges_per_s`` (``ms_per_level.lanes``:
``lane_edges_per_s``)."""


def read(run):
    if not run["unprofiled_levels"]:
        return None
    return run["unprofiled_s"] * 1e3 / run["unprofiled_levels"]
