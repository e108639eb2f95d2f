"""Graph reordering (paper §4): JACCARDWITHWINDOWS (Alg. 1), RCM, the
scale-free classifier (footnote 2), and the update-divergence metric U_div.

Dispatch policy (paper §4.2 / §7.1): scale-free-like graphs get
JaccardWithWindows (maximize mask density / compression ratio); others get
RCM on G^T (minimize U_div, i.e. cluster the row IDs inside each VSS).

A copy of ``repro.core.reorder`` with two differences: :func:`rcm` works a
BFS level at a time where the reference works a vertex at a time (the same
permutation), and :func:`update_divergence` raises ``ValueError`` on a tau
the lane layout cannot split, where the reference fails in a reshape.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch import spans
from repro_torch.core.bvss import Bvss
from repro_torch.core.graph import Graph


# ---------------------------------------------------------------------------
# Scale-free classifier (paper footnote 2)
# ---------------------------------------------------------------------------


def is_scale_free_like(g: Graph) -> bool:
    """Heavy-tail test: top 1% / 10% of vertices hold >=5% / >=40% of degree,
    or a log-log degree-histogram fit for k>=5 has slope -gamma with
    gamma in [1,5] and R^2 >= 0.70.  Either in- or out-degree suffices."""
    for deg in (g.out_degree, g.in_degree):
        if _heavy_tail(deg) or _powerlaw_fit(deg):
            return True
    return False


def _heavy_tail(deg: np.ndarray) -> bool:
    total = deg.sum()
    if total == 0:
        return False
    s = np.sort(deg)[::-1]
    n = len(s)
    top1 = s[: max(1, n // 100)].sum() / total
    top10 = s[: max(1, n // 10)].sum() / total
    return bool(top1 >= 0.05 and top10 >= 0.40)


def _powerlaw_fit(deg: np.ndarray) -> bool:
    ks, counts = np.unique(deg[deg >= 5], return_counts=True)
    if len(ks) < 5:
        return False
    x = np.log(ks.astype(np.float64))
    y = np.log(counts.astype(np.float64))
    slope, intercept = np.polyfit(x, y, 1)
    pred = slope * x + intercept
    ss_res = ((y - pred) ** 2).sum()
    ss_tot = ((y - y.mean()) ** 2).sum()
    r2 = 1.0 - ss_res / ss_tot if ss_tot > 0 else 0.0
    gamma = -slope
    return bool(r2 >= 0.70 and 1.0 <= gamma <= 5.0)


# ---------------------------------------------------------------------------
# Update divergence U_div (paper §4.2, Table 1)
# ---------------------------------------------------------------------------


def update_divergence(b: Bvss) -> float:
    """Mean over VSSs of the average per-column std of row IDs.

    The VSS matrix is (tau/theta=32) lanes x theta columns; lane l holds
    slices [l*theta, (l+1)*theta), so column c contains slices l*theta + c
    (paper Fig. 3 layout).  Only slices with nonzero masks count; only
    non-empty columns are averaged.
    """
    theta = 32 // b.config.sigma  # slices per thread (paper: 32/sigma)
    if theta == 0:
        theta = 1
    tau = b.config.tau
    if tau % theta:
        # repro.core.reorder fails inside the reshape below on these shapes
        raise ValueError(f"update_divergence needs tau % (32 // sigma) == 0, "
                         f"got tau={tau}, sigma={b.config.sigma}")
    lanes = tau // theta
    rows = b.row_ids[: b.num_vss].reshape(b.num_vss, lanes, theta)
    nz = (b.masks[: b.num_vss] != 0).reshape(b.num_vss, lanes, theta)
    rows = rows.astype(np.float64)
    cnt = nz.sum(axis=1)  # (N_v, theta)
    s1 = (rows * nz).sum(axis=1)
    s2 = (rows * rows * nz).sum(axis=1)
    with np.errstate(divide="ignore", invalid="ignore"):
        mean = s1 / cnt
        var = np.maximum(s2 / cnt - mean * mean, 0.0)
        col_div = np.sqrt(var)  # (N_v, theta), NaN where empty
    set_div = np.nanmean(np.where(cnt > 0, col_div, np.nan), axis=1)
    return float(np.nanmean(set_div)) if b.num_vss else 0.0


# ---------------------------------------------------------------------------
# RCM (Reverse Cuthill-McKee) on G^T
# ---------------------------------------------------------------------------


def rcm(g: Graph) -> np.ndarray:
    """Inverse permutation pi^{-1}: old id -> new id.  BFS-like traversal
    from pseudo-peripheral starts; same-parent children ordered by ascending
    degree; final order reversed (per component).

    ``repro``'s loop takes one vertex at a time; Cuthill-McKee is level
    synchronous, so this takes one level at a time and gives the same
    permutation.  A level's vertices are appended while the one before it
    is processed in order, each to the first of its parents in that order,
    a parent's children by (degree, id): so a level is the frontier's
    unvisited neighbours, each at its first occurrence in frontier order,
    sorted by (parent position, degree, id)."""
    with spans.span("reorder.rcm"):
        ptrs, cols = _symmetric_csr(g)
        deg = np.diff(ptrs)
        n = g.n
        visited = np.zeros(n, dtype=bool)
        order = np.empty(n, dtype=np.int64)
        seeds = np.argsort(deg, kind="stable")
        # the isolated vertices lead the degree order, each a component of
        # its own that is its own start
        pos = levels = int(np.count_nonzero(deg == 0))
        order[:pos] = seeds[:pos]
        visited[order[:pos]] = True
        depth = np.full(n, -1, dtype=np.int64)  # _bfs_levels' workspace
        at = pos
        while pos < n:
            at = _next_unvisited(seeds, visited, at)
            start = _pseudo_peripheral(ptrs, cols, int(seeds[at]), depth)
            comp_begin = pos
            visited[start] = True
            order[pos] = start
            pos += 1
            frontier = order[comp_begin:pos]
            while frontier.size:
                levels += 1
                nbrs, lens = _neighbours(ptrs, cols, frontier)
                parent = np.repeat(np.arange(frontier.size), lens)
                keep = ~visited[nbrs]
                nbrs, parent = nbrs[keep], parent[keep]
                # each vertex at its first occurrence: its earliest parent
                new, first = np.unique(nbrs, return_index=True)
                new = new[np.lexsort((new, deg[new], parent[first]))]
                visited[new] = True
                order[pos : pos + new.size] = new
                frontier = order[pos : pos + new.size]
                pos += new.size
            # reverse within each component (the "R" of RCM)
            order[comp_begin:pos] = order[comp_begin:pos][::-1]
        spans.count("rcm.levels", levels)
        inv = np.empty(n, dtype=np.int64)
        inv[order] = np.arange(n)
        return inv


def _symmetric_csr(g: Graph) -> tuple[np.ndarray, np.ndarray]:
    """The CSR of ``g.symmetrized()``: each row's neighbours sorted, with no
    duplicate.  A graph whose CSR equals its CSC and has strictly increasing
    rows already is that, and skips the sort of both edge directions."""
    (ptrs, cols), (in_ptrs, in_cols) = g.csr, g.csc
    if np.array_equal(ptrs, in_ptrs) and np.array_equal(cols, in_cols):
        step = np.diff(cols.astype(np.int64))
        inner = np.ones(step.size, dtype=bool)
        ends = ptrs[1:-1]
        inner[ends[(ends > 0) & (ends < cols.size)] - 1] = False
        if np.all(step[inner] > 0):
            return ptrs, cols
    return g.symmetrized().csr


def _neighbours(ptrs, cols, frontier: np.ndarray):
    """The frontier's neighbour lists laid end to end in frontier order, and
    the length of each."""
    starts = ptrs[frontier]
    lens = ptrs[frontier + 1] - starts
    offs = np.arange(int(lens.sum())) + np.repeat(
        starts - (np.cumsum(lens) - lens), lens)
    return cols[offs], lens


def _next_unvisited(seeds: np.ndarray, visited: np.ndarray, at: int) -> int:
    """The first index from ``at`` on whose seed is unvisited, looked for in
    growing chunks."""
    step = 1024
    while True:
        hit = np.flatnonzero(~visited[seeds[at : at + step]])
        if hit.size:
            return at + int(hit[0])
        at += step
        step *= 2


def _pseudo_peripheral(ptrs, cols, seed: int, depth: np.ndarray,
                       rounds: int = 2) -> int:
    """Twice: a BFS from ``u``, then ``u`` := the least id at its deepest
    level."""
    u = seed
    for _ in range(rounds):
        u = int(_bfs_levels(ptrs, cols, u, depth)[-1].min())
    return u


def _bfs_levels(ptrs, cols, src: int, depth: np.ndarray) -> list:
    """The BFS levels from ``src``, one array each (in no order within a
    level); ``depth`` (all -1) is a workspace, left all -1 again."""
    depth[src] = 0
    out = [np.array([src])]
    while True:
        nbrs, _ = _neighbours(ptrs, cols, out[-1])
        new = nbrs[depth[nbrs] < 0]
        if not new.size:
            break
        # one of each: every copy writes its position, one of them stays
        at = np.arange(new.size)
        depth[new] = at
        new = new[depth[new] == at]
        depth[new] = len(out)
        out.append(new)
    for lv in out:
        depth[lv] = -1
    return out


# ---------------------------------------------------------------------------
# JACCARDWITHWINDOWS (paper Alg. 1)
# ---------------------------------------------------------------------------


def jaccard_with_windows(g: Graph, sigma: int = 8, window: int = 256
                         ) -> np.ndarray:
    """Inverse permutation pi^{-1} maximizing intra-slice-set neighbourhood
    overlap (Jaccard), restricted to windows of width W (W % sigma == 0).

    Column j's neighbourhood nbrs_A(j) = out-neighbours of j in G (the rows
    of A with a nonzero in column j); candidate updates walk nbrs_{A^T}(i) =
    in-neighbours of i (paper lines 17-22).
    """
    if window % sigma != 0:
        raise ValueError("window must be a multiple of sigma")
    n = g.n
    out_ptrs, out_cols = g.csr  # nbrs_A(j): out-neighbours
    in_ptrs, in_cols = g.csc    # nbrs_{A^T}(i): in-neighbours
    deg = np.diff(out_ptrs)
    pi_inv = np.empty(n, dtype=np.int64)

    # epoch-stamped workspaces shared across slice sets (O(n) total memory)
    inter = np.zeros(n, dtype=np.int64)
    inter_epoch = np.full(n, -1, dtype=np.int64)
    in_r = np.zeros(n, dtype=bool)  # membership of rows in R (reset per set)
    epoch = 0

    for w_start in range(0, n, window):
        w_end = min(w_start + window, n)
        assigned = np.zeros(w_end - w_start, dtype=bool)  # window-local
        win_deg = deg[w_start:w_end]
        slot = w_start
        for s in range((w_end - w_start + sigma - 1) // sigma):
            s_end = min(slot + sigma, w_end)
            epoch += 1
            r_rows: list[int] = []
            q: set[int] = set()
            # seed: highest-degree unassigned column in the window
            jstar = _argmax_unassigned(win_deg, assigned)
            if jstar < 0:
                break
            for fill in range(s_end - slot):
                if fill == 0:
                    pick_local = jstar
                else:
                    if q:
                        pick_local = max(
                            q,
                            key=lambda jl: (
                                inter[w_start + jl]
                                / (len(r_rows) + deg[w_start + jl]
                                   - inter[w_start + jl])
                            ),
                        )
                    else:  # fallback: highest-degree unassigned
                        pick_local = _argmax_unassigned(win_deg, assigned)
                        if pick_local < 0:
                            break
                assigned[pick_local] = True
                q.discard(pick_local)
                j = w_start + pick_local
                pi_inv[j] = slot + fill
                # extend R with j's new rows; update inter for candidates
                for i in out_cols[out_ptrs[j] : out_ptrs[j + 1]]:
                    if in_r[i]:
                        continue
                    in_r[i] = True
                    r_rows.append(int(i))
                    for j2 in in_cols[in_ptrs[i] : in_ptrs[i + 1]]:
                        jl = j2 - w_start
                        if 0 <= jl < (w_end - w_start) and not assigned[jl]:
                            if inter_epoch[j2] != epoch:
                                inter_epoch[j2] = epoch
                                inter[j2] = 0
                            inter[j2] += 1
                            q.add(int(jl))
            # reset R membership for the next slice set
            for i in r_rows:
                in_r[i] = False
            slot = s_end
    return pi_inv


def _argmax_unassigned(win_deg: np.ndarray, assigned: np.ndarray) -> int:
    avail = np.nonzero(~assigned)[0]
    if avail.size == 0:
        return -1
    return int(avail[np.argmax(win_deg[avail])])


# ---------------------------------------------------------------------------
# Dispatch (paper §4.2): scale-free -> JaccardWithWindows, else RCM
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class ReorderResult:
    perm: np.ndarray       # pi^{-1}: old id -> new id
    algorithm: str         # 'jaccard' | 'rcm' | 'natural' | 'random'
    scale_free: bool


def reorder(g: Graph, sigma: int = 8, window: int = 4096,
            force: str | None = None, seed: int = 0) -> ReorderResult:
    sf = is_scale_free_like(g)
    algo = force or ("jaccard" if sf else "rcm")
    if algo == "jaccard":
        perm = jaccard_with_windows(g, sigma=sigma,
                                    window=min(window, _win_cap(g.n, sigma)))
    elif algo == "rcm":
        perm = rcm(g)
    elif algo == "random":
        rng = np.random.default_rng(seed)
        perm = rng.permutation(g.n)
    elif algo == "natural":
        perm = np.arange(g.n)
    else:
        raise ValueError(algo)
    return ReorderResult(perm=perm, algorithm=algo, scale_free=sf)


def _win_cap(n: int, sigma: int) -> int:
    w = max(sigma, (n // 4 // sigma) * sigma)
    return max(w, sigma)
