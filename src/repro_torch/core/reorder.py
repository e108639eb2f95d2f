"""Graph reordering (paper §4): JACCARDWITHWINDOWS (Alg. 1), RCM, the
scale-free classifier (footnote 2), and the update-divergence metric U_div.

Dispatch policy (paper §4.2 / §7.1): scale-free-like graphs get
JaccardWithWindows (maximize mask density / compression ratio); others get
RCM on G^T (minimize U_div, i.e. cluster the row IDs inside each VSS).

A copy of ``repro.core.reorder``; the one difference is that
:func:`update_divergence` raises ``ValueError`` on a tau the lane layout
cannot split, where the reference fails in a reshape.
"""
from __future__ import annotations

import dataclasses

import numpy as np

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
    degree; final order reversed (per component)."""
    gs = g.symmetrized()
    ptrs, cols = gs.csr
    deg = np.diff(ptrs)
    n = g.n
    visited = np.zeros(n, dtype=bool)
    order = np.empty(n, dtype=np.int64)
    pos = 0
    comp_starts = []
    for seed in np.argsort(deg, kind="stable"):
        if visited[seed]:
            continue
        start = _pseudo_peripheral(ptrs, cols, int(seed))
        comp_begin = pos
        visited[start] = True
        order[pos] = start
        pos += 1
        head = comp_begin
        while head < pos:
            u = order[head]
            head += 1
            nbrs = cols[ptrs[u] : ptrs[u + 1]]
            new = nbrs[~visited[nbrs]]
            if new.size:
                new = np.unique(new)
                new = new[np.argsort(deg[new], kind="stable")]
                visited[new] = True
                order[pos : pos + new.size] = new
                pos += new.size
        comp_starts.append((comp_begin, pos))
    # reverse within each component (the "R" of RCM)
    for b, e in comp_starts:
        order[b:e] = order[b:e][::-1]
    inv = np.empty(n, dtype=np.int64)
    inv[order] = np.arange(n)
    return inv


def _pseudo_peripheral(ptrs, cols, seed: int, rounds: int = 2) -> int:
    u = seed
    for _ in range(rounds):
        lv = _bfs_depths(ptrs, cols, u)
        far = lv[lv >= 0].max(initial=0)
        cand = np.nonzero(lv == far)[0]
        if cand.size == 0:
            return u
        u = int(cand[0])
    return u


def _bfs_depths(ptrs, cols, src: int) -> np.ndarray:
    n = len(ptrs) - 1
    lv = np.full(n, -1, dtype=np.int64)
    lv[src] = 0
    frontier = np.array([src])
    d = 0
    while frontier.size:
        d += 1
        nxt = []
        for u in frontier:
            nbrs = cols[ptrs[u] : ptrs[u + 1]]
            new = nbrs[lv[nbrs] < 0]
            lv[new] = d
            nxt.append(new)
        frontier = np.unique(np.concatenate(nxt)) if nxt else np.array([], dtype=np.int64)
    return lv


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
