"""Aggregate the dry-run's JSON (``results/dryrun_torch/*.json``) into
markdown tables printed to stdout: the counterpart of
``repro.launch.report``, over the port's keys ("trace" for repro's
"compile", "counted flops" for its "HLO flops (raw)", and whether the
slot's peak bytes fit one device).

    python -m repro_torch.launch.report [--out results/dryrun_torch]
"""
from __future__ import annotations

import argparse
import glob
import json
import os


def load_cells(out_dir: str = "results/dryrun_torch") -> list[dict]:
    cells = []
    for f in sorted(glob.glob(os.path.join(out_dir, "*.json"))):
        with open(f) as fh:
            cells.append(json.load(fh))
    return cells


def fmt_s(x):
    if x is None:
        return "-"
    if x >= 1:
        return f"{x:.2f}s"
    if x >= 1e-3:
        return f"{x * 1e3:.2f}ms"
    return f"{x * 1e6:.1f}us"


def dryrun_table(cells: list[dict]) -> str:
    rows = ["| arch | shape | mesh | trace | counted flops | "
            "analytic flops | HBM bytes | collectives | fits | status |",
            "|---|---|---|---|---|---|---|---|---|---|"]
    for c in sorted(cells, key=lambda c: (c["arch"], c["shape"], c["mesh"])):
        if c.get("status") != "ok":
            rows.append(f"| {c['arch']} | {c['shape']} | {c['mesh']} | - | - "
                        f"| - | - | - | - | **{c.get('status')}** |")
            continue
        coll = c["collectives"]["counts"]
        coll_s = " ".join(f"{k.split('-')[-1][:4]}:{v}"
                          for k, v in sorted(coll.items())) or "none"
        fits = "yes" if c["memory"]["fits"] else "**no**"
        rows.append(
            f"| {c['arch']} | {c['shape']} | {c['mesh']} "
            f"| {c['trace_s']:.1f}s | {c['counted_flops']:.2e} "
            f"| {c['flops']:.2e} | {c['hbm_bytes']:.2e} | {coll_s} "
            f"| {fits} | ok |")
    return "\n".join(rows)


def roofline_table(cells: list[dict], mesh: str = "16x16") -> str:
    rows = ["| arch | shape | compute | memory | collective | dominant | "
            "bound/step | 6ND/analytic |",
            "|---|---|---|---|---|---|---|---|"]
    for c in sorted(cells, key=lambda c: (c["arch"], c["shape"])):
        if c.get("status") != "ok" or c["mesh"] != mesh:
            continue
        r = c["roofline"]
        ratio = c.get("useful_flops_ratio")
        rows.append(
            f"| {c['arch']} | {c['shape']} | {fmt_s(r['compute_s'])} "
            f"| {fmt_s(r['memory_s'])} | {fmt_s(r['collective_s'])} "
            f"| **{r['dominant']}** | {fmt_s(r['bound_s'])} "
            f"| {f'{ratio:.2f}' if ratio else '-'} |")
    return "\n".join(rows)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="results/dryrun_torch",
                    help="the dry-run's output directory")
    args = ap.parse_args(argv)
    cells = load_cells(args.out)
    ok = [c for c in cells if c.get("status") == "ok"]
    print(f"{len(ok)}/{len(cells)} cells ok\n")
    print("## Dry-run\n")
    print(dryrun_table(cells))
    print("\n## Roofline (single-pod 16x16, H100 constants)\n")
    print(roofline_table(cells))


if __name__ == "__main__":
    main()
