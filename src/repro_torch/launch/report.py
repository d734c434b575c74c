"""Render the dry run's tables from ``runs/dryrun``.  Counterpart of
``repro.launch.report``: the same tables over the port's records, whose
numbers are planned from the H100 SXM constants of ``launch.roofline``
(not measured).  The fit column is the H100's 80 GB; the hints name
H100 levers."""
from __future__ import annotations

import argparse
import glob
import json
import os

FIT_GIB = 80

FIXES = {
    "memory": "fuse attention temporaries (flash kernel) / cast "
              "collectives+softmax to bf16",
    "collective": "sequence-parallel RS+AG instead of AR; overlap "
                  "via async collectives",
    "compute": "already tensor-core-bound; raise per-device batch or "
               "reduce remat",
}


def load(out_dir):
    rows = []
    for f in sorted(glob.glob(os.path.join(out_dir, "*.json"))):
        with open(f) as fh:
            rows.append(json.load(fh))
    return rows


def fmt_bytes(b):
    return f"{b/2**30:.2f}"


def dryrun_table(rows, mesh):
    hdr = ("| arch | shape | status | trace s | args GiB/chip | "
           f"temp GiB/chip | fits {FIT_GIB}GB |\n"
           "|---|---|---|---|---|---|---|")
    out = [hdr]
    for r in rows:
        if r["mesh"] != mesh:
            continue
        if r["status"] == "skipped":
            out.append(f"| {r['arch']} | {r['shape']} | SKIP: "
                       f"{r['reason'][:60]}... | | | | |")
            continue
        if r["status"] != "ok":
            out.append(f"| {r['arch']} | {r['shape']} | ERROR | | | | |")
            continue
        m = r["memory_per_device"]
        tot = (m["argument_bytes"] + m["temp_bytes"]) / 2**30
        out.append(
            f"| {r['arch']} | {r['shape']} | ok | {r['trace_s']} | "
            f"{fmt_bytes(m['argument_bytes'])} | {fmt_bytes(m['temp_bytes'])}"
            f" | {'YES' if tot <= FIT_GIB else f'NO ({tot:.0f} GiB)'} |")
    return "\n".join(out)


def roofline_table(rows, mesh="16x16"):
    hdr = ("| arch | shape | compute s | memory s | collective s | "
           "dominant | MODEL_FLOPs/HLO | roofline frac | one-line fix |\n"
           "|---|---|---|---|---|---|---|---|---|")
    out = [hdr]
    for r in rows:
        if r["mesh"] != mesh or r["status"] != "ok":
            continue
        out.append(
            f"| {r['arch']} | {r['shape']} | {r['compute_s']:.4f} | "
            f"{r['memory_s']:.4f} | {r['collective_s']:.4f} | "
            f"{r['dominant']} | {r['useful_flops_ratio']:.2f} | "
            f"{r['roofline_fraction']:.3f} | {FIXES[r['dominant']]} |")
    return "\n".join(out)


def cell_table(rows, mesh="16x16"):
    """One line an arch, one column a shape: per-device argument and temp
    GiB and the step's lower bound (dominant term's initial: compute,
    memory, collective), or SKIP."""
    from repro_torch.configs import ARCH_IDS, SHAPES
    by = {(r["arch"], r["shape"]): r for r in rows if r["mesh"] == mesh}
    out = ["| arch | " + " | ".join(SHAPES) + " |",
           "|---|" + "---|" * len(SHAPES)]
    for a in ARCH_IDS:
        cells = []
        for s in SHAPES:
            r = by.get((a, s))
            if r is None or r["status"] == "error":
                cells.append("" if r is None else "ERROR")
            elif r["status"] == "skipped":
                cells.append("SKIP")
            else:
                m = r["memory_per_device"]
                cells.append(f"{fmt_bytes(m['argument_bytes'])} / "
                             f"{fmt_bytes(m['temp_bytes'])} GiB, "
                             f"{r['step_lower_bound_s']:.4f} s "
                             f"{r['dominant'][0]}")
        out.append(f"| {a} | " + " | ".join(cells) + " |")
    return "\n".join(out)


def pick_hillclimb(rows):
    ok = [r for r in rows if r["status"] == "ok" and r["mesh"] == "16x16"]
    worst = min(ok, key=lambda r: r["roofline_fraction"])
    coll = max(ok, key=lambda r: r["collective_s"] /
               max(r["step_lower_bound_s"], 1e-12))
    return worst, coll


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="runs/dryrun")
    ap.add_argument("--mesh", default="16x16")
    args = ap.parse_args(argv)
    rows = load(args.out)
    print("### Dry run (planned from H100 SXM constants, not measured) --",
          args.mesh)
    print(dryrun_table(rows, args.mesh))
    print("\n### Roofline (planned) --", args.mesh)
    print(roofline_table(rows, args.mesh))
    print("\n### Arch x shape (planned) --", args.mesh)
    print(cell_table(rows, args.mesh))
    w, c = pick_hillclimb(rows)
    print(f"\nworst roofline: {w['arch']}×{w['shape']} "
          f"({w['roofline_fraction']:.3f}); most collective-bound: "
          f"{c['arch']}×{c['shape']} ({c['collective_s']:.3f}s)")


if __name__ == "__main__":
    main()
