"""Table III: per-operation cache energies (SRAM + FeFET, L1 + L2) from the
device model — must reproduce the published numbers at the anchor configs
and extrapolate for the Fig. 14 configurations."""
from __future__ import annotations

from repro_torch.core import L1_32K, L1_64K, L2_256K, L2_2M, TECHS
from repro_torch.bench.common import banner, emit

PAPER = {
    ("sram", "64kB/4w L1"): [61, 71, 72, 79, 79],
    ("sram", "256kB/8w L2"): [314, 341, 344, 365, 365],
    ("fefet", "64kB/4w L1"): [34, 35, 88, 105, 105],
    ("fefet", "256kB/8w L2"): [70, 72, 146, 205, 205],
}
OPS = ("read", "CiM-OR", "CiM-AND", "CiM-XOR", "CiM-ADD")
CFGS = [("32kB/4w L1", L1_32K), ("64kB/4w L1", L1_64K),
        ("256kB/8w L2", L2_256K), ("2MB/8w L2", L2_2M)]


def run():
    rows = []
    for tech_name, tech in TECHS.items():
        for cfg_name, cfg in CFGS:
            got = tech.table3_row(cfg)
            row = {"tech": tech_name, "config": cfg_name,
                   **{op: got[op] for op in OPS}}
            paper = PAPER.get((tech_name, cfg_name))
            if paper:
                row["max_dev_pct"] = round(max(
                    abs(got[o] - p) / p * 100 for o, p in zip(OPS, paper)), 2)
            rows.append(row)
    return rows


def main():
    banner("Table III: cache energy (pJ) per operation")
    rows = run()
    for r in rows:
        dev = f"  (max dev vs paper {r['max_dev_pct']}%)" if "max_dev_pct" in r else ""
        print(f"  {r['tech']:6s} {r['config']:13s} " +
              " ".join(f"{r[o]:7.1f}" for o in OPS) + dev)
    emit("table3_energy", rows)
    return rows


if __name__ == "__main__":
    main()
