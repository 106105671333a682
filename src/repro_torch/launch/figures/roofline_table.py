"""Assemble the §Roofline table from the port's dry-run JSON cells.

The port of the reference's ``benchmarks/roofline_table.py``.  It reads
what ``python -m repro_torch.launch.dryrun --all [--multi-pod]`` writes
(one JSON per cell in ``experiments/dryrun_torch/``, keys of
``launch.dryrun.run_cell``): the H100 roofline terms of each (arch, shape)
cell and its per-device peak.  Where the reference adds XLA's argument and
temporary bytes, the port's dry run gives the peak of its fake-tensor run
(``memory.peak_bytes_per_device``), which the tables show as HBM GB/dev.

    PYTHONPATH=src python -m repro_torch.launch.figures.roofline_table

prints both meshes' cells as markdown, each with its lever.
"""

from __future__ import annotations

import json
from pathlib import Path

# Where ``launch/dryrun.py`` writes its cells (its ``OUT_DIR``), named here
# so that the tables do not import the dry run and torch with it.
DRYRUN_DIR = Path(__file__).resolve().parents[4] / "experiments" / "dryrun_torch"


def load_cells(mesh: str = "single") -> list[dict]:
    cells = []
    for p in sorted(DRYRUN_DIR.glob(f"*__{mesh}.json")):
        d = json.loads(p.read_text())
        if d.get("ok"):
            cells.append(d)
    return cells


def _hbm_gb(d: dict) -> float:
    return d["memory"]["peak_bytes_per_device"] / 1e9


def table(mesh: str = "single") -> str:
    cells = load_cells(mesh)
    if not cells:
        return f"(no dry-run artifacts for mesh={mesh} — run "\
               "`python -m repro_torch.launch.dryrun --all` first)"
    hdr = (f"{'arch':28s} {'shape':12s} {'compute_s':>10s} {'memory_s':>10s} "
           f"{'coll_s':>10s} {'dominant':>10s} {'useful':>7s} {'HBM GB/dev':>10s}")
    lines = [hdr, "-" * len(hdr)]
    for d in cells:
        r = d["roofline"]
        useful = d.get("useful_flops_ratio")
        lines.append(
            f"{d['arch']:28s} {d['shape']:12s} {r['compute_s']:10.4f} "
            f"{r['memory_s']:10.4f} {r['collective_s']:10.4f} "
            f"{r['dominant']:>10s} "
            f"{useful if useful is None else round(useful, 3)!s:>7s} "
            f"{_hbm_gb(d):10.2f}")
    return "\n".join(lines)


def run(quick: bool = False) -> list[tuple]:
    rows = []
    for mesh in ("single", "multi"):
        cells = load_cells(mesh)
        n_dom = {}
        for d in cells:
            n_dom[d["roofline"]["dominant"]] = \
                n_dom.get(d["roofline"]["dominant"], 0) + 1
        rows.append((f"roofline/{mesh}", 0.0,
                     f"cells={len(cells)};" + ";".join(
                         f"{k}_bound={v}" for k, v in sorted(n_dom.items()))))
    return rows


def check(rows) -> list[str]:
    return []


def lever(d: dict) -> str:
    """One sentence: what would move this cell's dominant term down on
    the port."""
    dom = d["roofline"]["dominant"]
    shape = d["shape"]
    moe = d["arch"].startswith(("mixtral", "llama4", "jamba"))
    if dom == "collective":
        if shape.startswith("decode"):
            return ("duplicate the small per-step weights per model shard "
                    "(weight-stationary decode) to remove per-token TP "
                    "all-reduces")
        if moe:
            return ("reduce-scatter (not all-reduce+slice) the expert "
                    "products' backward partials; overlap via MSA-ordered "
                    "buckets")
        return ("sequence-parallel attention backward to replace activation "
                "all-reduces with reduce-scatters over the model axis")
    if dom == "memory":
        if shape == "train_4k":
            return ("a fused multi-tensor AdamW and a vocab-parallel "
                    "cross-entropy; the dry run's bytes are a lower bound")
        if shape.startswith(("decode", "long")):
            return ("a split-K decode kernel on the bf16 cache (no fp32 "
                    "copy) and an int8/fp8 KV cache")
        return ("keep the score tensors on chip: the flash and SSD kernels "
                "on TMA and warp-specialised pipelines")
    return ("raise arithmetic intensity: larger microbatch per device or "
            "fewer recomputed units (compute-bound is the target state)")


def markdown(mesh: str) -> str:
    lines = ["| arch | shape | compute_s | memory_s | collective_s | "
             "dominant | useful | HBM GB/dev | mb | lever (what moves the "
             "dominant term) |",
             "|---|---|---|---|---|---|---|---|---|---|"]
    for d in load_cells(mesh):
        r = d["roofline"]
        u = d.get("useful_flops_ratio")
        lines.append(
            f"| {d['arch']} | {d['shape']} | {r['compute_s']:.4f} | "
            f"{r['memory_s']:.4f} | {r['collective_s']:.4f} | "
            f"{r['dominant']} | {u if u is None else round(u, 3)} | "
            f"{_hbm_gb(d):.1f} | {d.get('microbatches', 1)} | {lever(d)} |")
    return "\n".join(lines)


if __name__ == "__main__":
    for mesh in ("single", "multi"):
        print(f"== Roofline ({mesh}) ==")
        print(markdown(mesh))
