"""§Roofline on the port: read ``repro_torch.launch.dryrun``'s artifacts
and render the 40-cell table (three terms in seconds, dominant bottleneck,
MODEL_FLOPS ratio, MFU); the port's copy of ``benchmarks/roofline.py``.

The cells are the catalog's H100 meshes, ``32x8`` (256 cards) and
``2x32x8`` (512), in place of the reference's ``16x16`` and ``2x16x16``;
the terms are the H100's datasheet rates (``launch/analysis.py``).  Read
from ``REPRO_TORCH_DRYRUN_DIR`` (default ``artifacts/dryrun_torch``, where
``python -m repro_torch.launch.dryrun`` writes).

    python benchmarks/torch_roofline.py
"""
from __future__ import annotations

import glob
import json
import os

ART_DIR = os.environ.get("REPRO_TORCH_DRYRUN_DIR", "artifacts/dryrun_torch")
#: the single-pod and two-pod cell meshes (``launch/dryrun.py::MESHES``)
MESH, MULTI_MESH = "32x8", "2x32x8"


def load_cells(mesh: str | None = MESH) -> list[dict]:
    cells = []
    for path in sorted(glob.glob(os.path.join(ART_DIR, "*.json"))):
        with open(path) as f:
            c = json.load(f)
        if mesh is None or c.get("mesh") == mesh:
            cells.append(c)
    return cells


def table(mesh: str = MESH) -> list[dict]:
    rows = []
    for c in load_cells(mesh):
        base = {"arch": c["arch"], "shape": c["shape"], "mesh": c["mesh"]}
        if c["status"] != "ok":
            rows.append({**base, "status": c["status"],
                         "note": c.get("reason", c.get("error", ""))[:80]})
            continue
        r = c["roofline"]
        rows.append({
            **base, "status": "ok",
            "t_compute_s": round(r["t_compute_s"], 5),
            "t_memory_s": round(r["t_memory_s"], 5),
            "t_collective_s": round(r["t_collective_s"], 5),
            "bottleneck": r["bottleneck"],
            "step_s": round(r["step_time_s"], 5),
            "mfu": round(r["model_flops_util"], 4),
            "useful_flops": round(r["useful_flops_ratio"], 3),
            "model_flops": f"{c['model_flops']:.3e}",
            "compile_s": c["compile_s"],
        })
    return rows


def run() -> dict:
    rows = table(MESH)
    ok = [r for r in rows if r["status"] == "ok"]
    skipped = [r for r in rows if r["status"] == "skipped"]
    errors = [r for r in rows if r["status"] == "error"]
    multi = [r for r in table(MULTI_MESH) if r["status"] == "ok"]
    train = [r for r in ok if r["shape"] == "train_4k"]
    prefill = [r for r in ok if r["shape"] == "prefill_32k"]
    return {
        "rows": rows,
        "n_ok": len(ok), "n_skipped": len(skipped), "n_error": len(errors),
        "n_multipod_ok": len(multi),
        "bottleneck_histogram": {
            b: sum(1 for r in ok if r["bottleneck"] == b)
            for b in ("compute", "memory", "collective")},
        "mean_mfu": (sum(r["mfu"] for r in ok) / len(ok)) if ok else 0.0,
        # decode cells are intrinsically ~0.1% MFU (1 token vs all weights);
        # the train/prefill means are the meaningful utilisation numbers
        "mean_mfu_train": (sum(r["mfu"] for r in train) / len(train)
                           if train else 0.0),
        "mean_mfu_prefill": (sum(r["mfu"] for r in prefill) / len(prefill)
                             if prefill else 0.0),
        "best_mfu_train": max((r["mfu"] for r in train), default=0.0),
    }


def render(rows: list[dict]) -> str:
    hdr = (f"{'arch':<22} {'shape':<12} {'status':<8} {'compute':>9} "
           f"{'memory':>9} {'collect':>9} {'bottleneck':<11} {'MFU':>6}")
    lines = [hdr, "-" * len(hdr)]
    for r in rows:
        if r["status"] != "ok":
            lines.append(f"{r['arch']:<22} {r['shape']:<12} {r['status']:<8} "
                         f"{r.get('note', '')[:50]}")
            continue
        lines.append(
            f"{r['arch']:<22} {r['shape']:<12} {r['status']:<8} "
            f"{r['t_compute_s']:>9.4f} {r['t_memory_s']:>9.4f} "
            f"{r['t_collective_s']:>9.4f} {r['bottleneck']:<11} "
            f"{r['mfu']:>6.3f}")
    return "\n".join(lines)


if __name__ == "__main__":
    print(render(table(MESH)))
    print()
    print(json.dumps({k: v for k, v in run().items() if k != "rows"},
                     indent=1))
