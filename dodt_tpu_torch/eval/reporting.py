"""Result aggregation/plotting (reference scripts/offline_eval/
plot_ap.py: parse per-checkpoint score tables, report top-5).

The port's copy of dodt_tpu/eval/reporting.py.
"""
from __future__ import annotations

import glob
import json
import os
from typing import Dict, List, Optional


def load_results(output_dir: str) -> List[Dict]:
    out = []
    for path in sorted(glob.glob(os.path.join(output_dir,
                                              "results_*.json"))):
        with open(path) as f:
            out.append(json.load(f))
    return sorted(out, key=lambda r: r["step"])


def top_checkpoints(results: List[Dict], metric: str = "AP_3D",
                    difficulty: str = "moderate", k: int = 5
                    ) -> List[Dict]:
    scored = [(r["ap"][metric][difficulty], r) for r in results
              if metric in r.get("ap", {})]
    scored.sort(key=lambda t: -t[0])
    return [{"step": r["step"], metric: s} for s, r in scored[:k]]


def load_train_metrics(path: str) -> List[Dict]:
    """Parse the Trainer's JSONL metrics trail (train_metrics.jsonl in
    the checkpoint dir); tolerates a truncated last line from a killed
    run."""
    out = []
    if not os.path.exists(path):
        return out
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                out.append(json.loads(line))
            except json.JSONDecodeError:
                continue   # mid-write kill can truncate the tail
    return sorted(out, key=lambda r: r["step"])


def _train_loss_at(train_metrics: List[Dict], step: int):
    """Latest logged train total loss at or before `step`."""
    best = None
    for rec in train_metrics:
        if rec["step"] <= step and "total" in rec:
            best = rec["total"]
    return best if best is not None else float("nan")


def format_table(results: List[Dict],
                 train_metrics: Optional[List[Dict]] = None) -> str:
    has_health = any("val_health" in r for r in results)
    hdr = "step    AP_3D(E/M/H)          AP_BEV(M)  AP_2D(M)  MOTA"
    if train_metrics:
        hdr += "    train_loss"
    if has_health:
        hdr += "    val_loss  recall@0.5"
    lines = [hdr]
    for r in results:
        ap3 = r["ap"]["AP_3D"]
        apb = r["ap"]["AP_BEV"]["moderate"]
        ap2 = r["ap"]["AP_2D"]["moderate"]
        mota = r.get("mot", {}).get("overall", {}).get("MOTA", float("nan"))
        row = (
            f"{r['step']:<7} {ap3['easy']:5.2f}/{ap3['moderate']:5.2f}/"
            f"{ap3['hard']:5.2f}      {apb:6.2f}    {ap2:6.2f}   "
            f"{mota:6.2f}")
        if train_metrics:
            row += f"   {_train_loss_at(train_metrics, r['step']):9.3f}"
        if has_health:
            vh = r.get("val_health", {})
            vl = vh.get("val_losses", {}).get("total", float("nan"))
            rec = vh.get("proposal_recall", {}).get("iou_0.5",
                                                    float("nan"))
            row += f"   {vl:7.3f}   {rec:9.3f}"
        lines.append(row)
    return "\n".join(lines)


def plot_ap(results: List[Dict], path: Optional[str] = None,
            metric: str = "AP_3D"):
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    steps = [r["step"] for r in results]
    fig, ax = plt.subplots()
    for diff in ("easy", "moderate", "hard"):
        ax.plot(steps, [r["ap"][metric][diff] for r in results],
                marker="o", label=diff)
    ax.set_xlabel("step")
    ax.set_ylabel(metric + " (%)")
    ax.legend()
    ax.grid(alpha=0.3)
    if path:
        fig.savefig(path, dpi=120, bbox_inches="tight")
        plt.close(fig)
        return path
    return fig
