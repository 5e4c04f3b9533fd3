"""Why does one process's train step at B = 2 part from the same two
couples computed one by one (chip_smoke.py's split_step) in the second
stage's losses, while the RPN's and the correlation's agree?

    python3 probes/batch_vs_split.py [--tree DIR] [--seeds 7 8 ...]

chip_smoke.py phase 17(b)'s reference steps on one card, TF32 off
(cars_dt_tracking at 65536 points, momentum, f32 towers, smoke_model's
seeded weights), for each seed's two couples (SmokeStream(cfg,
seed).next_batch(2); 17(b) takes seed 7): the B = 2 step
(launch.train_steps) against split_step, each loss's relative
difference, and proposal_swaps (per couple: the largest objectness
difference between the B = 2 train forward and the couple's own, and how
many of the post-NMS proposals sit at another position or are missing).
The port's package is imported from DIR (default: this checkout), so an
unpacked older tree runs the same comparison; chip_smoke.py is always
this checkout's. Prints one JSON line per seed.
"""
import argparse
import importlib.util
import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=HERE)
    ap.add_argument("--seeds", type=int, nargs="+",
                    default=[7, 8, 9, 10, 11, 12])
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.tree))
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)

    import dataclasses
    import torch
    import dodt_tpu_torch
    from dodt_tpu_torch.parallel import launch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    cfg = cs.mesh_cfg()
    cfg.train.optimizer = dataclasses.replace(cfg.train.optimizer,
                                              name="momentum")
    scfg, smodel = cs.f32_steps(cfg)
    # the first step pays for cuDNN's and cuBLAS's set-up
    launch.train_steps(scfg, smodel, [cs.SmokeStream(cfg, 7).next_batch(2)],
                       device=dev)
    for seed in args.seeds:
        batch = cs.SmokeStream(cfg, seed).next_batch(2)
        whole = launch.train_steps(scfg, smodel, [batch], device=dev)
        split = cs.split_step(scfg, smodel, batch, 2, dev)
        w, s = whole["losses"][0], split["losses"][0]
        rel = {k: abs(w[k] - s[k]) / max(abs(s[k]), 1e-7)
               for k in cs.LOSS_KEYS}
        print(json.dumps({
            "package": os.path.dirname(dodt_tpu_torch.__file__),
            "seed": seed, "rel": rel,
            "parts": any(v > 1e-3 for v in rel.values()),
            "swaps": cs.proposal_swaps(scfg, smodel, batch, 2, dev)}),
            flush=True)


if __name__ == "__main__":
    main()
