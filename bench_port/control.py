"""The control of the comparison that decides ``correct``: the
reference, computed with every contraction of the towers and heads in
float8 e4m3 (the step below the configuration's bfloat16), put in the
program's place and judged by ``harness/check.py`` against the float32
reference, at the cell's own sizes, on the cell's inputs and weights
from each seed. It must read not correct; its numbers set the upper
readings the limits lie below. The benchmark's runs do not run it.

    python3 bench_port/control.py --workload <cell> --seeds 11 12 13

prints one JSON line per seed with the numbers and their limits. With
``--precision float32 --fault <fault>`` the float32 reference in the
program's place carries a planted train-step fault instead:
``altered_loss`` (each step's losses reported 1.5 times what they are)
or ``unchanged`` (each step hands back the state it was given), and
for a data-parallel cell (a mix with a ``mesh``) ``half_batch`` (each
step's update and losses from the first half of its global batch) or
``no_exchange`` (from rank 0's rows alone, as a step whose ranks leave
out the all-reduce hands rank 0's state on). With
``--precision bfloat16`` the reference at the configuration's own
precision stands in the program's place: a witness of what that
rounding alone moves, which sets no limit. The
entry of the cell's mix (``entries/<entry>.py``) makes the control's
captures (``control``) and compares them (``check``)."""
import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--precision", default="float8",
                    choices=("float8", "float32", "bfloat16"))
    ap.add_argument("--fault", default="none",
                    choices=("none", "altered_loss", "unchanged",
                             "half_batch", "no_exchange"))
    args = ap.parse_args(argv)
    sys.path[:0] = [ROOT, HERE]
    import run
    run.fixed_caches(ROOT)
    import torch
    from harness import check
    from harness.cells import load_cell, load_entry
    from harness.weights import make_weights
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cell = load_cell(ROOT, args.workload)
    entry = load_entry(ROOT, cell.mix["entry"])
    device = torch.device(args.device)
    rows = {}
    if args.fault in ("half_batch", "no_exchange"):
        if "mesh" not in cell.mix:
            raise SystemExit(f"--fault {args.fault}: {cell.name} runs no "
                             "mesh")
        bs = cell.mix["batch_size"]
        rows["rows"] = (bs // 2 if args.fault == "half_batch"
                        else bs // cell.mix["mesh"][0])
    for seed in args.seeds:
        ctx = run.Context(cell, seed, 0, False, device)
        from reference.config import PipelineConfig
        rcfg = PipelineConfig.from_json(json.dumps(cell.config["pipeline"]))
        shapes = [(n, p.shape) for n, p in cell.family.reference(
            rcfg, cell.config).named_parameters()]
        weights = make_weights(shapes, seed, device,
                               cell.config["assumed"]["output_scales"])
        cfg, net = check.reference(cell.config, weights, device,
                                   args.precision, cell.family)
        caps = entry.control(ctx, cfg, net, device, **rows)
        del net
        for c in caps:
            if args.fault == "altered_loss":
                c["losses"] = {k: 1.5 * v for k, v in c["losses"].items()}
            elif args.fault == "unchanged":
                c["before"] = c["after"] = caps[0]["before"]
        notes = []
        numbers = entry.check(ctx, caps, weights, notes=notes)
        for n in notes:
            print(f"note: seed {seed}: {n}", file=sys.stderr)
        correct = all(numbers.get(k_) is not None and numbers[k_] <= lim
                      for k_, lim in cell.limits.items())
        print(json.dumps({"workload": cell.name, "seed": seed,
                          "precision": args.precision, "fault": args.fault,
                          "control_correct": correct, "numbers": numbers,
                          "limits": cell.limits}), flush=True)


if __name__ == "__main__":
    main()
