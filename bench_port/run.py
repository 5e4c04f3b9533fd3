"""The benchmark of dodt_tpu_torch (the PyTorch and CUDA port) on NVIDIA
cards. One run of one cell of BENCHMARK.json:

    python3 bench_port/run.py --workload <cell> --seed <n> \
        --seconds <s> --trace <0|1>

from the root of a checkout. It builds the cell's configuration
(``configs/<config>.json``) with weights made on the card from the seed,
sets up and warms up the cell's traffic mix (``traffic/<mix>.json``,
driven by the entry it names, ``entries/<entry>.py``), measures for
``--seconds``, then compares what the timed path produced with the
plain reference (``reference/``, through the entry's ``check``) against
``limits/<cell>.json``, and prints one JSON line: with ``--trace 0`` the
cell's end-to-end metrics, with ``--trace 1`` its per-layer metrics,
each read by ``metrics/<name>.py`` from the run, its spans and its
trace. It exits with 2 and
prints no result without enough CUDA cards, or if the program loaded
JAX."""
import time

T_START = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "dodt_tpu")


def fixed_caches(root: str) -> None:
    """Kernel caches at fixed paths inside the checkout; no library the
    port uses may load JAX."""
    os.environ["TRITON_CACHE_DIR"] = os.path.join(root, "build", "triton")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def forbidden_modules():
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def power_limit() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"not read ({e})"


class Context:
    """What a driver needs: the cell's mix, the device, the program's
    model and configuration, the seed's generators and pools, and the
    hooks that mark the end of set-up and of the window."""

    def __init__(self, cell, seed, seconds, traced, device):
        from harness import inputs
        self.cell, self.seed, self.seconds = cell, seed, seconds
        self.traced, self.device = traced, device
        self.mix, self.config = cell.mix, cell.config
        self.rng = inputs.rng_for(seed, 0)
        self._frames = self._couples = None
        self.setup_at = self.setup_s = self.memory_peak = None

    @property
    def pipeline(self):
        return self.config["pipeline"]

    def frames(self):
        from harness import inputs
        if self._frames is None:
            d = self.pipeline["dataset"]
            self._frames = inputs.frame_pool(self.seed, self.mix,
                                             d["max_points"],
                                             tuple(d["image_shape"]))
        return self._frames

    def couples(self):
        from harness import inputs
        if self._couples is None:
            d = self.pipeline["dataset"]
            self._couples = inputs.couple_pool(
                self.seed, self.mix, d["max_points"],
                tuple(d["image_shape"]), d["max_gt_boxes"])
        return self._couples

    def setup_done(self, at=None):
        """Set-up ends now, or at the ``time.time()`` ``at`` where it
        ended in other processes (an entry's ranks)."""
        import gc
        import torch
        if at is None:
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            at = time.time()
        self.setup_at = at
        self.setup_s = at - T_START
        # what set-up made (pools, weights, the program's state) is not
        # scanned again by the collector in the window
        gc.collect()
        gc.freeze()

    def window_done(self, peak=None):
        """The window has closed; the device memory peak is this
        process's, or ``peak`` where the window ran in other processes."""
        import gc
        import torch
        gc.unfreeze()
        if peak is not None:
            self.memory_peak = peak
        elif self.device.type == "cuda":
            self.memory_peak = torch.cuda.max_memory_allocated(self.device)
        else:
            self.memory_peak = 0


class Readings:
    """What the metric readers read."""

    def __init__(self, cell, ctx, run, device_kind, flops):
        self.cell, self.run = cell, run
        self.config, self.pipeline = cell.config, cell.config["pipeline"]
        self.setup_s = ctx.setup_s
        self.device_kind = device_kind
        self.flops = flops

    def mean_span_ms(self, name):
        v = self.run.spans.get(name)
        return 1e3 * sum(v) / len(v) if v else None

    @property
    def mean_call_s(self):
        return self.run.window_s / self.run.calls


def measure(argv, device=None, root=ROOT):
    """One run; returns (result dict, lines for stderr) or raises
    SystemExit. ``device`` None takes the cards the cell asks for."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if args.seed < 0:
        raise SystemExit("--seed must be a whole number >= 0")
    fixed_caches(root)
    sys.path[:0] = [p for p in (root, HERE) if p not in sys.path]
    from harness.cells import load_cell, load_entry, load_metric
    cell = load_cell(root, args.workload)
    entry = load_entry(root, cell.mix["entry"])

    import torch
    if device is None:
        if not torch.cuda.is_available() or \
                torch.cuda.device_count() < cell.chips:
            print(f"run.py: the cell needs {cell.chips} CUDA card(s); torch "
                  f"finds {torch.cuda.device_count()}", file=sys.stderr)
            raise SystemExit(2)
        device = torch.device("cuda", 0)
    device = torch.device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    err = [f"card: {power_limit() if device.type == 'cuda' else 'none'}"]

    from harness import program
    from harness.weights import make_weights
    ctx = Context(cell, args.seed, args.seconds, bool(args.trace), device)
    ctx.program_cfg, model = program.build_model(json.dumps(ctx.pipeline),
                                                 cell.config, cell.family)
    weights = make_weights(
        [(n, p.shape) for n, p in model.named_parameters()], args.seed,
        device, cell.config["assumed"]["output_scales"])
    ctx.model = program.load(model, weights, device)
    del model
    run = entry.drive(ctx)
    del ctx.model       # the program's state goes before the reference runs
    if device.type == "cuda":
        torch.cuda.empty_cache()

    flops = [] if args.trace else None
    notes = []
    numbers = entry.check(ctx, run.captures, weights, flops=flops,
                          notes=notes)
    run.captures = None
    correct = all(math.isfinite(numbers.get(k, math.nan))
                  and numbers[k] <= lim for k, lim in cell.limits.items())

    readings = Readings(cell, ctx, run, kind, sum(flops) if flops else None)
    metrics = {}
    for m in cell.per_layer if args.trace else cell.end_to_end:
        value = load_metric(root, m["name"]).read(readings)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    result = {"correct": correct, "attempted": run.calls,
              "failed": run.failed, "metrics": metrics,
              "device": {"platform": "gpu" if device.type == "cuda"
                         else device.type, "kind": kind, "count": cell.chips,
                         "memory_peak_bytes": ctx.memory_peak}}
    if args.trace and run.trace is not None:
        result["device"]["busy_s"] = run.trace.busy_s
        result["device"]["window_s"] = run.trace.window_s
        result["breakdown"] = {"device_ops": run.trace.top_ops(10),
                               "idle_gaps": run.trace.top_gaps(10)}
    result["checks"] = {k: {"value": numbers.get(k), "limit": lim}
                        for k, lim in cell.limits.items()}
    err += [f"note: {n}" for n in notes]
    err += [f"check {k}: {numbers.get(k)!r} limit {lim!r}"
            for k, lim in cell.limits.items()]
    return result, err


def main(argv=None):
    result, err = measure(sys.argv[1:] if argv is None else argv)
    found = forbidden_modules()
    if found:
        print(f"run.py: the process loaded {found}", file=sys.stderr)
        return 2
    for line in err:
        print(line, file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
