"""Device time of the full-width streaming keyframe (or, with the
argument ``pair``, of the monolithic pair forward, B = 1 couple), from a
torch.profiler trace: the union of the card's kernel, memcpy and memset
intervals over N_TRACED calls (static arm, after warm-up), per call,
with the count of device operations, beside the unprofiled wall time of
the same calls. It runs the port of the tree in the working directory,
so that two trees compare in one call, from each tree's root:

    python3 probes/keyframe_trace.py [pair]
    (cd build/parent && python3 ../../probes/keyframe_trace.py [pair])

Prints one JSON line; the chrome trace goes to chiprun_out/ when that
directory exists."""
import json
import os
import sys
import time

sys.path.insert(0, os.getcwd())
import torch  # noqa: E402

import chip_smoke  # noqa: E402

N_WARM, N_TRACED = 5, 10


def busy_ms(events):
    """Length of the union of [ts, ts + dur] over events, in ms."""
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in events)
    total, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            total += b - max(a, end)
            end = b
    return total / 1e3


def main():
    if not torch.cuda.is_available():
        print("keyframe_trace: no CUDA card", file=sys.stderr)
        return 1
    from dodt_tpu_torch.runtime.predictor import StreamingPredictor
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    cfg, model, batch = chip_smoke.full_width(dev)
    what = "pair_forward" if sys.argv[1:] == ["pair"] else "keyframe"
    if what == "pair_forward":
        tb = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}

        def call(i):
            model(tb)
    else:
        frames = chip_smoke.frames_of(batch)
        pred = StreamingPredictor(model)
        pred.push_keyframe(frames[0], fetch=False)

        def call(i):
            pred.push_keyframe(frames[i % 2], fetch=False)
    for i in range(N_WARM):
        call(i + 1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(N_TRACED):
        call(i)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / N_TRACED * 1e3
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for i in range(N_TRACED):
            call(i)
        torch.cuda.synchronize()
    out_dir = "chiprun_out" if os.path.isdir("chiprun_out") else \
        os.environ.get("TMPDIR", "/tmp")
    path = os.path.join(out_dir, f"{what}_trace_{os.getpid()}.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    dev_ev = [e for e in events if e.get("cat") in (
        "kernel", "gpu_memcpy", "gpu_memset") and "dur" in e]
    by_name = {}
    for e in dev_ev:
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + e["dur"] / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    print(json.dumps({
        "tree": os.getcwd(), "calls": N_TRACED, "what": what,
        f"device_busy_ms_per_{what}": busy_ms(dev_ev) / N_TRACED,
        f"device_ops_per_{what}": len(dev_ev) / N_TRACED,
        f"wall_ms_per_{what}_unprofiled": wall,
        f"top_device_ms_per_{what}": {k: v / N_TRACED for k, v in top},
        "card": torch.cuda.get_device_name(0)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
