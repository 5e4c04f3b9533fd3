"""A quick first check of B1 and B3 on the card, for a new kernel's first
call: build the library, hold each kernel against its twin at the
main-path and a few odd shapes (B1 within 2e-2 of the range, B3 within
1e-4), and time B1 beside the cuDNN bf16 chain and B3, eagerly and in a
CUDA graph (CUDA events). From the repository root, on the card:

    python3 probes/kernels_quick.py

chip_smoke.py's phase 2 is the full check; this one takes about 20 s."""
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import torch  # noqa: E402

from dodt_tpu_torch.ops import _cuda  # noqa: E402
from dodt_tpu_torch.ops import conv_chain as cc  # noqa: E402
from dodt_tpu_torch.ops import correlation as corr  # noqa: E402

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
t0 = time.time()
lib, log = _cuda.build()
print("build s", time.time() - t0, flush=True)
for line in log.splitlines():
    if any(k in line for k in ("registers", "spill", "Compiling entry",
                               "error", "warning", "smem")):
        print(line)
dev = torch.device("cuda", 0)
g = torch.Generator().manual_seed(0)


def t_ms(fn, n=20):
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    s, e = torch.cuda.Event(True), torch.cuda.Event(True)
    s.record()
    for _ in range(n):
        fn()
    e.record()
    torch.cuda.synchronize()
    return s.elapsed_time(e) / n


def graph_ms(fn, n=20):
    """Device time per call: n calls captured in one CUDA graph."""
    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(s)
    torch.cuda.synchronize()
    gr = torch.cuda.CUDAGraph()
    with torch.cuda.graph(gr):
        for _ in range(n):
            fn()
    gr.replay()
    torch.cuda.synchronize()
    st, e = torch.cuda.Event(True), torch.cuda.Event(True)
    st.record()
    gr.replay()
    e.record()
    torch.cuda.synchronize()
    return st.elapsed_time(e) / n


fails = 0
for shape, chans in [((1, 88, 100, 128), (128, 256, 256, 256)),
                     ((1, 45, 150, 128), (128, 256, 256, 256)),
                     ((2, 88, 100, 128), (128, 256, 256, 256)),
                     ((1, 37, 53, 16), (16, 16)),
                     ((2, 13, 21, 40), (40, 72, 16))]:
    ws = [(torch.randn(co, ci, 3, 3, generator=g) / (9 * ci) ** 0.5).to(dev)
          for ci, co in zip(chans[:-1], chans[1:])]
    bs = [(0.1 * torch.randn(co, generator=g)).to(dev) for co in chans[1:]]
    x = torch.relu(torch.randn(shape, generator=g)).to(dev, torch.bfloat16)
    try:
        got = cc.conv_chain(x, ws, bs)
        torch.cuda.synchronize()
        want = cc.conv_chain_plain(x, ws, bs)
        e = float((got.float() - want.float()).abs().max())
        sc = float(want.float().abs().max())
        ok = e <= 2e-2 * sc
        fails += not ok
        print(f"B1 {shape} {chans}: err {e:.4g} scale {sc:.4g} ok {ok}",
              flush=True)
        if shape[1] >= 45:
            bw = [w_.to(torch.bfloat16) for w_ in ws]
            bb = [b_.to(torch.bfloat16) for b_ in bs]

            def cudnn():
                hh = x.permute(0, 3, 1, 2)
                for w_, b_ in zip(bw, bb):
                    hh = torch.relu(torch.nn.functional.conv2d(hh, w_, b_, padding=1))
                return hh
            print(f"   kernel {t_ms(lambda: cc.conv_chain(x, ws, bs)):.4f} ms"
                  f" cudnn {t_ms(cudnn):.4f} ms "
                  f"kernel {t_ms(lambda: cc.conv_chain(x, ws, bs)):.4f} ms")
            print(f"   graph: kernel {graph_ms(lambda: cc.conv_chain(x, ws, bs)):.4f} ms"
                  f" cudnn {graph_ms(cudnn):.4f} ms")
    except Exception as exc:  # noqa: BLE001
        fails += 1
        print(f"B1 {shape} FAILED: {exc!r}", flush=True)

for shape, md, s2, cb in [((1, 350, 400, 32), 5, 1, 1), ((2, 64, 96, 32), 5, 1, 4),
                          ((1, 240, 160, 16), 2, 1, 1), ((2, 61, 77, 8), 5, 2, 2),
                          ((1, 33, 47, 24), 5, 1, 3)]:
    a = torch.randn(shape, generator=g).to(dev)
    b = torch.randn(shape, generator=g).to(dev)
    d = 2 * (md // s2) + 1
    w = (torch.randn((d * d, cb), generator=g) / d).to(dev)
    try:
        got = corr.corr_bottleneck(a, b, w, md, s2)
        torch.cuda.synchronize()
        want = corr.corr_bottleneck_plain(a, b, w, md, s2)
        e = float((got - want).abs().max())
        sc = float(want.abs().max())
        ok = e <= 1e-4 * sc
        fails += not ok
        print(f"B3 {shape} md {md} s2 {s2} cb {cb}: err {e:.4g} scale "
              f"{sc:.4g} ok {ok}", flush=True)
        if shape[1] == 350:
            print(f"   kernel {t_ms(lambda: corr.corr_bottleneck(a, b, w, md, s2)):.4f} ms"
                  f" graph {graph_ms(lambda: corr.corr_bottleneck(a, b, w, md, s2)):.4f} ms")
    except Exception as exc:  # noqa: BLE001
        fails += 1
        print(f"B3 {shape} FAILED: {exc!r}", flush=True)
print("FAILS", fails)
sys.exit(1 if fails else 0)
