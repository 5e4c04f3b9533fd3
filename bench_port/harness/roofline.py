"""Peaks of the card and the operations and bytes of the kernels whose
share of their roofline the benchmark reports.

A kernel's bound time is the larger of its operations over the peak rate
of its arithmetic and its bytes over the peak bandwidth, counting each
input byte read once and each output byte written once per launch.
Peaks: NVIDIA's H100 SXM data sheet, dense, at the full 700 W."""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

PEAKS = {
    "H100 80GB HBM3": {"bf16": 989e12, "f32": 67e12, "bytes": 3.35e12},
}


def peaks(kind: str) -> Optional[Dict[str, float]]:
    """The peak table of the card named ``kind``; None for a card not in
    the table (no share is then reported)."""
    for key, table in PEAKS.items():
        if key in kind:
            return table
    return None


def bound_s(flops: float, nbytes: float, flop_rate: float,
            byte_rate: float) -> float:
    return max(flops / flop_rate, nbytes / byte_rate)


# --------------------------------------------------------------- B1
# csrc/conv_chain.cu: one launch per 3x3 SAME conv + bias + ReLU stage,
# bf16 activations and weights, f32 bias and accumulation.

def conv3x3_flops(h: int, w: int, ci: int, co: int) -> float:
    return 2.0 * 9 * h * w * ci * co


def conv3x3_bytes(h: int, w: int, ci: int, co: int) -> float:
    return 2.0 * (h * w * ci + h * w * co + 9 * ci * co) + 4.0 * co


POOL_LEVEL = {"conv2": 1, "conv3": 2, "conv4": 3}
PREVIOUS = {"conv2": "conv1", "conv3": "conv2", "conv4": "conv3"}


def b1_launches(model_cfg: Dict, bev_hw: Tuple[int, int],
                image_hw: Tuple[int, int]) -> List[Tuple[int, int, int, int]]:
    """(h, w, ci, co) of every B1 launch of one frame's encode: the
    blocks of each tower named in ``fused_interior`` (towers without a
    norm), at the tower's input padded to a multiple of 8 and pooled
    down to the block's level."""
    out = []
    for tower, hw in (("bev_extractor", bev_hw), ("img_extractor", image_hw)):
        t = model_cfg[tower]
        if t.get("norm", "none") != "none":
            continue
        for block in t.get("fused_interior", ()):
            if block not in POOL_LEVEL:
                continue
            s = 2 ** POOL_LEVEL[block]
            h, w = -(-hw[0] // 8) * 8 // s, -(-hw[1] // 8) * 8 // s
            n, co = t[block]
            ci = t[PREVIOUS[block]][1]
            for _ in range(n):
                out.append((h, w, ci, co))
                ci = co
    return out


def b1_bound_s(launches, table: Dict[str, float]) -> float:
    return sum(bound_s(conv3x3_flops(*s), conv3x3_bytes(*s), table["bf16"],
                       table["bytes"]) for s in launches)


# --------------------------------------------------------------- B3
# csrc/correlation.cu: the mean over C channels of A times B displaced
# over a D x D grid, contracted with (D^2, Cb) weights, in f32.

def corr_bottleneck_flops(h: int, w: int, c: int, d2: int, cb: int
                          ) -> float:
    return float(h * w * d2 * (2 * c + 2 * cb))


def corr_bottleneck_bytes(h: int, w: int, c: int, d2: int, cb: int
                          ) -> float:
    return 4.0 * (2 * h * w * c + d2 * cb + h * w * cb)


def b3_bound_s(model_cfg: Dict, bev_hw: Tuple[int, int],
               table: Dict[str, float]) -> float:
    """One launch at the pair stage's shapes: the two frames' (H/2, W/2,
    C) BEV tower outputs (decode stride 2), D = 2 (max_displacement //
    stride_2) + 1, one bottleneck channel."""
    corr = model_cfg["correlation"]
    t = model_cfg["bev_extractor"]
    s = t.get("decode_stride", 2)
    h, w = bev_hw[0] // s, bev_hw[1] // s
    c = t["conv1"][1] if t.get("pyramid", True) else t["conv4"][1]
    d = 2 * (corr["max_displacement"] // corr["stride_2"]) + 1
    return bound_s(corr_bottleneck_flops(h, w, c, d * d, 1),
                   corr_bottleneck_bytes(h, w, c, d * d, 1), table["f32"],
                   table["bytes"])


def bev_shape(pipeline: Dict) -> Tuple[int, int]:
    """(H, W) of the BEV image: z rows, x columns (KittiUtilsConfig)."""
    ku = pipeline["dataset"]["kitti_utils"]
    (x0, x1), _, (z0, z1) = ku["area_extents"]
    return (int(round((z1 - z0) / ku["voxel_size"])),
            int(round((x1 - x0) / ku["voxel_size"])))


def share_of_bound(readings, kernel_name: str, bound_per_launch_s: float
                   ) -> Optional[float]:
    """100 x bound time over device time of the traced launches of
    ``kernel_name``; None where the trace holds none or no peak is
    known."""
    tr = readings.run.trace
    if tr is None or bound_per_launch_s is None:
        return None
    secs, launches = tr.kernel(kernel_name)
    if not launches or secs <= 0:
        return None
    return 100.0 * launches * bound_per_launch_s / secs


def idle_share(readings) -> Optional[float]:
    """100 x (1 - busy / window) of the traced stretch; None without a
    device operation in it."""
    tr = readings.run.trace
    if tr is None or tr.busy_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)


def mfu(readings) -> Optional[float]:
    """100 x the reference's FLOPs of one call over the window's mean
    call time x the card's dense bf16 peak, per chip."""
    table = peaks(readings.device_kind)
    if table is None or not readings.flops:
        return None
    return 100.0 * readings.flops / (readings.mean_call_s * table["bf16"])
