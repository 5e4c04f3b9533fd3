"""How often ``torch.log`` on the CPU rounds a BEV density wrongly on its
first call in a process (ROADMAP C24).

Each of N fresh processes rasterizes the counts of bench.py's frame 0
(``make_batch`` seed 0, 65536 points) as ``ops/voxel.bev_maps_from_points``
does, then takes the density as the port once took it
(``log(counts + 1) * INV_LOG16``, its first ``torch.log``) and compares
it with the table the port reads now (``ops/voxel.DENSITY``, held to
jitted JAX by tests/test_torch_voxel_boundaries.py). Prints one JSON
line per process (cells that differ, the wrong values' logs) and a
summary line. CPU only:

    python probes/cpu_first_log.py [N]
"""
import json
import os
import subprocess
import sys

CHILD = r"""
import json, numpy as np, torch
from dodt_tpu_torch.config import cars_dt_tracking
from dodt_tpu_torch.data.synthetic_scan import make_batch
from dodt_tpu_torch.ops import voxel
cfg = cars_dt_tracking()
cfg.dataset.max_points = 65536
ku = cfg.dataset.kitti_utils
batch = make_batch(cfg, np.random.RandomState(0))
pts = torch.from_numpy(batch["points"][0, 0])
valid = torch.from_numpy(batch["points_valid"][0, 0])
gp = torch.from_numpy(batch["ground_plane"][0])
x, z = pts[:, 0], pts[:, 2]
ae = np.asarray(ku.area_extents, np.float32)
bg = ku.bev_generator
dot = voxel.plane_offset(pts, gp)
band = ((x > float(ae[0, 0])) & (x < float(ae[0, 1])) & (z > float(ae[2, 0]))
        & (z < float(ae[2, 1])) & (pts[:, 1] > float(ae[1, 0]))
        & (pts[:, 1] < float(ae[1, 1])) & valid & (dot >= bg.height_lo)
        & (dot < bg.height_hi))
inv = voxel.xla_reciprocal(ku.voxel_size)
xi = torch.clamp(torch.floor((x - float(ae[0, 0])) * inv).long(), 0, 799)
zi = torch.clamp(torch.floor((z - float(ae[2, 0])) * inv).long(), 0, 699)
cell = torch.where(band, (699 - zi) * 800 + xi, 700 * 800)
counts = voxel._scatter(700 * 800, cell, band.to(torch.float32), "sum")
logs = torch.log(counts + 1.0)
old = torch.where(counts > 0, torch.clamp(logs * voxel.INV_LOG16, max=1.0),
                  0.0)
new = torch.as_tensor(voxel.DENSITY)[torch.clamp(counts, max=15).long()]
bad = (old != new).nonzero().flatten()
print(json.dumps({"cells_apart": int(len(bad)),
                  "wrong_logs": sorted({(float(counts[i]) + 1,
                                         float(logs[i])) for i in bad[:50]})}))
"""


def main():
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 20
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root)
    apart = 0
    for _ in range(n):
        out = subprocess.run([sys.executable, "-c", CHILD], env=env,
                             capture_output=True, text=True, check=True)
        line = out.stdout.strip().splitlines()[-1]
        print(line, flush=True)
        apart += json.loads(line)["cells_apart"] > 0
    print(json.dumps({"processes": n, "processes_with_cells_apart": apart}))


if __name__ == "__main__":
    main()
