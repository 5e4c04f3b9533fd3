"""Synthetic KITTI-format fixture generator.

The reference ships a miniature real-KITTI fixture for tests
(avod/tests/datasets/Kitti). We generate an equivalent fixture
synthetically and deterministically: a few tracking videos of cars
moving on a ground plane, with lidar points sampled on box surfaces and
the ground, full KITTI file layout (velodyne .bin, image_02 .png,
calib, label_02, oxts, planes). This exercises every reader/transform
with data we fully control (known motion -> known correlation offsets).

The port's copy of dodt_tpu/data/synthetic.py.
"""
from __future__ import annotations

import os

import numpy as np

# camera intrinsics for the fixture
_F, _CX, _CY = 721.5, 609.5, 172.8
_IMG_W, _IMG_H = 1242, 375
# velo (x fwd, y left, z up) -> cam (x right, y down, z fwd)
_R_VELO_TO_CAM = np.array([[0.0, -1.0, 0.0],
                           [0.0, 0.0, -1.0],
                           [1.0, 0.0, 0.0]], np.float32)
_T_VELO_TO_CAM = np.array([0.0, -0.08, -0.27], np.float32)
GROUND_Y = 1.65


def _calib_text() -> str:
    p2 = np.zeros((3, 4))
    p2[0, 0] = p2[1, 1] = _F
    p2[0, 2], p2[1, 2], p2[2, 2] = _CX, _CY, 1.0
    tr = np.hstack([_R_VELO_TO_CAM, _T_VELO_TO_CAM[:, None]])
    r0 = np.eye(3)

    def row(name, mat):
        return name + ": " + " ".join(f"{v:.12e}" for v in mat.ravel())

    lines = [row("P0", p2), row("P1", p2), row("P2", p2), row("P3", p2),
             row("R_rect", r0), row("Tr_velo_cam", tr),
             row("Tr_imu_velo", np.hstack([np.eye(3), np.zeros((3, 1))]))]
    return "\n".join(lines) + "\n"


def _cam_to_velo(pts_cam: np.ndarray) -> np.ndarray:
    return (np.linalg.inv(_R_VELO_TO_CAM) @ (pts_cam - _T_VELO_TO_CAM).T).T


def _box_surface_points(box_3d, rng, n=256):
    """Sample points on the visible surfaces of a car box (cam frame)."""
    x, y, z, l, w, h, ry = box_3d
    u = rng.uniform(-0.5, 0.5, (n, 2))
    face = rng.randint(0, 4, n)
    px = np.where(face == 0, u[:, 0] * l, np.where(
        face == 1, -l / 2, np.where(face == 2, l / 2, u[:, 0] * l)))
    pz = np.where(face == 0, -w / 2, np.where(
        face == 1, u[:, 0] * w, np.where(face == 2, u[:, 0] * w, w / 2)))
    py = -(u[:, 1] + 0.5) * h  # 0 at bottom to -h at top
    c, s = np.cos(ry), np.sin(ry)
    rx = c * px + s * pz
    rz = -s * px + c * pz
    return np.stack([rx + x, py + y, rz + z], axis=1)


def _project(pts_cam):
    uv = np.stack([
        _F * pts_cam[:, 0] / pts_cam[:, 2] + _CX,
        _F * pts_cam[:, 1] / pts_cam[:, 2] + _CY], axis=1)
    return uv


# ---------------------------------------------------------------------------
# Beam-scan backend (scan="beam"): raycast 64-beam velodyne model
# ---------------------------------------------------------------------------
# The box-surface point model paints a fixed number of points per object
# regardless of range and never occludes anything — statistics a real
# 64-beam scan does not have (r4 transfer experiment: zero-shot recall
# 0.37 on real clips, pretrain HURT vs scratch). This backend samples
# points the way the sensor does: one ray per (beam elevation, azimuth
# step), each returning the NEAREST hit among object boxes / clutter /
# ground — so near objects are dense, far objects sparse, and occluded
# surfaces are absent, matching the density profile bench.py's
# velodyne_like_points models statistically.

_BEAMS = 64
_ELEV_LO, _ELEV_HI = -24.8, 2.0       # HDL-64E vertical FOV (deg)
_AZ_FOV = 40.0                        # half-angle swept (deg), ~cam FOV
_AZ_STEP = 0.18                       # deg per firing (~0.08 real; coarser
                                      # keeps frames near max_points)
_MAX_RANGE = 79.0


def _ray_box_t(origins_zero, dirs, box_3d):
    """Smallest positive ray parameter t where rays (origin 0, unit
    `dirs` (R,3) cam frame) enter the 3D box, +inf where they miss.
    Box y spans [y-h, y] (KITTI: y is the bottom face)."""
    x, y, z, l, w, h, ry = [float(v) for v in box_3d]
    c, s = np.cos(ry), np.sin(ry)
    # cam -> box frame: rotate by -ry about y, after centering
    ox, oy, oz = -x, -(y - h / 2.0), -z          # ray origin, centered
    o_b = np.array([c * ox - s * oz, oy, s * ox + c * oz])
    d_b = np.stack([c * dirs[:, 0] - s * dirs[:, 2],
                    dirs[:, 1],
                    s * dirs[:, 0] + c * dirs[:, 2]], axis=1)
    half = np.array([l / 2.0, h / 2.0, w / 2.0])
    with np.errstate(divide="ignore", invalid="ignore"):
        t1 = (-half - o_b) / d_b
        t2 = (half - o_b) / d_b
    tmin = np.nanmax(np.minimum(t1, t2), axis=1)
    tmax = np.nanmin(np.maximum(t1, t2), axis=1)
    hit = (tmax >= np.maximum(tmin, 1e-3))
    return np.where(hit, np.maximum(tmin, 1e-3), np.inf)


def _beam_scan(boxes_cam, rng, clutter_objs):
    """Raycast scan in the camera frame. `boxes_cam`: list of box_3d
    arrays; `clutter_objs`: list of (box_3d-like) static structures
    (poles/walls) that occlude and return like objects. Returns (N, 3)
    cam-frame points."""
    elev = np.radians(np.linspace(_ELEV_LO, _ELEV_HI, _BEAMS))
    az = np.radians(np.arange(-_AZ_FOV, _AZ_FOV, _AZ_STEP))
    # per-beam azimuth jitter (real scans: beams are not phase-aligned)
    az = az[None, :] + rng.uniform(0, np.radians(_AZ_STEP), (_BEAMS, 1))
    el = np.broadcast_to(elev[:, None], az.shape)
    dirs = np.stack([np.cos(el) * np.sin(az),     # x right
                     np.sin(-el),                 # y down (+y = ground)
                     np.cos(el) * np.cos(az)],    # z forward
                    axis=-1).reshape(-1, 3)
    R = len(dirs)
    t_best = np.full(R, np.inf)
    # ground plane y = GROUND_Y (sensor at origin)
    dy = dirs[:, 1]
    with np.errstate(divide="ignore"):
        t_g = np.where(dy > 1e-4, GROUND_Y / dy, np.inf)
    t_best = np.minimum(t_best, t_g)
    for box in list(boxes_cam) + list(clutter_objs):
        t_best = np.minimum(t_best, _ray_box_t(None, dirs, box))
    keep = t_best < _MAX_RANGE
    # reflectivity dropout: ~8% of returns are lost
    keep &= rng.rand(R) > 0.08
    t = t_best[keep] * (1.0 + rng.normal(0, 0.004, keep.sum()))
    return dirs[keep] * t[:, None]


def _make_clutter(rng, n_structs=14):
    """Static vertical structures (poles, walls, bushes) as boxes in
    the frame-0 camera frame; they ride ego motion like labels do."""
    objs = []
    for _ in range(n_structs):
        cx = rng.uniform(-35, 35)
        cz = rng.uniform(8, 75)
        if abs(cx) < 5.0:          # keep the road corridor clear
            cx = np.sign(cx or 1.0) * rng.uniform(6, 35)
        kind = rng.randint(3)
        if kind == 0:      # pole
            l, w, h = 0.3, 0.3, rng.uniform(3, 6)
        elif kind == 1:    # wall / facade segment
            l, w, h = rng.uniform(4, 12), 0.4, rng.uniform(2.5, 5)
        else:              # bush / parked clutter
            l, w, h = rng.uniform(1, 3), rng.uniform(1, 2), \
                rng.uniform(0.8, 1.6)
        ry = rng.uniform(-np.pi, np.pi)
        objs.append(np.array([cx, GROUND_Y, cz, l, w, h, ry],
                             np.float32))
    return objs


# per-class dims (l, w, h ranges), speed scale and point-count scale
# for the synthetic objects
_CLASS_SPECS = {
    "Car": dict(l=(3.4, 4.4), w=(1.5, 1.8), h=(1.4, 1.7),
                speed=1.0, pts=1.0),
    "Pedestrian": dict(l=(0.5, 0.9), w=(0.5, 0.8), h=(1.6, 1.9),
                       speed=0.2, pts=0.5),
    "Cyclist": dict(l=(1.5, 1.9), w=(0.4, 0.7), h=(1.5, 1.8),
                    speed=0.6, pts=0.5),
}


class SyntheticScene:
    """Deterministic multi-frame scene of moving objects (cars by
    default; pass `object_classes` for pedestrian/cyclist scenes)."""

    def __init__(self, video_id: int, num_frames: int = 8,
                 num_cars: int = 4, seed: int = 0,
                 ego_speed: float = 0.0, points_per_car: int = 384,
                 ground_points: int = 3000,
                 object_classes=("Car",),
                 keep_in_view: bool = True,
                 z_range=(7.0, 60.0), fov_frac: float = 0.75,
                 scan: str = "surface",
                 render_images: bool = False):
        """With `keep_in_view` (default), object trajectories are
        resampled until every frame's camera-coordinate position stays
        inside z_range and |x| <= fov_frac * z — i.e. every GT is
        detectable (lidar survives the image-FOV filter, the box is in
        the BEV area) and the official 11-point AP ceiling is 100
        rather than the 9/11 = 81.82 an out-of-view GT imposes.
        `keep_in_view=False` restores unconstrained placement (used by
        the border/offset tests that NEED objects leaving the area).

        `scan`: "surface" (default — fixed points painted on box faces
        + uniform ground; byte-stable for the golden tests) or "beam"
        (raycast 64-beam velodyne model: range-dependent density,
        occlusion, static clutter — the realistic backend the transfer
        flow pretrains on). `render_images` shades the projected boxes,
        ground and clutter into the camera image instead of the flat
        gray card, so the image tower trains on non-degenerate input."""
        self.points_per_car = points_per_car
        self.ground_points = ground_points
        self.scan = scan
        self.render_images = render_images
        rng = np.random.RandomState(seed * 100 + video_id)
        self.video_id = video_id
        self.num_frames = num_frames
        self.ego_speed = ego_speed
        self.cars = []
        for cid in range(num_cars):
            cls = object_classes[cid % len(object_classes)]
            spec = _CLASS_SPECS[cls]
            for _attempt in range(500):
                x0 = rng.uniform(-8, 8)
                z0 = rng.uniform(8, 40)
                vx = rng.uniform(-0.4, 0.4) * spec["speed"]
                vz = rng.uniform(-0.8, 0.8) * spec["speed"]
                if not keep_in_view:
                    break
                f = np.arange(num_frames)
                x = x0 + vx * f
                z = z0 + vz * f - ego_speed * f
                if not ((z >= z_range[0]).all()
                        and (z <= z_range[1]).all()
                        and (np.abs(x) <= fov_frac * z).all()):
                    continue
                # no physical overlap with already-placed objects at
                # ANY frame (overlapping GT is unphysical and gets
                # NMS-suppressed, silently capping detection recall)
                wx = x0 + vx * f          # world coords (frame-0 cam)
                wz = z0 + vz * f
                clear = True
                for other in self.cars:
                    ox = other["x0"] + other["vx"] * f
                    oz = other["z0"] + other["vz"] * f
                    min_sep = (max(spec["l"]) + max(
                        _CLASS_SPECS[other["cls"]]["l"])) / 2.0 + 0.4
                    d = np.hypot(wx - ox, wz - oz)
                    if (d < min_sep).any():
                        clear = False
                        break
                if clear:
                    break
            else:
                raise ValueError(
                    "could not place an in-view non-overlapping "
                    "trajectory; reduce ego_speed * num_frames, "
                    "num_cars, or widen z_range")
            ry = rng.uniform(-np.pi, np.pi)
            dims = (rng.uniform(*spec["l"]), rng.uniform(*spec["w"]),
                    rng.uniform(*spec["h"]))
            self.cars.append(dict(id=cid, x0=x0, z0=z0, vx=vx, vz=vz,
                                  ry=ry, dims=dims, cls=cls,
                                  n_pts=max(32, int(points_per_car
                                                    * spec["pts"]))))
        # static world clutter for the beam backend (and the rendered
        # images); lives in the frame-0 camera frame like `boxes_at`
        self.clutter = _make_clutter(rng) if (scan == "beam"
                                              or render_images) else []
        self.rng = rng

    def boxes_at(self, frame: int) -> list:
        """World-frame (= frame-0 camera frame) boxes per car."""
        out = []
        for car in self.cars:
            x = car["x0"] + car["vx"] * frame
            z = car["z0"] + car["vz"] * frame
            l, w, h = car["dims"]
            out.append((car["id"], np.array(
                [x, GROUND_Y, z, l, w, h, car["ry"]], np.float32)))
        return out

    def ego_offset(self, frame: int) -> float:
        """Ego forward (z) displacement of the camera at `frame`."""
        return self.ego_speed * frame

    def camera_boxes_at(self, frame: int) -> list:
        """Boxes in the frame's own camera coordinates."""
        dz = self.ego_offset(frame)
        out = []
        for cid, box in self.boxes_at(frame):
            b = box.copy()
            b[2] -= dz
            if b[2] > 4.0:     # keep only boxes in front of the camera
                out.append((cid, b))
        return out

    def clutter_at(self, frame: int) -> list:
        """Static clutter boxes in the frame's camera coordinates."""
        dz = self.ego_offset(frame)
        out = []
        for box in self.clutter:
            b = box.copy()
            b[2] -= dz
            if b[2] > 2.0:
                out.append(b)
        return out

    def point_cloud_at(self, frame: int, n_ground: int | None = None):
        """(N, 4) velo-frame points for the frame."""
        rng = np.random.RandomState(1000 + self.video_id * 100 + frame)
        if self.scan == "beam":
            boxes = [b for _, b in self.camera_boxes_at(frame)]
            pts_cam = _beam_scan(boxes, rng, self.clutter_at(frame))
            pts_velo = _cam_to_velo(pts_cam.astype(np.float32))
            intensity = rng.uniform(
                0, 1, (len(pts_velo), 1)).astype(np.float32)
            return np.hstack([pts_velo, intensity]).astype(np.float32)
        n_ground = n_ground or self.ground_points
        pts = []
        gx = rng.uniform(-30, 30, n_ground)
        gz = rng.uniform(5, 69, n_ground)
        gy = np.full(n_ground, GROUND_Y) + rng.normal(0, 0.02, n_ground)
        pts.append(np.stack([gx, gy, gz], axis=1))
        n_by_id = {c["id"]: c["n_pts"] for c in self.cars}
        for cid, box in self.camera_boxes_at(frame):
            pts.append(_box_surface_points(box, rng, n_by_id[cid]))
        pts_cam = np.concatenate(pts).astype(np.float32)
        pts_velo = _cam_to_velo(pts_cam)
        intensity = rng.uniform(0, 1, (len(pts_velo), 1)).astype(np.float32)
        return np.hstack([pts_velo, intensity]).astype(np.float32)

    def image_at(self, frame: int) -> np.ndarray:
        """(H, W, 3) uint8 camera image. Flat gray card by default
        (byte-stable goldens); with `render_images`, a painter's-
        algorithm shading of sky gradient, noisy ground, clutter and
        the cars' projected box hulls — non-degenerate input for the
        image tower so its features can transfer to real photos."""
        if not self.render_images:
            return np.full((_IMG_H, _IMG_W, 3), 96, np.uint8)
        import cv2

        rng = np.random.RandomState(7000 + self.video_id * 100 + frame)
        img = np.zeros((_IMG_H, _IMG_W, 3), np.float32)
        # sky gradient down to the horizon row (projection of z -> inf
        # on the ground: v = _CY), then ground shading below
        horizon = int(_CY)
        v = np.arange(_IMG_H, dtype=np.float32)[:, None, None]
        sky = 150.0 + 60.0 * (1.0 - v / max(horizon, 1))
        ground = 80.0 + 25.0 * (v - horizon) / max(_IMG_H - horizon, 1)
        img += np.where(v < horizon, sky, ground)
        from dodt_tpu_torch.utils.np_iou import box_3d_corners

        # painter's algorithm over clutter + cars, far to near
        drawables = []
        for box in self.clutter_at(frame):
            drawables.append((float(box[2]), box,
                              rng.uniform(60, 140, 3)))
        for _cid, box in self.camera_boxes_at(frame):
            drawables.append((float(box[2]), box,
                              rng.uniform(30, 220, 3)))
        for depth, box, shade in sorted(drawables, key=lambda d: -d[0]):
            corners = box_3d_corners(box)
            if (corners[:, 2] <= 0.5).any():
                continue
            uv = _project(corners).astype(np.int32)
            hull = cv2.convexHull(uv.reshape(-1, 1, 2))
            # range-attenuated shade + darker lower half (shadow side)
            att = np.clip(1.0 - depth / 120.0, 0.3, 1.0)
            cv2.fillConvexPoly(img, hull, (shade * att).tolist())
            lo = uv[:, 1].max()
            cv2.line(img, tuple(uv[uv[:, 1].argmax()]),
                     (int(uv[:, 0].mean()), int(lo)),
                     (shade * att * 0.6).tolist(), 2)
        img += rng.normal(0, 6.0, img.shape)
        return np.clip(img, 0, 255).astype(np.uint8)

    def label_lines(self) -> list:
        lines = []
        cls_by_id = {c["id"]: c["cls"] for c in self.cars}
        for frame in range(self.num_frames):
            for cid, box in self.camera_boxes_at(frame):
                x, y, z, l, w, h, ry = box
                # project corners for the 2D bbox
                from dodt_tpu_torch.utils.np_iou import box_3d_corners
                corners = box_3d_corners(box)
                uv = _project(corners)
                x1, y1 = uv.min(0)
                x2, y2 = uv.max(0)
                x1, x2 = np.clip([x1, x2], 0, _IMG_W)
                y1, y2 = np.clip([y1, y2], 0, _IMG_H)
                alpha = ry - np.arctan2(x, z)
                lines.append(
                    f"{frame} {cid} {cls_by_id[cid]} 0.00 0 {alpha:.2f} "
                    f"{x1:.2f} {y1:.2f} {x2:.2f} {y2:.2f} "
                    f"{h:.2f} {w:.2f} {l:.2f} {x:.2f} {y:.2f} {z:.2f} "
                    f"{ry:.2f}")
        return lines

    def oxts_lines(self) -> list:
        """Ego drives straight +z (cam) = +x (velo) = east (yaw 0)."""
        lines = []
        r_earth = 6378137.0
        for frame in range(self.num_frames):
            dist = self.ego_offset(frame)
            # eastward: longitude increases; latitude fixed at equator
            lon = np.rad2deg(dist / r_earth)
            vals = [0.0, lon, 0.0, 0.0, 0.0, 0.0] + [0.0] * 24
            lines.append(" ".join(f"{v:.12f}" for v in vals))
        return lines


def write_tracking_fixture(root: str, num_videos: int = 2,
                           num_frames: int = 8, seed: int = 0,
                           ego_speed: float = 0.0,
                           num_cars: int = 4,
                           points_per_car: int = 384,
                           ground_points: int = 3000,
                           object_classes=("Car",),
                           keep_in_view: bool = True,
                           z_range=(7.0, 60.0),
                           scan: str = "surface",
                           render_images: bool = False,
                           video_specs=None) -> str:
    """Write a synthetic KITTI tracking dataset under `root`.

    Layout: root/training/{velodyne,image_02,calib,label_02,oxts,planes}
    plus root/train.txt & root/val.txt split files in the reference's
    grouped `VV/FFFF`-lines-per-video format.

    `video_specs`: optional list of per-video overrides of the scene
    knobs (num_cars / points_per_car / ego_speed / z_range / ...), so
    one fixture can hold a DIVERSE set of scenes — the synthetic
    pretraining corpus for the transfer flow varies scene statistics
    per video this way.
    """
    import cv2

    base = os.path.join(root, "training")
    scenes = []
    split_groups = []
    for vid in range(num_videos):
        knobs = dict(num_cars=num_cars, ego_speed=ego_speed,
                     points_per_car=points_per_car,
                     ground_points=ground_points,
                     object_classes=object_classes,
                     keep_in_view=keep_in_view, z_range=z_range,
                     scan=scan, render_images=render_images)
        if video_specs:
            knobs.update(video_specs[vid % len(video_specs)])
        scene = SyntheticScene(vid, num_frames, seed=seed, **knobs)
        scenes.append(scene)
        vdir = os.path.join(base, "velodyne", f"{vid:04d}")
        idir = os.path.join(base, "image_02", f"{vid:04d}")
        pdir = os.path.join(base, "planes", f"{vid:04d}")
        os.makedirs(vdir, exist_ok=True)
        os.makedirs(idir, exist_ok=True)
        os.makedirs(pdir, exist_ok=True)
        os.makedirs(os.path.join(base, "calib"), exist_ok=True)
        os.makedirs(os.path.join(base, "label_02"), exist_ok=True)
        os.makedirs(os.path.join(base, "oxts"), exist_ok=True)

        group = []
        for frame in range(num_frames):
            scene.point_cloud_at(frame).tofile(
                os.path.join(vdir, f"{frame:06d}.bin"))
            cv2.imwrite(os.path.join(idir, f"{frame:06d}.png"),
                        scene.image_at(frame))
            with open(os.path.join(pdir, f"{frame:06d}.txt"), "w") as f:
                f.write("# Plane\nWidth 4\nHeight 1\n"
                        f"0.0 -1.0 0.0 {GROUND_Y}\n")
            group.append(f"{vid:04d}/{frame:06d}")
        split_groups.append("\n".join(group))

        with open(os.path.join(base, "calib", f"{vid:04d}.txt"), "w") as f:
            f.write(_calib_text())
        with open(os.path.join(base, "label_02", f"{vid:04d}.txt"),
                  "w") as f:
            f.write("\n".join(scene.label_lines()) + "\n")
        with open(os.path.join(base, "oxts", f"{vid:04d}.txt"), "w") as f:
            f.write("\n".join(scene.oxts_lines()) + "\n")

    split_text = "\n\n".join(split_groups) + "\n"
    for split in ("train", "val", "trainval", "test"):
        with open(os.path.join(root, split + ".txt"), "w") as f:
            f.write(split_text)
    return root


def write_detection_fixture(root: str, num_frames: int = 6,
                            seed: int = 0, num_scenes: int = 1,
                            num_cars: int = 4,
                            points_per_car: int = 384,
                            ground_points: int = 3000,
                            scan: str = "surface",
                            render_images: bool = False,
                            images: bool = True) -> str:
    """Write a synthetic single-frame KITTI *object* dataset under
    `root` (velodyne/image_2/calib/label_2/planes + split txts).
    `images=False` leaves out image_2 and its PNGs (and needs no cv2),
    for a reader that serves the camera images itself
    (`KittiDataset._camera_image`).

    `num_scenes` independent scenes each contribute `num_frames`
    samples; the scene-statistics knobs (`num_cars`,
    `points_per_car`, `ground_points`) mirror
    `write_tracking_fixture` so a single-frame pretrain set can be
    parameter-matched to a tracking fixture (the reference's staged
    flow pretrains the detector on the SAME data distribution the DT
    stage sees, trainer.py:64-183 — a mismatched pretrain caps the
    transferred AP)."""
    base = os.path.join(root, "training")
    for sub in ("velodyne", "image_2", "calib", "label_2", "planes"):
        if images or sub != "image_2":
            os.makedirs(os.path.join(base, sub), exist_ok=True)

    names = []
    for sid in range(num_scenes):
        scene = SyntheticScene(sid, num_frames, seed=seed + sid,
                               ego_speed=0.0, num_cars=num_cars,
                               points_per_car=points_per_car,
                               ground_points=ground_points,
                               scan=scan, render_images=render_images)
        _write_detection_scene(base, scene, num_frames,
                               sid * num_frames, names, images)

    for split in ("train", "val", "trainval", "test"):
        with open(os.path.join(root, split + ".txt"), "w") as f:
            f.write("\n".join(names) + "\n")
    return root


def _write_detection_scene(base, scene, num_frames, name_offset,
                           names, images=True):
    for frame in range(num_frames):
        name = f"{name_offset + frame:06d}"
        names.append(name)
        scene.point_cloud_at(frame).tofile(
            os.path.join(base, "velodyne", name + ".bin"))
        if images:
            import cv2
            cv2.imwrite(os.path.join(base, "image_2", name + ".png"),
                        scene.image_at(frame))
        with open(os.path.join(base, "calib", name + ".txt"), "w") as f:
            f.write(_calib_text())
        with open(os.path.join(base, "planes", name + ".txt"), "w") as f:
            f.write("# Plane\nWidth 4\nHeight 1\n"
                    f"0.0 -1.0 0.0 {GROUND_Y}\n")
        with open(os.path.join(base, "label_2", name + ".txt"),
                  "w") as f:
            f.write("\n".join(detection_label_lines(scene, frame)) + "\n")


def detection_label_lines(scene, frame: int) -> list:
    """One frame's single-frame KITTI object labels (no frame or track
    columns)."""
    from dodt_tpu_torch.utils.np_iou import box_3d_corners
    lines = []
    for cid, box in scene.camera_boxes_at(frame):
        x, y, z, l, w, h, ry = box
        uv = _project(box_3d_corners(box))
        x1, y1 = uv.min(0)
        x2, y2 = uv.max(0)
        x1, x2 = np.clip([x1, x2], 0, _IMG_W)
        y1, y2 = np.clip([y1, y2], 0, _IMG_H)
        alpha = ry - np.arctan2(x, z)
        lines.append(
            f"Car 0.00 0 {alpha:.2f} {x1:.2f} {y1:.2f} {x2:.2f} "
            f"{y2:.2f} {h:.2f} {w:.2f} {l:.2f} {x:.2f} {y:.2f} "
            f"{z:.2f} {ry:.2f}")
    return lines
