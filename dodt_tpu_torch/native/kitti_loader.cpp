// Native KITTI host-side loader: velodyne .bin read + rect-frame
// transform + image-FOV filter + ego-motion compensation, in one pass
// (the port's copy of dodt_tpu/native/kitti_loader.cpp).
//
// This is the hot host path of the input pipeline (the reference does
// it in numpy per sample: calib_utils.read_lidar:441,
// lidar_to_cam_frame:484, get_lidar_in_camera_view:117,
// point_cloud_transform kitti_tracking_dataset.py:324). ctypes releases
// the GIL during the call, so Python worker threads scale.
//
// C ABI:
//   int load_velodyne_cam(path, velo_to_rect(3x4 row-major),
//                         p2(3x4), img_h, img_w,
//                         ego_trans(3) or NULL, ego_rot(3x3) or NULL,
//                         out_xyz(cap*3 float32), capacity)
// Returns the number of points written, or -1 on IO error.
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>

extern "C" {

int load_velodyne_cam(const char* path, const double* velo_to_rect,
                      const double* p2, int img_h, int img_w,
                      const double* ego_trans, const double* ego_rot,
                      float* out_xyz, int capacity) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  std::fseek(f, 0, SEEK_END);
  long bytes = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  long n = bytes / (4 * sizeof(float));
  std::vector<float> raw(n * 4);
  size_t rd = std::fread(raw.data(), sizeof(float), n * 4, f);
  std::fclose(f);
  if (rd != size_t(n * 4)) return -1;

  const double* m = velo_to_rect;
  int count = 0;
  for (long i = 0; i < n && count < capacity; ++i) {
    double x = raw[i * 4 + 0];
    double y = raw[i * 4 + 1];
    double z = raw[i * 4 + 2];
    // optional ego-motion compensation in velo frame:
    // p' = (p + t) @ R  (row-vector convention, see
    // kitti.transform_points_to_prev_frame)
    if (ego_trans && ego_rot) {
      double px = x + ego_trans[0];
      double py = y + ego_trans[1];
      double pz = z + ego_trans[2];
      x = px * ego_rot[0] + py * ego_rot[3] + pz * ego_rot[6];
      y = px * ego_rot[1] + py * ego_rot[4] + pz * ego_rot[7];
      z = px * ego_rot[2] + py * ego_rot[5] + pz * ego_rot[8];
    }
    double cx = m[0] * x + m[1] * y + m[2] * z + m[3];
    double cy = m[4] * x + m[5] * y + m[6] * z + m[7];
    double cz = m[8] * x + m[9] * y + m[10] * z + m[11];
    if (cz <= 0.0) continue;
    double u = (p2[0] * cx + p2[1] * cy + p2[2] * cz + p2[3]) / cz;
    double v = (p2[4] * cx + p2[5] * cy + p2[6] * cz + p2[7]) / cz;
    if (u < 0 || u > img_w - 1 || v < 0 || v > img_h - 1) continue;
    out_xyz[count * 3 + 0] = float(cx);
    out_xyz[count * 3 + 1] = float(cy);
    out_xyz[count * 3 + 2] = float(cz);
    ++count;
  }
  return count;
}

}  // extern "C"
