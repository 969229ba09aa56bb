// Fast native 3DGS PLY loader.
//
// Native-runtime counterpart of the reference's C++ loader
// (ref src/Splats.cpp:174-344): binary little-endian PLY, standard 3DGS
// vertex layout, with the load-time activation transforms applied in
// parallel (colour = (0.5 + SH_C0 * f_dc) * scale, opacity = sigmoid,
// scale = exp, quaternion normalised). Unlike the reference it memory-maps
// the file and fans the activation loop across hardware threads, and keeps
// the f_rest spherical-harmonic block instead of discarding it.
//
// C ABI consumed by openglgaussiansplattingrenderer_jax/io/native.py via
// ctypes. Two-phase protocol: gs_open parses the header (returning counts so
// Python can allocate numpy arrays), gs_read fills + activates, gs_close
// unmaps.

#include <cctype>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <fcntl.h>
#include <string>
#include <sys/mman.h>
#include <sys/stat.h>
#include <thread>
#include <unistd.h>
#include <vector>

namespace {

constexpr double kShC0 = 0.28209479177387814;

struct PlyFile {
  int fd = -1;
  const uint8_t *map = nullptr;
  size_t map_size = 0;
  const uint8_t *data = nullptr;  // first vertex byte
  long num = 0;
  int n_rest = 0;      // f_rest_* count (45 for SH degree 3)
  int stride = 0;      // bytes per vertex
  // byte offsets within a vertex record
  int off_xyz = -1, off_normal = -1, off_dc = -1, off_rest = -1;
  int off_opacity = -1, off_scale = -1, off_rot = -1;
  std::string error;
};

bool parse_header(PlyFile &f) {
  const char *p = reinterpret_cast<const char *>(f.map);
  const char *end = p + f.map_size;
  auto next_line = [&](std::string &line) -> bool {
    if (p >= end) return false;
    const char *nl = static_cast<const char *>(memchr(p, '\n', end - p));
    if (!nl) return false;
    line.assign(p, nl - p);
    if (!line.empty() && line.back() == '\r') line.pop_back();
    p = nl + 1;
    return true;
  };

  std::string line;
  if (!next_line(line) || line != "ply") { f.error = "not a PLY file"; return false; }

  bool in_vertex = false;
  int offset = 0;
  std::vector<std::pair<std::string, int>> props;  // name -> byte offset
  while (next_line(line)) {
    if (line.rfind("format", 0) == 0) {
      if (line.find("binary_little_endian") == std::string::npos) {
        f.error = "unsupported PLY format (need binary_little_endian)";
        return false;
      }
    } else if (line.rfind("element", 0) == 0) {
      in_vertex = line.find("vertex") != std::string::npos;
      if (in_vertex) {
        size_t pos = line.find_last_of(' ');
        f.num = strtol(line.c_str() + pos + 1, nullptr, 10);
      }
    } else if (line.rfind("property", 0) == 0 && in_vertex) {
      // "property float <name>"
      if (line.find("property float") != 0) {
        f.error = "unsupported property type: " + line;
        return false;
      }
      size_t pos = line.find_last_of(' ');
      props.emplace_back(line.substr(pos + 1), offset);
      offset += 4;
    } else if (line == "end_header") {
      f.data = reinterpret_cast<const uint8_t *>(p);
      break;
    }
  }
  if (!f.data) { f.error = "no end_header"; return false; }
  f.stride = offset;

  auto find = [&](const char *name) -> int {
    for (auto &pr : props)
      if (pr.first == name) return pr.second;
    return -1;
  };
  f.off_xyz = find("x");
  f.off_normal = find("nx");
  f.off_dc = find("f_dc_0");
  f.off_rest = find("f_rest_0");
  f.off_opacity = find("opacity");
  f.off_scale = find("scale_0");
  f.off_rot = find("rot_0");
  f.n_rest = 0;
  for (auto &pr : props)
    if (pr.first.rfind("f_rest_", 0) == 0) f.n_rest++;
  if (f.off_xyz < 0 || f.off_dc < 0 || f.off_opacity < 0 || f.off_scale < 0 ||
      f.off_rot < 0) {
    f.error = "missing required 3DGS properties";
    return false;
  }
  // contiguity checks so gs_read can use fixed strides
  if (find("y") != f.off_xyz + 4 || find("z") != f.off_xyz + 8 ||
      find("f_dc_2") != f.off_dc + 8 || find("scale_2") != f.off_scale + 8 ||
      find("rot_3") != f.off_rot + 12) {
    f.error = "non-contiguous 3DGS property layout";
    return false;
  }
  size_t need = static_cast<size_t>(f.data - f.map) +
                static_cast<size_t>(f.num) * f.stride;
  if (need > f.map_size) { f.error = "file truncated"; return false; }
  return true;
}

inline float load_f32(const uint8_t *p) {
  float v;
  memcpy(&v, p, 4);
  return v;
}

}  // namespace

extern "C" {

// Opens and parses the header. Returns an opaque handle (0 on failure).
// out_counts: [num_vertices, n_rest]
long gs_open(const char *path, long *out_counts) {
  auto *f = new PlyFile();
  f->fd = open(path, O_RDONLY);
  if (f->fd < 0) { delete f; return 0; }
  struct stat st;
  if (fstat(f->fd, &st) != 0 || st.st_size == 0) { close(f->fd); delete f; return 0; }
  f->map_size = static_cast<size_t>(st.st_size);
  f->map = static_cast<const uint8_t *>(
      mmap(nullptr, f->map_size, PROT_READ, MAP_PRIVATE, f->fd, 0));
  if (f->map == MAP_FAILED) { close(f->fd); delete f; return 0; }
  if (!parse_header(*f)) {
    fprintf(stderr, "gs_open(%s): %s\n", path, f->error.c_str());
    munmap(const_cast<uint8_t *>(f->map), f->map_size);
    close(f->fd);
    delete f;
    return 0;
  }
  out_counts[0] = f->num;
  out_counts[1] = f->n_rest;
  return reinterpret_cast<long>(f);
}

// Reads + activates all splats into caller-allocated float32 arrays:
// means (N,3), colors (N,3), opacities (N,), scales (N,3), quats (N,4) wxyz,
// sh_rest (N, n_rest). sh_rest may be null to skip. Returns 0 on success.
int gs_read(long handle, float color_scale, float *means, float *colors,
            float *opacities, float *scales, float *quats, float *sh_rest) {
  auto *f = reinterpret_cast<PlyFile *>(handle);
  if (!f) return 1;
  const long n = f->num;
  const int stride = f->stride;
  const int n_rest = f->n_rest;
  const uint8_t *base = f->data;

  int n_threads = static_cast<int>(std::thread::hardware_concurrency());
  if (n_threads < 1) n_threads = 1;
  if (n / 65536 + 1 < n_threads) n_threads = static_cast<int>(n / 65536 + 1);

  auto work = [&](long lo, long hi) {
    for (long i = lo; i < hi; i++) {
      const uint8_t *v = base + static_cast<size_t>(i) * stride;
      for (int k = 0; k < 3; k++)
        means[i * 3 + k] = load_f32(v + f->off_xyz + 4 * k);
      for (int k = 0; k < 3; k++) {
        float dc = load_f32(v + f->off_dc + 4 * k);
        colors[i * 3 + k] =
            static_cast<float>((0.5 + kShC0 * dc) * color_scale);
      }
      opacities[i] = 1.0f / (1.0f + std::exp(-load_f32(v + f->off_opacity)));
      for (int k = 0; k < 3; k++)
        scales[i * 3 + k] = std::exp(load_f32(v + f->off_scale + 4 * k));
      float q[4];
      double norm = 0.0;
      for (int k = 0; k < 4; k++) {
        q[k] = load_f32(v + f->off_rot + 4 * k);
        norm += static_cast<double>(q[k]) * q[k];
      }
      float inv = static_cast<float>(1.0 / std::sqrt(norm));
      for (int k = 0; k < 4; k++) quats[i * 4 + k] = q[k] * inv;
      if (sh_rest && n_rest > 0 && f->off_rest >= 0) {
        for (int k = 0; k < n_rest; k++)
          sh_rest[i * n_rest + k] = load_f32(v + f->off_rest + 4 * k);
      }
    }
  };

  if (n_threads <= 1) {
    work(0, n);
  } else {
    std::vector<std::thread> threads;
    long per = (n + n_threads - 1) / n_threads;
    for (int t = 0; t < n_threads; t++) {
      long lo = t * per, hi = std::min(n, lo + per);
      if (lo < hi) threads.emplace_back(work, lo, hi);
    }
    for (auto &t : threads) t.join();
  }
  return 0;
}

void gs_close(long handle) {
  auto *f = reinterpret_cast<PlyFile *>(handle);
  if (!f) return;
  if (f->map) munmap(const_cast<uint8_t *>(f->map), f->map_size);
  if (f->fd >= 0) close(f->fd);
  delete f;
}

}  // extern "C"
