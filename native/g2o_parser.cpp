// Native dataset-ingestion library for dpgo_ros_tpu.
//
// Native counterpart of the reference's C++ ingestion path
// (DPGO::read_g2o_file + PGOLogger::loadMeasurements, used by
// src/PGODatasetPublisherNode.cpp:80,168): parses g2o pose-graph files and
// per-robot measurements.csv into flat arrays consumed zero-copy by the
// Python/JAX layer via ctypes. The SE-Sync kappa/tau extraction convention
// matches dpgo_ros_tpu/io/g2o.py exactly (parity-tested).
//
// Build: see native/Makefile (g++ -O3 -march=native -shared -fPIC).

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

namespace {

struct Edge {
  int32_t src_robot, src_frame, dst_robot, dst_frame;
  double R[9];
  double t[3];
  double kappa, tau;
  double weight;
  uint8_t fixed_weight;
};

struct Vertex {
  int32_t id;
  double T[12];  // row-major 3x4 [R | t]
};

struct Graph {
  std::vector<Edge> edges;
  std::vector<Vertex> vertices;
  int32_t max_id = -1;
};

void quat_to_rot(double qx, double qy, double qz, double qw, double* R) {
  const double n = std::sqrt(qx * qx + qy * qy + qz * qz + qw * qw);
  if (n > 0) {
    qx /= n;
    qy /= n;
    qz /= n;
    qw /= n;
  }
  R[0] = 1 - 2 * (qy * qy + qz * qz);
  R[1] = 2 * (qx * qy - qz * qw);
  R[2] = 2 * (qx * qz + qy * qw);
  R[3] = 2 * (qx * qy + qz * qw);
  R[4] = 1 - 2 * (qx * qx + qz * qz);
  R[5] = 2 * (qy * qz - qx * qw);
  R[6] = 2 * (qx * qz - qy * qw);
  R[7] = 2 * (qy * qz + qx * qw);
  R[8] = 1 - 2 * (qx * qx + qy * qy);
}

}  // namespace

extern "C" {

// ---------------------------------------------------------------- g2o

void* dpgo_g2o_parse(const char* path) {
  FILE* f = std::fopen(path, "r");
  if (!f) return nullptr;
  auto* g = new Graph();
  char tag[64];
  std::vector<char> line(1 << 16);
  while (std::fgets(line.data(), (int)line.size(), f)) {
    if (std::sscanf(line.data(), "%63s", tag) != 1) continue;
    if (std::strcmp(tag, "EDGE_SE3:QUAT") == 0) {
      int i, j;
      double tx, ty, tz, qx, qy, qz, qw;
      double info[21];
      int consumed = 0;
      const char* p = line.data();
      if (std::sscanf(p, "%*s %d %d %lf %lf %lf %lf %lf %lf %lf%n", &i, &j,
                      &tx, &ty, &tz, &qx, &qy, &qz, &qw, &consumed) < 9)
        continue;
      p += consumed;
      bool ok = true;
      for (int k = 0; k < 21; ++k) {
        int c2 = 0;
        if (std::sscanf(p, "%lf%n", &info[k], &c2) != 1) {
          ok = false;
          break;
        }
        p += c2;
      }
      if (!ok) continue;
      Edge e{};
      e.src_robot = 0;
      e.dst_robot = 0;
      e.src_frame = i;
      e.dst_frame = j;
      quat_to_rot(qx, qy, qz, qw, e.R);
      e.t[0] = tx;
      e.t[1] = ty;
      e.t[2] = tz;
      // SE-Sync isotropic extraction: translation info diag at positions
      // 0, 6, 11; rotation info diag at 15, 18, 20 (upper-triangular order)
      const double I11 = info[0], I22 = info[6], I33 = info[11];
      const double I44 = info[15], I55 = info[18], I66 = info[20];
      e.tau = 3.0 / (1.0 / I11 + 1.0 / I22 + 1.0 / I33);
      e.kappa = 3.0 / (2.0 * (1.0 / I44 + 1.0 / I55 + 1.0 / I66));
      e.weight = 1.0;
      e.fixed_weight = 0;
      g->edges.push_back(e);
      if (i > g->max_id) g->max_id = i;
      if (j > g->max_id) g->max_id = j;
    } else if (std::strcmp(tag, "VERTEX_SE3:QUAT") == 0) {
      int i;
      double x, y, z, qx, qy, qz, qw;
      if (std::sscanf(line.data(), "%*s %d %lf %lf %lf %lf %lf %lf %lf", &i,
                      &x, &y, &z, &qx, &qy, &qz, &qw) != 8)
        continue;
      Vertex v{};
      v.id = i;
      double R[9];
      quat_to_rot(qx, qy, qz, qw, R);
      for (int r = 0; r < 3; ++r) {
        for (int c = 0; c < 3; ++c) v.T[r * 4 + c] = R[r * 3 + c];
      }
      v.T[3] = x;
      v.T[7] = y;
      v.T[11] = z;
      g->vertices.push_back(v);
      if (i > g->max_id) g->max_id = i;
    }
  }
  std::fclose(f);
  return g;
}

// ---------------------------------------------------------------- csv

void* dpgo_csv_parse(const char* path) {
  // schema: robot_src,pose_src,robot_dst,pose_dst,qx,qy,qz,qw,tx,ty,tz,
  //         kappa,tau,is_known_inlier,weight  (header line skipped)
  FILE* f = std::fopen(path, "r");
  if (!f) return nullptr;
  auto* g = new Graph();
  std::vector<char> line(1 << 15);
  bool first = true;
  while (std::fgets(line.data(), (int)line.size(), f)) {
    if (first) {
      first = false;
      if (std::strstr(line.data(), "robot_src")) continue;  // header
    }
    double v[15];
    int n = 0;
    char* p = line.data();
    while (n < 15) {
      char* end = nullptr;
      v[n] = std::strtod(p, &end);
      if (end == p) break;
      ++n;
      p = end;
      while (*p == ',' || *p == ' ') ++p;
    }
    if (n != 15) continue;
    Edge e{};
    e.src_robot = (int32_t)v[0];
    e.src_frame = (int32_t)v[1];
    e.dst_robot = (int32_t)v[2];
    e.dst_frame = (int32_t)v[3];
    quat_to_rot(v[4], v[5], v[6], v[7], e.R);
    e.t[0] = v[8];
    e.t[1] = v[9];
    e.t[2] = v[10];
    e.kappa = v[11];
    e.tau = v[12];
    e.fixed_weight = v[13] != 0.0;
    e.weight = v[14];
    g->edges.push_back(e);
  }
  std::fclose(f);
  return g;
}

// ------------------------------------------------------------- accessors

int32_t dpgo_num_edges(void* h) { return (int32_t)((Graph*)h)->edges.size(); }
int32_t dpgo_num_vertices(void* h) {
  return (int32_t)((Graph*)h)->vertices.size();
}
int32_t dpgo_max_id(void* h) { return ((Graph*)h)->max_id; }

void dpgo_get_edges(void* h, int32_t* src_robot, int32_t* src_frame,
                    int32_t* dst_robot, int32_t* dst_frame, double* R,
                    double* t, double* kappa, double* tau, double* weight,
                    uint8_t* fixed_weight) {
  const auto& es = ((Graph*)h)->edges;
  for (size_t k = 0; k < es.size(); ++k) {
    const Edge& e = es[k];
    src_robot[k] = e.src_robot;
    src_frame[k] = e.src_frame;
    dst_robot[k] = e.dst_robot;
    dst_frame[k] = e.dst_frame;
    std::memcpy(R + 9 * k, e.R, sizeof(e.R));
    std::memcpy(t + 3 * k, e.t, sizeof(e.t));
    kappa[k] = e.kappa;
    tau[k] = e.tau;
    weight[k] = e.weight;
    fixed_weight[k] = e.fixed_weight;
  }
}

void dpgo_get_vertices(void* h, int32_t* ids, double* T) {
  const auto& vs = ((Graph*)h)->vertices;
  for (size_t k = 0; k < vs.size(); ++k) {
    ids[k] = vs[k].id;
    std::memcpy(T + 12 * k, vs[k].T, sizeof(vs[k].T));
  }
}

void dpgo_free(void* h) { delete (Graph*)h; }

}  // extern "C"
