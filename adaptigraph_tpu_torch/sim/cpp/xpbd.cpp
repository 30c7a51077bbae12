#include "xpbd.h"

#include <algorithm>
#include <chrono>
#include <cmath>
#include <cstring>
#include <random>
#include <unordered_map>

namespace xpbd {

static inline Vec3 sub(Vec3 a, Vec3 b) { return {a.x - b.x, a.y - b.y, a.z - b.z}; }
static inline Vec3 add(Vec3 a, Vec3 b) { return {a.x + b.x, a.y + b.y, a.z + b.z}; }
static inline Vec3 mul(Vec3 a, float s) { return {a.x * s, a.y * s, a.z * s}; }
static inline float dot(Vec3 a, Vec3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }
static inline float norm(Vec3 a) { return std::sqrt(dot(a, a)); }

void Sim::add_particle(Vec3 p, float im) {
  pos.push_back(p);
  prev.push_back(p);
  vel.push_back({0, 0, 0});
  inv_mass.push_back(im);
  instance.push_back(instance_tag);
}

void Sim::add_distance(int i, int j, float compliance) {
  DistanceConstraint c;
  c.i = i;
  c.j = j;
  c.rest = norm(sub(pos[i], pos[j]));
  c.compliance = compliance;
  constraints.push_back(c);
}

void Sim::build_hash(float cell) {
  const int N = n();
  // bucket count scales with the particle count (next pow2 >= 2N, floor
  // 4096) so load factor stays ~0.5 as scenes grow instead of degrading
  // into long chains at a fixed table size
  uint32_t hs = 4096;
  while (hs < (uint32_t)(2 * N) && hs < (1u << 20)) hs <<= 1;
  hash_heads_.assign(hs, -1);
  hash_next_.assign(N, -1);
  const uint32_t mask = hs - 1;
  for (int i = 0; i < N; ++i) {
    int cx = (int)std::floor(pos[i].x / cell);
    int cy = (int)std::floor(pos[i].y / cell);
    int cz = (int)std::floor(pos[i].z / cell);
    uint32_t h = ((uint32_t)(cx * 92837111) ^ (uint32_t)(cy * 689287499) ^
                  (uint32_t)(cz * 283923481)) &
                 mask;
    hash_next_[i] = hash_heads_[h];
    hash_heads_[h] = i;
  }
}

void Sim::solve_contacts() {
  const int N = n();
  const float r = params.particle_radius * params.contact_radius_scale;
  const float cell = r;
  build_hash(cell);
  const uint32_t hmask = (uint32_t)hash_heads_.size() - 1;
  for (int i = 0; i < N; ++i) {
    if (inv_mass[i] == 0) continue;
    int cx0 = (int)std::floor((pos[i].x - r) / cell);
    int cx1 = (int)std::floor((pos[i].x + r) / cell);
    int cy0 = (int)std::floor((pos[i].y - r) / cell);
    int cy1 = (int)std::floor((pos[i].y + r) / cell);
    int cz0 = (int)std::floor((pos[i].z - r) / cell);
    int cz1 = (int)std::floor((pos[i].z + r) / cell);
    for (int cx = cx0; cx <= cx1; ++cx)
      for (int cy = cy0; cy <= cy1; ++cy)
        for (int cz = cz0; cz <= cz1; ++cz) {
          uint32_t h = ((uint32_t)(cx * 92837111) ^ (uint32_t)(cy * 689287499) ^
                        (uint32_t)(cz * 283923481)) &
                       hmask;
          for (int j = hash_heads_[h]; j >= 0; j = hash_next_[j]) {
            if (j <= i) continue;
            Vec3 d = sub(pos[i], pos[j]);
            float dist = norm(d);
            if (dist < 1e-9f || dist >= r) continue;
            float w = inv_mass[i] + inv_mass[j];
            if (w == 0) continue;
            Vec3 corr = mul(d, (r - dist) / dist / w);
            pos[i] = add(pos[i], mul(corr, inv_mass[i]));
            pos[j] = sub(pos[j], mul(corr, inv_mass[j]));
          }
        }
  }
}

void Sim::solve_constraints(float h) {
  const float h2 = h * h;
  for (auto& c : constraints) {
    float w = inv_mass[c.i] + inv_mass[c.j];
    if (w == 0) continue;
    Vec3 d = sub(pos[c.i], pos[c.j]);
    float dist = norm(d);
    if (dist < 1e-9f) continue;
    float alpha = c.compliance / h2;
    float dl = (-(dist - c.rest) - alpha * c.lambda) / (w + alpha);
    c.lambda += dl;
    Vec3 corr = mul(d, dl / dist);
    pos[c.i] = add(pos[c.i], mul(corr, inv_mass[c.i]));
    pos[c.j] = sub(pos[c.j], mul(corr, inv_mass[c.j]));
  }
}

void Sim::solve_ground(float h) {
  const int N = n();
  const float r = params.particle_radius;
#pragma omp parallel for
  for (int i = 0; i < N; ++i) {
    if (inv_mass[i] == 0) continue;
    float pen = params.ground_y + r - pos[i].y;
    if (pen > 0) {
      pos[i].y = params.ground_y + r;
      // Coulomb-ish friction: damp tangential motion proportional to the
      // normal correction (PBD-style, cf. FleX dynamic friction semantics)
      Vec3 dp = sub(pos[i], prev[i]);
      float tangential = std::sqrt(dp.x * dp.x + dp.z * dp.z);
      if (tangential > 1e-9f) {
        float drop = std::min(tangential, params.dynamic_friction * pen);
        float s = 1.0f - drop / tangential;
        pos[i].x = prev[i].x + dp.x * s;
        pos[i].z = prev[i].z + dp.z * s;
      }
    }
  }
}

void Sim::solve_clusters() {
  for (auto& cl : clusters) {
    // best-fit translation + rotation (polar decomposition via iteration)
    const int m = (int)cl.indices.size();
    if (m == 0) continue;
    Vec3 com{0, 0, 0};
    int mobile = 0;
    for (int k = 0; k < m; ++k) {
      com = add(com, pos[cl.indices[k]]);
      ++mobile;
    }
    com = mul(com, 1.0f / mobile);
    // covariance A = sum p_i' * q_i^T (q = rest offset)
    float A[9] = {0};
    for (int k = 0; k < m; ++k) {
      Vec3 p = sub(pos[cl.indices[k]], com);
      Vec3 q = cl.rest[k];
      A[0] += p.x * q.x; A[1] += p.x * q.y; A[2] += p.x * q.z;
      A[3] += p.y * q.x; A[4] += p.y * q.y; A[5] += p.y * q.z;
      A[6] += p.z * q.x; A[7] += p.z * q.y; A[8] += p.z * q.z;
    }
    // extract rotation: iterative polar decomposition (Mueller et al. 2016)
    float R[9] = {1, 0, 0, 0, 1, 0, 0, 0, 1};
    for (int it = 0; it < 12; ++it) {
      // omega = (sum r_c x a_c) / |sum r_c . a_c|, columns r_c of R, a_c of A
      Vec3 rc0{R[0], R[3], R[6]}, rc1{R[1], R[4], R[7]}, rc2{R[2], R[5], R[8]};
      Vec3 ac0{A[0], A[3], A[6]}, ac1{A[1], A[4], A[7]}, ac2{A[2], A[5], A[8]};
      Vec3 cr0 = {rc0.y * ac0.z - rc0.z * ac0.y, rc0.z * ac0.x - rc0.x * ac0.z, rc0.x * ac0.y - rc0.y * ac0.x};
      Vec3 cr1 = {rc1.y * ac1.z - rc1.z * ac1.y, rc1.z * ac1.x - rc1.x * ac1.z, rc1.x * ac1.y - rc1.y * ac1.x};
      Vec3 cr2 = {rc2.y * ac2.z - rc2.z * ac2.y, rc2.z * ac2.x - rc2.x * ac2.z, rc2.x * ac2.y - rc2.y * ac2.x};
      Vec3 omega = add(add(cr0, cr1), cr2);
      float denom = std::fabs(dot(rc0, ac0) + dot(rc1, ac1) + dot(rc2, ac2)) + 1e-9f;
      omega = mul(omega, 1.0f / denom);
      float w = norm(omega);
      if (w < 1e-7f) break;
      // rotate R by axis-angle omega
      Vec3 axis = mul(omega, 1.0f / w);
      float cs = std::cos(w), sn = std::sin(w);
      float x = axis.x, y = axis.y, z = axis.z, t = 1 - cs;
      float Rot[9] = {cs + x * x * t, x * y * t - z * sn, x * z * t + y * sn,
                      y * x * t + z * sn, cs + y * y * t, y * z * t - x * sn,
                      z * x * t - y * sn, z * y * t + x * sn, cs + z * z * t};
      float Rn[9];
      for (int r_ = 0; r_ < 3; ++r_)
        for (int c_ = 0; c_ < 3; ++c_)
          Rn[r_ * 3 + c_] = Rot[r_ * 3] * R[c_] + Rot[r_ * 3 + 1] * R[3 + c_] + Rot[r_ * 3 + 2] * R[6 + c_];
      std::memcpy(R, Rn, sizeof(Rn));
    }
    for (int k = 0; k < m; ++k) {
      int i = cl.indices[k];
      if (inv_mass[i] == 0) continue;
      Vec3 q = cl.rest[k];
      Vec3 goal = {R[0] * q.x + R[1] * q.y + R[2] * q.z + com.x,
                   R[3] * q.x + R[4] * q.y + R[5] * q.z + com.y,
                   R[6] * q.x + R[7] * q.y + R[8] * q.z + com.z};
      Vec3 corr = mul(sub(goal, pos[i]), cl.stiffness);
      pos[i] = add(pos[i], corr);
    }
  }
}

void Sim::solve_walls() {
  if (!has_walls) return;
  const int N = n();
  const float r = params.particle_radius;
#pragma omp parallel for
  for (int i = 0; i < N; ++i) {
    if (inv_mass[i] == 0) continue;
    if (pos[i].x < wall_x0 + r) pos[i].x = wall_x0 + r;
    if (pos[i].x > wall_x1 - r) pos[i].x = wall_x1 - r;
    if (pos[i].z < wall_z0 + r) pos[i].z = wall_z0 + r;
    if (pos[i].z > wall_z1 - r) pos[i].z = wall_z1 - r;
  }
}

// Position-based fluids (Macklin & Mueller 2013): per-particle density
// constraint rho_i/rho0 - 1 = 0 solved by a lambda step over poly6/spiky
// kernels. Plays the role of the FleX fluid solver in the bunnybath scene
// (reference: PyFleX scenes yz_bunnybath.h; viscosity sampled per episode at
// src/sim/sim_env/scenes.py:370).
void Sim::solve_fluid() {
  const int nf = fluid_end - fluid_begin;
  if (nf <= 0) return;
  const float hR = fluid_h;
  const float h2 = hR * hR;
  const float poly6 = 315.0f / (64.0f * 3.14159265f * std::pow(hR, 9.0f));
  const float spiky = -45.0f / (3.14159265f * std::pow(hR, 6.0f));
  build_hash(hR);
  std::vector<float> lambda(nf, 0.0f);
  const uint32_t hmask = (uint32_t)hash_heads_.size() - 1;
  auto cell_hash = [hmask](int cx, int cy, int cz) {
    return ((uint32_t)(cx * 92837111) ^ (uint32_t)(cy * 689287499) ^
            (uint32_t)(cz * 283923481)) & hmask;
  };
#pragma omp parallel for
  for (int fi = 0; fi < nf; ++fi) {
    int i = fluid_begin + fi;
    float rho = 0.0f, sum_grad2 = 0.0f;
    Vec3 grad_i{0, 0, 0};
    int cx = (int)std::floor(pos[i].x / hR), cy = (int)std::floor(pos[i].y / hR),
        cz = (int)std::floor(pos[i].z / hR);
    for (int dx = -1; dx <= 1; ++dx)
      for (int dy = -1; dy <= 1; ++dy)
        for (int dz = -1; dz <= 1; ++dz)
          for (int j = hash_heads_[cell_hash(cx + dx, cy + dy, cz + dz)]; j >= 0;
               j = hash_next_[j]) {
            if (j < fluid_begin || j >= fluid_end) continue;
            Vec3 d = sub(pos[i], pos[j]);
            float r2 = dot(d, d);
            if (r2 >= h2) continue;
            float w = h2 - r2;
            rho += poly6 * w * w * w;
            if (j != i && r2 > 1e-12f) {
              float rl = std::sqrt(r2);
              float g = spiky * (hR - rl) * (hR - rl) / rl / fluid_rest_density;
              Vec3 gj = mul(d, g);
              grad_i = add(grad_i, gj);
              sum_grad2 += dot(gj, gj);
            }
          }
    sum_grad2 += dot(grad_i, grad_i);
    float C = rho / fluid_rest_density - 1.0f;
    if (C < 0) C = 0;  // no cohesion from the density constraint
    lambda[fi] = -C / (sum_grad2 + 1e-4f);
  }
#pragma omp parallel for
  for (int fi = 0; fi < nf; ++fi) {
    int i = fluid_begin + fi;
    Vec3 dp{0, 0, 0};
    int cx = (int)std::floor(pos[i].x / hR), cy = (int)std::floor(pos[i].y / hR),
        cz = (int)std::floor(pos[i].z / hR);
    for (int dx = -1; dx <= 1; ++dx)
      for (int dy = -1; dy <= 1; ++dy)
        for (int dz = -1; dz <= 1; ++dz)
          for (int j = hash_heads_[cell_hash(cx + dx, cy + dy, cz + dz)]; j >= 0;
               j = hash_next_[j]) {
            if (j < fluid_begin || j >= fluid_end || j == i) continue;
            Vec3 d = sub(pos[i], pos[j]);
            float r2 = dot(d, d);
            if (r2 >= h2 || r2 < 1e-12f) continue;
            float rl = std::sqrt(r2);
            float g = spiky * (hR - rl) * (hR - rl) / rl / fluid_rest_density;
            dp = add(dp, mul(d, (lambda[fi] + lambda[j - fluid_begin]) * g));
          }
    pos[i] = add(pos[i], dp);
  }
}

// XSPH viscosity: blend each fluid particle's velocity toward the local
// average (Macklin & Mueller 2013 eq. 17); coefficient = bunnybath viscosity.
void Sim::apply_xsph(float h) {
  const int nf = fluid_end - fluid_begin;
  if (nf <= 0 || fluid_viscosity <= 0) return;
  const float hR = fluid_h;
  const float h2 = hR * hR;
  const float poly6 = 315.0f / (64.0f * 3.14159265f * std::pow(hR, 9.0f));
  build_hash(hR);
  const uint32_t hmask = (uint32_t)hash_heads_.size() - 1;
  auto cell_hash = [hmask](int cx, int cy, int cz) {
    return ((uint32_t)(cx * 92837111) ^ (uint32_t)(cy * 689287499) ^
            (uint32_t)(cz * 283923481)) & hmask;
  };
  std::vector<Vec3> dv(nf, Vec3{0, 0, 0});
#pragma omp parallel for
  for (int fi = 0; fi < nf; ++fi) {
    int i = fluid_begin + fi;
    Vec3 acc{0, 0, 0};
    int cx = (int)std::floor(pos[i].x / hR), cy = (int)std::floor(pos[i].y / hR),
        cz = (int)std::floor(pos[i].z / hR);
    for (int dx = -1; dx <= 1; ++dx)
      for (int dy = -1; dy <= 1; ++dy)
        for (int dz = -1; dz <= 1; ++dz)
          for (int j = hash_heads_[cell_hash(cx + dx, cy + dy, cz + dz)]; j >= 0;
               j = hash_next_[j]) {
            if (j < fluid_begin || j >= fluid_end || j == i) continue;
            Vec3 d = sub(pos[i], pos[j]);
            float r2 = dot(d, d);
            if (r2 >= h2) continue;
            float w = (h2 - r2);
            acc = add(acc, mul(sub(vel[j], vel[i]),
                               poly6 * w * w * w / fluid_rest_density));
          }
    dv[fi] = mul(acc, fluid_viscosity);
  }
  for (int fi = 0; fi < nf; ++fi) vel[fluid_begin + fi] = add(vel[fluid_begin + fi], dv[fi]);
}

void Sim::collide_tool() {
  const int N = n();
  const float r = params.tool_radius + params.particle_radius;
  for (const auto& t : tool_pos) {
#pragma omp parallel for
    for (int i = 0; i < N; ++i) {
      if (inv_mass[i] == 0) continue;
      Vec3 d = sub(pos[i], t);
      float dist = norm(d);
      if (dist < r && dist > 1e-9f) {
        pos[i] = add(t, mul(d, r / dist));
      }
    }
  }
}

int Sim::grasp(int k, float max_dist) {
  // Pin the k nearest movable non-fluid particles to tool point 0 (the
  // gripper fingers' midpoint in the reference, flex_env.py:389-410:
  // find_min_distance(finger_pos, obj_pos, pick_k=5) then inv mass := 0).
  if (tool_pos.empty() || k <= 0) return 0;
  release();
  const Vec3 a = tool_pos[0];
  std::vector<std::pair<float, int>> cand;
  for (int i = 0; i < n(); ++i) {
    if (inv_mass[i] == 0) continue;
    if (i >= fluid_begin && i < fluid_end) continue;
    float d = norm(sub(pos[i], a));
    if (d <= max_dist) cand.emplace_back(d, i);
  }
  if (cand.empty()) return 0;
  int take = std::min<int>(k, (int)cand.size());
  std::partial_sort(cand.begin(), cand.begin() + take, cand.end());
  for (int c = 0; c < take; ++c) {
    int i = cand[c].second;
    grasp_idx.push_back(i);
    grasp_off.push_back(sub(pos[i], a));
    grasp_saved_im.push_back(inv_mass[i]);
    inv_mass[i] = 0.0f;
    vel[i] = Vec3{};
  }
  return take;
}

void Sim::release() {
  // Restore inv mass of grasped particles (reference: flex_env.py:468-471).
  for (size_t c = 0; c < grasp_idx.size(); ++c) {
    int i = grasp_idx[c];
    inv_mass[i] = grasp_saved_im[c];
    vel[i] = Vec3{};
    prev[i] = pos[i];
  }
  grasp_idx.clear();
  grasp_off.clear();
  grasp_saved_im.clear();
}

void Sim::step(const Vec3* tool_target, int n_tool) {
  using clk = std::chrono::steady_clock;
  auto t0 = clk::now();
  auto lap = [&t0, this](int slot) {
    auto t1 = clk::now();
    timers[slot] += std::chrono::duration<double, std::milli>(t1 - t0).count();
    t0 = t1;
  };
  const float h = params.dt / params.substeps;
  const int N = n();
  // tool moves linearly across the frame
  std::vector<Vec3> tool_start = tool_pos;
  for (int s = 0; s < params.substeps; ++s) {
    float tfrac = (s + 1.0f) / params.substeps;
    for (int k = 0; k < n_tool && k < (int)tool_pos.size(); ++k) {
      tool_pos[k] = add(tool_start[k], mul(sub(tool_target[k], tool_start[k]), tfrac));
    }
    // grasped particles ride tool point 0 rigidly (inv mass 0 keeps them out
    // of integration and the velocity pass)
    if (!grasp_idx.empty() && !tool_pos.empty()) {
      for (size_t c = 0; c < grasp_idx.size(); ++c) {
        int i = grasp_idx[c];
        pos[i] = add(tool_pos[0], grasp_off[c]);
        prev[i] = pos[i];
      }
    }
    // integrate
    float damp = std::max(0.0f, 1.0f - params.damping * h);
#pragma omp parallel for
    for (int i = 0; i < N; ++i) {
      prev[i] = pos[i];
      if (inv_mass[i] == 0) continue;
      vel[i].y += params.gravity * h;
      vel[i] = mul(vel[i], damp);
      pos[i] = add(pos[i], mul(vel[i], h));
    }
    lap(0);
    for (auto& c : constraints) c.lambda = 0;
    for (int it = 0; it < params.iterations; ++it) {
      solve_constraints(h);
      lap(1);
      solve_clusters();
      lap(2);
      solve_fluid();
      lap(3);
      if (self_collision) solve_contacts();
      lap(4);
      collide_tool();
      solve_walls();
      solve_ground(h);
      lap(5);
    }
    // velocity update; clamp to max_speed (FleX g_params.maxSpeed analog —
    // position-level tool/contact projection can eject deeply-penetrated
    // particles a full radius in one substep, which unclamped becomes a
    // huge velocity and a multi-unit frictionless glide) and put slow
    // particles to sleep (FleX sleepThreshold, by_granular.h:80 — piles
    // must come to rest instead of creeping)
    const float vmax = params.max_speed;
    const float vsleep2 = params.sleep_threshold * params.sleep_threshold;
#pragma omp parallel for
    for (int i = 0; i < N; ++i) {
      if (inv_mass[i] == 0) continue;
      vel[i] = mul(sub(pos[i], prev[i]), 1.0f / h);
      float v2 = dot(vel[i], vel[i]);
      if (v2 > vmax * vmax) vel[i] = mul(vel[i], vmax / std::sqrt(v2));
      else if (v2 < vsleep2) vel[i] = Vec3{};
    }
    apply_xsph(h);
    lap(6);
  }
  ++timed_frames;
}

// ---------------- scenes ----------------
// Parameter arrays are documented in adaptigraph_tpu/sim/scenes.py; each
// builder mirrors the corresponding FleX scene's physics-relevant structure
// (reference: PyFleX/bindings/scenes/*.h + src/sim/sim_env/scenes.py).

Sim* make_rope(const float* p, int np_, uint64_t seed) {
  // p = [n_particles, length, thickness(unused), stiffness, friction, x, z, theta]
  int n = (int)p[0];
  float length = p[1];
  float stiffness = p[3];
  float friction = p[4];
  float x0 = p[5], z0 = p[6], theta = p[7];
  auto* s = new Sim();
  s->params.dynamic_friction = friction;
  s->params.particle_radius = 0.03f;
  float spacing = length / (n - 1);
  std::mt19937_64 rng(seed);
  std::uniform_real_distribution<float> U(-0.02f, 0.02f);
  for (int i = 0; i < n; ++i) {
    float t = (i - (n - 1) * 0.5f) * spacing;
    Vec3 pt{x0 + t * std::cos(theta) + U(rng), s->params.particle_radius + 0.001f,
            z0 + t * std::sin(theta) + U(rng)};
    s->add_particle(pt, 1.0f);
  }
  // stretch: near-rigid; bend (i, i+2): compliance falls with stiffness
  for (int i = 0; i + 1 < n; ++i) s->add_distance(i, i + 1, 1e-7f);
  float bend_compliance = 0.002f * std::pow(10.0f, -3.0f * stiffness);
  for (int i = 0; i + 2 < n; ++i) s->add_distance(i, i + 2, bend_compliance);
  // long-range stiffening for high stiffness (mirrors cluster-spacing growth,
  // reference: src/sim/sim_env/scenes.py:24-31)
  if (stiffness > 0.5f) {
    for (int i = 0; i + 4 < n; i += 2) s->add_distance(i, i + 4, bend_compliance * 4.0f);
  }
  return s;
}

Sim* make_granular(const float* p, int np_, uint64_t seed) {
  // p = [granular_scale, num_granular, distribution_r, friction, mass]
  float scale = p[0];
  int num = (int)p[1];
  float dist_r = p[2];
  float friction = p[3];
  auto* s = new Sim();
  s->self_collision = true;
  s->params.dynamic_friction = friction;
  s->params.particle_radius = 0.5f * scale;
  s->params.contact_radius_scale = 2.0f;
  // grains need strong velocity damping as a stand-in for rolling
  // resistance, else piles never stop sliding on the frictionless-ish plane
  s->params.damping = 4.0f;
  // the tool sweeps at ~1.2 units/s (env.PUSH_STEP/dt); grains it shoves
  // may not exceed ~1.25x that, and near-rest grains sleep (the reference
  // runs 12 substeps + sleepThreshold, by_granular.h:74-80 — without these
  // a tool-overlap ejection sends grains gliding for multiple units, which
  // dominated the r2 training loss; see scripts/diag_granular_data.py)
  s->params.max_speed = 1.5f;
  s->params.sleep_threshold = 0.02f;
  s->params.substeps = 8;
  std::mt19937_64 rng(seed);
  // non-overlapping jittered grid spawn (overlapping spawns explode under
  // position-based contact projection); layers stack upward until num grains
  // are placed within the distribution radius
  float cell_sz = s->params.particle_radius * 2.05f;
  int per_side = std::max(1, (int)std::floor(2.0f * dist_r / cell_sz));
  std::uniform_real_distribution<float> J(-0.2f * cell_sz, 0.2f * cell_sz);
  int placed = 0;
  for (int layer = 0; placed < num && layer < 64; ++layer) {
    for (int gx = 0; gx < per_side && placed < num; ++gx) {
      for (int gz = 0; gz < per_side && placed < num; ++gz) {
        Vec3 c{-dist_r + (gx + 0.5f) * cell_sz + J(rng),
               s->params.particle_radius + layer * cell_sz + 0.001f,
               -dist_r + (gz + 0.5f) * cell_sz + J(rng)};
        s->instance_tag = placed;  // each grain is its own instance
        s->add_particle(c, 1.0f / std::max(0.01f, scale));
        ++placed;
      }
    }
  }
  return s;
}

Sim* make_cloth(const float* p, int np_, uint64_t seed) {
  // p = [nx, nz, spacing, sf(stiffness 0..1), friction, x, z]
  int nx = (int)p[0], nz = (int)p[1];
  float spacing = p[2], sf = p[3], friction = p[4];
  float x0 = p[5], z0 = p[6];
  auto* s = new Sim();
  s->params.dynamic_friction = friction;
  s->params.particle_radius = spacing * 0.4f;
  s->params.max_speed = 2.0f;  // no whip-crack ejections (r2 audit: 1% of
                               // frames had >0.5-unit single-frame jumps)
  auto idx = [nx](int i, int j) { return j * nx + i; };
  for (int j = 0; j < nz; ++j)
    for (int i = 0; i < nx; ++i)
      s->add_particle({x0 + i * spacing, s->params.particle_radius + 0.001f, z0 + j * spacing}, 1.0f);
  // stretch compliance falls with sf (reference cloth stiffness triple,
  // src/sim/sim_env/scenes.py:150-154)
  float stretch_c = 1e-5f * std::pow(10.0f, -2.0f * sf);
  float bend_c = 0.01f * std::pow(10.0f, -2.0f * sf);
  for (int j = 0; j < nz; ++j)
    for (int i = 0; i < nx; ++i) {
      if (i + 1 < nx) s->add_distance(idx(i, j), idx(i + 1, j), stretch_c);
      if (j + 1 < nz) s->add_distance(idx(i, j), idx(i, j + 1), stretch_c);
      if (i + 1 < nx && j + 1 < nz) {
        s->add_distance(idx(i, j), idx(i + 1, j + 1), stretch_c * 2);
        s->add_distance(idx(i + 1, j), idx(i, j + 1), stretch_c * 2);
      }
      if (i + 2 < nx) s->add_distance(idx(i, j), idx(i + 2, j), bend_c);
      if (j + 2 < nz) s->add_distance(idx(i, j), idx(i, j + 2), bend_c);
    }
  return s;
}

Sim* make_softbody(const float* p, int np_, uint64_t seed) {
  // p = [nx, ny, nz, spacing, stiffness, cluster_spacing, friction, x, z,
  //      fixed_bottom_frac]
  int nx = (int)p[0], ny = (int)p[1], nz = (int)p[2];
  float spacing = p[3], stiffness = p[4];
  int cluster_span = std::max(2, (int)p[5]);
  float friction = p[6];
  float x0 = p[7], z0 = p[8];
  float fixed_frac = p[9];
  auto* s = new Sim();
  s->params.dynamic_friction = friction;
  s->params.particle_radius = spacing * 0.45f;
  auto idx = [nx, ny](int i, int j, int k) { return (k * ny + j) * nx + i; };
  for (int k = 0; k < nz; ++k)
    for (int j = 0; j < ny; ++j)
      for (int i = 0; i < nx; ++i) {
        float y = s->params.particle_radius + j * spacing;
        // bottom fraction fixed in place (inv mass 0), mirroring
        // by_softbody.h:364-394 fixed-particle support
        float im = (j < fixed_frac * ny) ? 0.0f : 1.0f;
        s->add_particle({x0 + i * spacing, y, z0 + k * spacing}, im);
      }
  // overlapping shape-matching clusters of span cluster_span
  int step = std::max(1, cluster_span / 2);
  for (int k = 0; k < nz; k += step)
    for (int j = 0; j < ny; j += step)
      for (int i = 0; i < nx; i += step) {
        Cluster cl;
        Vec3 com{0, 0, 0};
        for (int dk = 0; dk < cluster_span; ++dk)
          for (int dj = 0; dj < cluster_span; ++dj)
            for (int di = 0; di < cluster_span; ++di) {
              int ii = i + di, jj = j + dj, kk = k + dk;
              if (ii >= nx || jj >= ny || kk >= nz) continue;
              cl.indices.push_back(idx(ii, jj, kk));
            }
        if (cl.indices.size() < 4) continue;
        for (int id : cl.indices) com = add(com, s->pos[id]);
        com = mul(com, 1.0f / cl.indices.size());
        for (int id : cl.indices) cl.rest.push_back(sub(s->pos[id], com));
        cl.stiffness = 0.1f + 0.85f * stiffness;
        s->clusters.push_back(cl);
      }
  return s;
}

Sim* make_multiobj(const float* p, int np_, uint64_t seed) {
  // p = [n_objects, obj_scale, area_r, friction]
  // Multiple rigid convex bodies (reference scene: by_multi_objects.h via
  // multi_obj_scene, src/sim/sim_env/scenes.py:394): each object is a small
  // particle blob bound by one stiffness-1 shape-matching cluster.
  int n_obj = (int)p[0];
  float scale = p[1];
  float area_r = p[2];
  float friction = p[3];
  auto* s = new Sim();
  s->self_collision = true;
  s->params.dynamic_friction = friction;
  s->params.particle_radius = 0.45f * scale;
  s->params.contact_radius_scale = 2.0f;
  s->params.damping = 2.0f;
  // debris bodies shoved by the pusher must not be launched into glides
  // (same pathology as granular; reference by_multi_objects.h runs deep
  // substeps with restitution 0)
  s->params.max_speed = 1.5f;
  s->params.sleep_threshold = 0.02f;
  s->params.substeps = 8;
  std::mt19937_64 rng(seed);
  std::uniform_real_distribution<float> U(-area_r, area_r);
  std::uniform_int_distribution<int> S3(2, 3);
  for (int o = 0; o < n_obj; ++o) {
    s->instance_tag = o;
    float cx = U(rng), cz = U(rng);
    int sx = S3(rng), sy = S3(rng), sz = S3(rng);
    Cluster cl;
    float sp = scale;
    for (int k = 0; k < sz; ++k)
      for (int j = 0; j < sy; ++j)
        for (int i = 0; i < sx; ++i) {
          cl.indices.push_back(s->n());
          s->add_particle({cx + (i - (sx - 1) * 0.5f) * sp,
                           s->params.particle_radius + j * sp,
                           cz + (k - (sz - 1) * 0.5f) * sp},
                          1.0f);
        }
    Vec3 com{0, 0, 0};
    for (int id : cl.indices) com = add(com, s->pos[id]);
    com = mul(com, 1.0f / cl.indices.size());
    for (int id : cl.indices) cl.rest.push_back(sub(s->pos[id], com));
    cl.stiffness = 1.0f;  // rigid
    s->clusters.push_back(cl);
  }
  return s;
}

Sim* make_bunnybath(const float* p, int np_, uint64_t seed) {
  // p = [nx, ny, nz, spacing, viscosity, tank_half_x, tank_half_z,
  //      body_scale (0 = no rigid body)]
  // Fluid bath + optional rigid body (reference scene: yz_bunnybath.h; the
  // sampled physics param is viscosity, src/sim/sim_env/scenes.py:370).
  int nx = (int)p[0], ny = (int)p[1], nz = (int)p[2];
  float spacing = p[3];
  float viscosity = p[4];
  float hx = p[5], hz = p[6];
  float body_scale = np_ > 7 ? p[7] : 0.0f;
  auto* s = new Sim();
  s->params.particle_radius = spacing * 0.5f;
  s->params.damping = 0.5f;
  s->params.iterations = 4;
  // cap splash velocities: the PBF density projection can eject a particle
  // a full kernel radius in one substep, which unclamped became 14-unit
  // teleports in the r2 dataset (scripts/diag_granular_data.py audit)
  s->params.max_speed = 3.0f;
  s->fluid_h = spacing * 2.2f;
  s->fluid_viscosity = viscosity;
  s->has_walls = true;
  s->wall_x0 = -hx; s->wall_x1 = hx;
  s->wall_z0 = -hz; s->wall_z1 = hz;
  std::mt19937_64 rng(seed);
  std::uniform_real_distribution<float> J(-0.05f * spacing, 0.05f * spacing);
  s->fluid_begin = 0;
  for (int k = 0; k < nz; ++k)
    for (int j = 0; j < ny; ++j)
      for (int i = 0; i < nx; ++i)
        s->add_particle({-0.5f * (nx - 1) * spacing + i * spacing + J(rng),
                         s->params.particle_radius + j * spacing,
                         -0.5f * (nz - 1) * spacing + k * spacing + J(rng)},
                        1.0f);
  s->fluid_end = s->n();
  // rest density from the cubic spawn lattice under the poly6 kernel
  {
    const float hR = s->fluid_h, h2 = hR * hR;
    const float poly6 = 315.0f / (64.0f * 3.14159265f * std::pow(hR, 9.0f));
    float rho = 0.0f;
    for (int dx = -3; dx <= 3; ++dx)
      for (int dy = -3; dy <= 3; ++dy)
        for (int dz = -3; dz <= 3; ++dz) {
          float r2 = (dx * dx + dy * dy + dz * dz) * spacing * spacing;
          if (r2 < h2) {
            float w = h2 - r2;
            rho += poly6 * w * w * w;
          }
        }
    s->fluid_rest_density = rho;
  }
  if (body_scale > 0) {
    // floating rigid blob ("bunny") dropped into the bath
    s->instance_tag = 1;  // fluid = instance 0, body = instance 1
    Cluster cl;
    int m = 3;
    float sp = body_scale;
    for (int k = 0; k < m; ++k)
      for (int j = 0; j < m; ++j)
        for (int i = 0; i < m; ++i) {
          cl.indices.push_back(s->n());
          s->add_particle({(i - 1) * sp, ny * spacing + 2.0f * sp + j * sp,
                           (k - 1) * sp},
                          0.8f);
        }
    Vec3 com{0, 0, 0};
    for (int id : cl.indices) com = add(com, s->pos[id]);
    com = mul(com, 1.0f / cl.indices.size());
    for (int id : cl.indices) cl.rest.push_back(sub(s->pos[id], com));
    cl.stiffness = 1.0f;
    s->clusters.push_back(cl);
    s->self_collision = true;  // body-fluid coupling via contacts
  }
  return s;
}

Sim* make_softbody_points(const float* pts, int n, float spacing,
                          float stiffness, int cluster_span, float fixed_frac) {
  // Soft body from an arbitrary particle fill (e.g. a voxelized mesh —
  // the role of FleX's CreateSoftBody over core/voxelize output,
  // by_softbody.h:260): overlapping shape-matching clusters built from a
  // uniform cell partition of the points.
  auto* s = new Sim();
  s->params.particle_radius = spacing * 0.45f;
  float min_y = 1e9f, max_y = -1e9f;
  for (int i = 0; i < n; ++i) {
    min_y = std::min(min_y, pts[i * 3 + 1]);
    max_y = std::max(max_y, pts[i * 3 + 1]);
  }
  float y_thresh = min_y + fixed_frac * (max_y - min_y);
  for (int i = 0; i < n; ++i) {
    Vec3 p{pts[i * 3], pts[i * 3 + 1], pts[i * 3 + 2]};
    s->add_particle(p, p.y <= y_thresh ? 0.0f : 1.0f);
  }
  // cell partition: cluster cell size = cluster_span * spacing, overlapped
  // by half-cell offsets
  float cell = std::max(1, cluster_span) * spacing;
  for (int phase = 0; phase < 2; ++phase) {
    float off = phase * 0.5f * cell;
    std::unordered_map<int64_t, Cluster> cells;
    for (int i = 0; i < n; ++i) {
      int cx = (int)std::floor((pts[i * 3] + off) / cell);
      int cy = (int)std::floor((pts[i * 3 + 1] + off) / cell);
      int cz = (int)std::floor((pts[i * 3 + 2] + off) / cell);
      int64_t key = ((int64_t)cx << 42) ^ ((int64_t)cy << 21) ^ (int64_t)cz;
      cells[key].indices.push_back(i);
    }
    for (auto& kv : cells) {
      Cluster& cl = kv.second;
      if (cl.indices.size() < 4) continue;
      Vec3 com{0, 0, 0};
      for (int id : cl.indices) com = add(com, s->pos[id]);
      com = mul(com, 1.0f / cl.indices.size());
      for (int id : cl.indices) cl.rest.push_back(sub(s->pos[id], com));
      cl.stiffness = 0.1f + 0.85f * stiffness;
      s->clusters.push_back(cl);
    }
  }
  return s;
}

}  // namespace xpbd

// ---------------- C API (ctypes) ----------------
extern "C" {

void* xpbd_create_softbody_points(const float* pts, int n, float spacing,
                                  float stiffness, int cluster_span,
                                  float fixed_frac) {
  return xpbd::make_softbody_points(pts, n, spacing, stiffness, cluster_span,
                                    fixed_frac);
}

void* xpbd_create(int scene_type, const float* params, int n_params, uint64_t seed) {
  switch (scene_type) {
    case 0: return xpbd::make_rope(params, n_params, seed);
    case 1: return xpbd::make_granular(params, n_params, seed);
    case 2: return xpbd::make_cloth(params, n_params, seed);
    case 3: return xpbd::make_softbody(params, n_params, seed);
    case 4: return xpbd::make_multiobj(params, n_params, seed);
    case 5: return xpbd::make_bunnybath(params, n_params, seed);
    default: return nullptr;
  }
}

int xpbd_n_particles(void* h) { return static_cast<xpbd::Sim*>(h)->n(); }

void xpbd_get_positions(void* h, float* out) {
  auto* s = static_cast<xpbd::Sim*>(h);
  std::memcpy(out, s->pos.data(), s->n() * 3 * sizeof(float));
}

void xpbd_get_inv_mass(void* h, float* out) {
  auto* s = static_cast<xpbd::Sim*>(h);
  std::memcpy(out, s->inv_mass.data(), s->n() * sizeof(float));
}

void xpbd_set_tool(void* h, const float* tool, int n_tool, float radius) {
  auto* s = static_cast<xpbd::Sim*>(h);
  s->tool_pos.assign(reinterpret_cast<const xpbd::Vec3*>(tool),
                     reinterpret_cast<const xpbd::Vec3*>(tool) + n_tool);
  s->params.tool_radius = radius;
}

void xpbd_get_tool(void* h, float* out) {
  auto* s = static_cast<xpbd::Sim*>(h);
  std::memcpy(out, s->tool_pos.data(), s->tool_pos.size() * 3 * sizeof(float));
}

void xpbd_step(void* h, const float* tool_target, int n_tool) {
  static_cast<xpbd::Sim*>(h)->step(reinterpret_cast<const xpbd::Vec3*>(tool_target), n_tool);
}

void xpbd_get_instance(void* h, int* out) {
  auto* s = static_cast<xpbd::Sim*>(h);
  std::memcpy(out, s->instance.data(), s->n() * sizeof(int));
}

void xpbd_fluid_range(void* h, int* out2) {
  auto* s = static_cast<xpbd::Sim*>(h);
  out2[0] = s->fluid_begin;
  out2[1] = s->fluid_end;
}

int xpbd_grasp(void* h, int k, float max_dist) {
  return static_cast<xpbd::Sim*>(h)->grasp(k, max_dist);
}

void xpbd_release(void* h) { static_cast<xpbd::Sim*>(h)->release(); }

// per-stage solver timers, ms accumulated since creation (parity with
// NvFlexGetTimers, pyflex.cpp:3557-3583): out8 = [integrate, constraints,
// clusters, fluid, contacts, tool+walls+ground, velocity+xsph, frames]
void xpbd_get_timers(void* h, double* out8) {
  auto* s = static_cast<xpbd::Sim*>(h);
  for (int i = 0; i < 7; ++i) out8[i] = s->timers[i];
  out8[7] = static_cast<double>(s->timed_frames);
}

void xpbd_destroy(void* h) { delete static_cast<xpbd::Sim*>(h); }
}
