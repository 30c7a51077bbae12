// XPBD particle simulator: the TPU-era C++ replacement for the reference's
// NVIDIA FleX stack (reference: PyFleX/bindings/pyflex.cpp — closed CUDA
// binaries driven through pybind11). Data generation is host-side in this
// framework (the hot path, MPPI, runs on TPU), so the simulator is CPU
// C++/OpenMP implementing exactly the scene families the reference uses:
// soft rope, granular piles, cloth, soft bodies with fixed particles
// (reference scene headers: by_softrope.h, by_granular.h, by_softgym_cloth.h,
// by_softbody.h).
//
// Method: position-based dynamics with XPBD compliance (Macklin et al.),
// substepped; constraint types: distance (stretch/shear), bending distance,
// shape-matching clusters, particle-particle contact via a uniform spatial
// hash, ground plane with Coulomb-style friction, kinematic spherical tool
// colliders.
#pragma once

#include <cstdint>
#include <vector>

namespace xpbd {

struct Vec3 {
  float x = 0, y = 0, z = 0;
};

struct DistanceConstraint {
  int i, j;
  float rest;
  float compliance;  // XPBD compliance (0 = rigid)
  float lambda = 0;  // accumulated multiplier
};

// Shape-matching cluster: particles pulled toward the best-fit rigid
// transform of their rest configuration, scaled by stiffness in [0,1].
struct Cluster {
  std::vector<int> indices;
  std::vector<Vec3> rest;  // rest positions relative to rest COM
  float stiffness = 0.5f;
};

struct Params {
  float dt = 1.0f / 60.0f;
  int substeps = 4;
  int iterations = 6;
  float gravity = -9.8f;
  float ground_y = 0.0f;
  float particle_radius = 0.05f;
  float contact_radius_scale = 2.0f;  // contact distance = scale * radius
  float dynamic_friction = 0.3f;
  float damping = 0.1f;   // global velocity damping per second
  float tool_radius = 0.06f;
  // FleX analogs (NvFlexParams maxSpeed / sleepThreshold): cap post-solve
  // particle speed (projection ejections would otherwise become multi-unit
  // glides) and zero near-rest velocities so piles settle
  float max_speed = 1e9f;
  float sleep_threshold = 0.0f;
};

class Sim {
 public:
  Params params;

  std::vector<Vec3> pos, prev, vel;
  std::vector<float> inv_mass;
  // particle -> object-instance id (reference: the custom FleX buffer
  // particle2objInstance, pyflex.cpp:216/:905/:2926); builders set
  // instance_tag before adding each object's particles
  std::vector<int> instance;
  int instance_tag = 0;
  std::vector<DistanceConstraint> constraints;
  std::vector<Cluster> clusters;
  bool self_collision = false;

  // position-based fluid block (bunnybath): particles [fluid_begin,
  // fluid_end) get a density constraint + XSPH viscosity instead of contacts
  int fluid_begin = 0, fluid_end = 0;  // empty range = no fluid
  float fluid_rest_density = 1.0f;     // computed from spawn spacing
  float fluid_h = 0.1f;                // smoothing radius
  float fluid_viscosity = 0.0f;        // XSPH coefficient [0, 1]
  // tank walls (axis-aligned box in x/z) used by bath scenes
  bool has_walls = false;
  float wall_x0 = 0, wall_x1 = 0, wall_z0 = 0, wall_z1 = 0;

  // kinematic tool: spheres at tool_pos, moved linearly toward targets each step
  std::vector<Vec3> tool_pos;

  // grasp state: particles pinned to tool point 0 with fixed offsets while a
  // grasp is active (the reference pins the k nearest particles to the finger
  // midpoint with inv mass 0 during gripper pushes, flex_env.py:389-433)
  std::vector<int> grasp_idx;
  std::vector<Vec3> grasp_off;
  std::vector<float> grasp_saved_im;

  // per-stage wall-clock accumulators in milliseconds (parity with the
  // reference's NvFlexGetTimers/GetDetailTimers, pyflex.cpp:3557-3583):
  // [integrate, constraints, clusters, fluid, contacts, tool+walls+ground,
  //  velocity+xsph] plus frame count
  double timers[7] = {0, 0, 0, 0, 0, 0, 0};
  long timed_frames = 0;

  int n() const { return static_cast<int>(pos.size()); }

  void add_particle(Vec3 p, float im);
  void add_distance(int i, int j, float compliance);
  void step(const Vec3* tool_target, int n_tool);
  int grasp(int k, float max_dist);
  void release();

 private:
  void solve_constraints(float h);
  void solve_contacts();
  void solve_ground(float h);
  void solve_clusters();
  void solve_fluid();
  void solve_walls();
  void apply_xsph(float h);
  void collide_tool();
  void build_hash(float cell);
  std::vector<int> hash_heads_;
  std::vector<int> hash_next_;
  std::vector<uint64_t> hash_keys_;
};

// Scene builders (parameter conventions documented in scenes.py).
Sim* make_rope(const float* p, int np_, uint64_t seed);
Sim* make_granular(const float* p, int np_, uint64_t seed);
Sim* make_cloth(const float* p, int np_, uint64_t seed);
Sim* make_softbody(const float* p, int np_, uint64_t seed);
Sim* make_multiobj(const float* p, int np_, uint64_t seed);
Sim* make_bunnybath(const float* p, int np_, uint64_t seed);
Sim* make_softbody_points(const float* pts, int n, float spacing,
                          float stiffness, int cluster_span, float fixed_frac);

}  // namespace xpbd
