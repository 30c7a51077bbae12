"""Scene parameter samplers (copy of ``adaptigraph_tpu/sim/scenes.py``).

Mirrors the reference's per-material randomized physics sampling
(reference: ``src/sim/sim_env/scenes.py`` — rope ``:24-31``, granular
``:87-138``, cloth ``:150-154``, softbody ``:178``): each sampler draws the
physics parameters that condition the dynamics model and returns

  (scene_name, scene_params, properties)

where ``scene_params`` feeds the C++ builder (``sim/cpp/xpbd.cpp``) and
``properties`` is the episode's ``property_params.json`` consumed by
preprocessing (normalization ranges in ``configs/dynamics/*.yaml``).
"""

import numpy as np


def rope_scene(rng):
    stiffness = rng.uniform(0.0, 1.0)
    length = rng.uniform(2.5, 4.0)
    n_particles = int(length / 0.06)
    friction = rng.uniform(0.1, 0.45)
    theta = rng.uniform(-np.pi, np.pi)
    x, z = rng.uniform(-0.5, 0.5, size=2)
    scene_params = [n_particles, length, 3.0, stiffness, friction, x, z, theta]
    properties = {
        "particle_radius": 0.03,
        "num_particles": n_particles,
        "length": float(length),
        "thickness": 3.0,
        "dynamic_friction": float(friction),
        "stiffness": float(stiffness),
    }
    return "rope", scene_params, properties


def granular_scene(rng):
    granular_scale = rng.uniform(0.1, 0.3)
    # grain count mirrors the reference's area-based grid fill
    # (scenes.py:87-138: area U(1,9), grain spacing 0.1-0.2 x scale):
    # per-side count = (side - scale) / (spacing + scale) + 1
    area = rng.uniform(1.0, 9.0)
    side = float(np.sqrt(area))
    granular_dis = rng.uniform(0.1, 0.2) * granular_scale
    per_side = (side - granular_scale) / (granular_dis + granular_scale) + 1.0
    num_granular = max(9, min(int(per_side * per_side), 400))
    distribution_r = side / 2.0
    friction = rng.uniform(0.2, 0.9)
    granular_mass = rng.uniform(0.01, 0.1)
    scene_params = [granular_scale, num_granular, distribution_r, friction, granular_mass]
    properties = {
        "particle_radius": float(0.5 * granular_scale),
        "num_particles": num_granular,
        "granular_scale": float(granular_scale),
        "num_granular": num_granular,
        "distribution_r": float(distribution_r),
        "dynamic_friction": float(friction),
        "granular_mass": float(granular_mass),
    }
    return "granular", scene_params, properties


def cloth_scene(rng):
    sf = rng.uniform(0.0, 1.0)
    # sized so FPS at the config radius (0.24-0.26) fills the max_nobj=100
    # node budget like the reference's 70x70 FleX cloth does: extent
    # ~2.0-3.3 sim units -> ~60-100 kept nodes
    nx = rng.randint(26, 34)
    nz = rng.randint(26, 34)
    spacing = rng.uniform(0.095, 0.115)
    friction = rng.uniform(0.2, 0.6)
    x = -0.5 * nx * spacing + rng.uniform(-0.2, 0.2)
    z = -0.5 * nz * spacing + rng.uniform(-0.2, 0.2)
    scene_params = [nx, nz, spacing, sf, friction, x, z]
    properties = {
        "particle_radius": float(spacing * 0.4),
        "num_particles": nx * nz,
        "sf": float(sf),
        "dynamic_friction": float(friction),
    }
    return "cloth", scene_params, properties


def softbody_scene(rng):
    stiffness = rng.uniform(0.0, 1.0)
    # sized so FPS at the config radius (0.20-0.24) approaches the
    # max_nobj=300 budget (reference CreateSoftBody scale): extent ~2-3 units
    nx, ny, nz = rng.randint(8, 12), rng.randint(5, 8), rng.randint(8, 12)
    spacing = rng.uniform(0.22, 0.28)
    cluster_spacing = rng.uniform(2.0, 4.0)
    friction = rng.uniform(0.1, 0.45)
    x = -0.5 * nx * spacing + rng.uniform(-0.2, 0.2)
    z = -0.5 * nz * spacing + rng.uniform(-0.2, 0.2)
    scene_params = [nx, ny, nz, spacing, stiffness, cluster_spacing, friction, x, z, 0.2]
    properties = {
        "particle_radius": float(spacing * 0.45),
        "num_particles": nx * ny * nz,
        "cluster_radius": float(cluster_spacing * spacing),
        "cluster_spacing": float(cluster_spacing),
        "dynamic_friction": float(friction),
        "stiffness": float(stiffness),
    }
    return "softbody", scene_params, properties


def multiobj_scene(rng):
    """Multiple rigid convex bodies (reference: scenes.py:394 multi_obj_scene
    + by_multi_objects.h; clusterStiffness ~1 -> rigid)."""
    n_objects = rng.randint(3, 7)
    obj_scale = rng.uniform(0.08, 0.15)
    area_r = rng.uniform(0.5, 0.9)
    friction = rng.uniform(0.2, 0.6)
    scene_params = [n_objects, obj_scale, area_r, friction]
    properties = {
        "particle_radius": float(0.45 * obj_scale),
        "n_objects": int(n_objects),
        "obj_scale": float(obj_scale),
        "dynamic_friction": float(friction),
        "stiffness": 1.0,
    }
    return "multiobj", scene_params, properties


def rigid_scene(rng):
    """Rigid debris pieces (reference: scenes.py:363 rigid_scene -> debris.h,
    env_idx 41 — a stub sampler in the reference; here it reuses the
    multiobj builder with many small fully-rigid pieces)."""
    n_objects = rng.randint(6, 12)
    obj_scale = rng.uniform(0.06, 0.1)
    area_r = rng.uniform(0.5, 0.9)
    friction = rng.uniform(0.3, 0.7)
    scene_params = [n_objects, obj_scale, area_r, friction]
    properties = {
        "particle_radius": float(0.45 * obj_scale),
        "n_objects": int(n_objects),
        "obj_scale": float(obj_scale),
        "dynamic_friction": float(friction),
        "stiffness": 1.0,
    }
    return "multiobj", scene_params, properties


def bunnybath_scene(rng):
    """Fluid bath + rigid body; the sampled physics parameter is viscosity
    (reference: scenes.py:370 yz_bunnybath_scene)."""
    viscosity = rng.uniform(0.0, 0.8)
    nx, ny, nz = rng.randint(10, 14), rng.randint(4, 6), rng.randint(10, 14)
    spacing = 0.1
    hx = 0.5 * nx * spacing + 0.2
    hz = 0.5 * nz * spacing + 0.2
    body_scale = 0.08
    scene_params = [nx, ny, nz, spacing, viscosity, hx, hz, body_scale]
    properties = {
        "particle_radius": float(spacing * 0.5),
        "num_particles": nx * ny * nz + 27,
        "viscosity": float(viscosity),
        "dynamic_friction": 0.01,
    }
    return "bunnybath", scene_params, properties


SCENE_SAMPLERS = {
    "rope": rope_scene,
    "granular": granular_scene,
    "cloth": cloth_scene,
    "softbody": softbody_scene,
    "multiobj": multiobj_scene,
    "bunnybath": bunnybath_scene,
    "rigid": rigid_scene,
}

# pusher geometry per material (reference: config/dynamics/*.yaml eef section
# + task_config pusher_points)
PUSHER_GEOMETRY = {
    "rope": {"offsets": [0.0], "radius": 0.06, "n_eef": 1},
    "granular": {"offsets": [-0.5, -0.25, 0.0, 0.25, 0.5], "radius": 0.08, "n_eef": 5},
    "cloth": {"offsets": [0.0], "radius": 0.06, "n_eef": 1},
    "softbody": {"offsets": [-0.5, -0.25, 0.0, 0.25, 0.5], "radius": 0.08, "n_eef": 5},
    "multiobj": {"offsets": [-0.5, -0.25, 0.0, 0.25, 0.5], "radius": 0.08, "n_eef": 5},
    "rigid": {"offsets": [-0.5, -0.25, 0.0, 0.25, 0.5], "radius": 0.08, "n_eef": 5},
    "bunnybath": {"offsets": [0.0], "radius": 0.1, "n_eef": 1},
}

# eef keypoint offsets used at preprocess time: keypoint j =
# eef_pos + R(quat) @ offset_j (reference: preprocess.py:44-71 + config eef.pos)
EEF_OFFSETS = {
    "rope": [[0.0, 0.0, 0.0]],
    "granular": [[off, 0.0, 0.0] for off in [-0.5, -0.25, 0.0, 0.25, 0.5]],
    "cloth": [[0.0, 0.0, 0.0]],
    "softbody": [[off, 0.0, 0.0] for off in [-0.5, -0.25, 0.0, 0.25, 0.5]],
    "multiobj": [[off, 0.0, 0.0] for off in [-0.5, -0.25, 0.0, 0.25, 0.5]],
    "rigid": [[off, 0.0, 0.0] for off in [-0.5, -0.25, 0.0, 0.25, 0.5]],
    "bunnybath": [[0.0, 0.0, 0.0]],
}
