// Parameter structs of the env kernels, passed by value to every launch.
//
// Field for field the ctypes structs of space_gym_torch/ops/kernel_params.py:
// every field is a 4-byte int or float, so both layouts have no padding.
// Products and quotients of config constants are folded on the host in
// double and rounded to float once, as the JAX code folds them in Python.
#pragma once

#define SG_MAX_PLANETS 4
#define SG_MAX_SUBSTEPS 8

struct PhysParams {
  int steering;  // 0 = acceleration, 1 = velocity
  int n_substeps;
  int refine_iters;
  float max_engine_force;
  float ship_mass;
  float aang_coef;  // max_thruster_force / moi
  float vel_steer_scale;
  float half;  // world_size / 2
  float max_abs_vel_angle;
  float h;  // step_size / n_substeps
  float gm[SG_MAX_PLANETS];  // G * ship.mass * masses[i]
  float radii[SG_MAX_PLANETS];
  float t0[SG_MAX_SUBSTEPS];  // substep start times (summed in double)
  float t1[SG_MAX_SUBSTEPS];  // t0 + h (in double)
};

struct FullParams {
  PhysParams phys;
  int max_episode_steps;
  int kepler_randomize;
  float two_over_ws;
  float max_w, max_w_3, max_w_5;
  // Goal reward
  float survival, gv_scale, safety_scale, sparse, danger_zone, distance_fctr,
      neg_distance_fctr, goal_radius;
  // hex tiling
  float zero_x, zero_y_a, zero_y_b, col_step, hex_height, half_hex_height, free_x;
  float disk_r_ship, disk_r_planet, disk_r_goal;
  // Kepler
  float k_dist_lo, k_dist_span, alpha_gm, k_C, k_rad_C, k_act_C;
  // DoNotCrash
  float d_dist_lo, d_dist_span, dnc_reward;
  // K3's action operand is the raw continuous action (1) or the discrete
  // table's rows (0)
  int continuous;
};

#define SG_TWO_PI 6.283185307179586f

// Status returned for a configuration the library was not instantiated for
// (cudaError_t values are small non-negative integers).
#define SG_ERR_UNSUPPORTED -1
