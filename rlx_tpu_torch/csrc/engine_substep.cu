// Physics substeps with the whole per-env state held in the thread.
//
// Replaces rlx_tpu/ops/engine_substep_pallas.py::step_pallas (Pallas TPU),
// which evaluates the JAX engine's own batch-last substep in VMEM.  This is
// a new kernel for the same function, written from
// rlx_tpu_torch/physics/engine.py (the plain version, held against the JAX
// engine by the CPU tests):
//
//   FK -> world Jacobian columns -> velocity-product bias recursion with
//   gravity as base acceleration -> CRBA composite inertias and the chain
//   entries of M (+ armature) -> penalty contacts with stick-slip anchors ->
//   RNEA backward wrench projection -> position servos / motors, damping,
//   frictionloss tanh, damped joint limits -> tree-sparse LTDL solve ->
//   semi-implicit Euler with quaternion integration, nr_substeps times.
//
// Bound: operations.  Per env-substep the Ant needs a few thousand f32
// flops (counted in ops/engine_substep_cuda.py::substep_flops) against
// ~250 bytes of state moved per launch (qpos, qvel, ctrl, anchors in and
// out once), so the card's f32 rate bounds it, not its memory.
//
// Design: one thread per env, one .so for every model.  The model's static
// tables live in __constant__ memory (uploaded before each launch on the
// launch stream); every thread of a warp reads the same table entry at the
// same time, which the constant cache broadcasts.  Per-env state (rotations,
// Jacobian columns, composite inertias, M's chain entries, the LTDL factors)
// stays in registers / local memory across all substeps; only qpos, qvel and
// the anchors are read once and written once.  Global arrays are batch-last
// [comp, B], so thread b reads address b of each row: coalesced.  Spatial
// inertias are kept in the compact form (TL 3x3, h = m*com, m), which is the
// 6x6 world-origin inertia [[TL, skew(h)], [skew(h)^T, m 1]] without its
// zero and repeated entries.
//
// DomainParams fields come as optional pointers (null = compiled constant).

#include <cuda_runtime.h>
#include <math.h>

#define MAX_NBODY 24
#define MAX_NQ 32
#define MAX_NV 24
#define MAX_NU 24
#define MAX_NCON 32

#define JNT_FREE 0
#define JNT_HINGE 3

struct ModelI {
  int nbody, nq, nv, nu, ncon;
  int parent[MAX_NBODY];
  int jnt_type[MAX_NBODY];
  int qpos_adr[MAX_NBODY];
  int dof_adr[MAX_NBODY];
  int jnt_limited[MAX_NBODY];
  int frame_identity[MAX_NBODY];
  int lam[MAX_NV];
  int dof_body[MAX_NV];
  int act_dof[MAX_NU];
  int act_qpos[MAX_NU];
  int act_is_position[MAX_NU];
  int con_body[MAX_NCON];
};

struct ModelF {
  float timestep;
  float gravity[3];
  float omega_c;          // 1 / contact_timeconst
  float limit_stiffness;
  float frame_rot[MAX_NBODY][9];   // rotation of body_quat, row-major
  float body_pos[MAX_NBODY][3];
  float icom_rot[MAX_NBODY][9];    // rotation of body_iquat
  float body_ipos[MAX_NBODY][3];
  float body_mass[MAX_NBODY];
  float body_inertia[MAX_NBODY][3];
  float jnt_axis[MAX_NBODY][3];
  float jnt_pos[MAX_NBODY][3];
  float rod_K[MAX_NBODY][9];       // skew(axis)
  float rod_KK[MAX_NBODY][9];      // skew(axis)^2
  float jnt_lo[MAX_NBODY];
  float jnt_hi[MAX_NBODY];
  float jnt_dlim[MAX_NBODY];       // limit damping (host float64)
  float dof_armature[MAX_NV];
  float dof_damping[MAX_NV];
  float dof_frictionloss[MAX_NV];
  float act_kp[MAX_NU];
  float act_kv[MAX_NU];
  float act_gear[MAX_NU];
  float act_lo[MAX_NU];
  float act_hi[MAX_NU];
  float con_pos[MAX_NCON][3];
  float con_radius[MAX_NCON];
  float con_friction[MAX_NCON];
  float con_k[MAX_NCON];     // nominal stiffness min(m_eff w^2, 2 m_app/dt^2)
  float con_d[MAX_NCON];     // nominal damping min(2 z m_eff w, 0.7 m_app/dt)
  float con_meff[MAX_NCON];  // for a per-env stiffness scale
  float con_dw[MAX_NCON];    // 2 z m_eff
  float con_kcap[MAX_NCON];  // 2 m_app / dt^2
  float con_dcap[MAX_NCON];  // 0.7 m_app / dt
  float con_kt[MAX_NCON];    // 0.3 m_app_t / dt^2
  float con_ct[MAX_NCON];    // 0.4 m_app_t / dt
};

__constant__ ModelI cI;
__constant__ ModelF cF;

struct DomainPtrs {
  const float* mass_scale;          // [nbody, B]
  const float* damping_scale;       // [B]
  const float* frictionloss_scale;  // [B]
  const float* armature_scale;      // [B]
  const float* friction_scale;      // [B]
  const float* contact_stiffness_scale;  // [B]
  const float* kp_scale;            // [nu, B]
  const float* kv_scale;            // [nu, B]
  const float* forcerange_scale;    // [nu, B]
  const float* ctrl_offset;         // [nu, B]
  const float* gravity;             // [3, B]
};

__device__ __forceinline__ void cross3(const float* a, const float* b, float* out) {
  out[0] = a[1] * b[2] - a[2] * b[1];
  out[1] = a[2] * b[0] - a[0] * b[2];
  out[2] = a[0] * b[1] - a[1] * b[0];
}

// out = A @ B, 3x3 row-major
__device__ __forceinline__ void matmul3(const float* A, const float* B, float* out) {
  for (int m = 0; m < 3; ++m)
    for (int n = 0; n < 3; ++n)
      out[m * 3 + n] = A[m * 3 + 0] * B[0 * 3 + n] + A[m * 3 + 1] * B[1 * 3 + n] +
                       A[m * 3 + 2] * B[2 * 3 + n];
}

__device__ __forceinline__ void matvec3(const float* A, const float* v, float* out) {
  for (int m = 0; m < 3; ++m)
    out[m] = A[m * 3 + 0] * v[0] + A[m * 3 + 1] * v[1] + A[m * 3 + 2] * v[2];
}

// compact spatial inertia: [0..8] TL row-major, [9..11] h = m*com, [12] m
#define INR 13

// out = I @ x for a motion vector x = (w, vl): (TL w + h x vl, -(h x w) + m vl)
__device__ __forceinline__ void inertia_matvec(const float* I, const float* x, float* out) {
  const float* h = I + 9;
  const float m = I[12];
  float hv[3], hw[3], tw[3];
  matvec3(I, x, tw);
  cross3(h, x + 3, hv);
  cross3(h, x, hw);
  for (int k = 0; k < 3; ++k) {
    out[k] = tw[k] + hv[k];
    out[3 + k] = -hw[k] + m * x[3 + k];
  }
}

__device__ __forceinline__ float dot6(const float* a, const float* b) {
  return a[0] * b[0] + a[1] * b[1] + a[2] * b[2] + a[3] * b[3] + a[4] * b[4] + a[5] * b[5];
}

__global__ void __launch_bounds__(32)
engine_substep_kernel(const float* __restrict__ qpos_in,   // [nq, B]
                      const float* __restrict__ qvel_in,   // [nv, B]
                      const float* __restrict__ ctrl,      // [S or 1, nu, B]
                      int ctrl_per_substep,
                      const float* __restrict__ anchors_in,  // [ncon, 2, B] or null
                      float* __restrict__ qpos_out,
                      float* __restrict__ qvel_out,
                      float* __restrict__ anchors_out,     // [ncon, 2, B] or null
                      DomainPtrs dr, int B, int nr_substeps) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const int nbody = cI.nbody, nq = cI.nq, nv = cI.nv, nu = cI.nu, ncon = cI.ncon;
  const float dt = cF.timestep;

  float qpos[MAX_NQ], qvel[MAX_NV];
  float anchor[MAX_NCON][2];
  for (int k = 0; k < nq; ++k) qpos[k] = qpos_in[(size_t)k * B + b];
  for (int k = 0; k < nv; ++k) qvel[k] = qvel_in[(size_t)k * B + b];
  const bool have_anchors = anchors_in != nullptr;
  if (have_anchors)
    for (int c = 0; c < ncon; ++c) {
      anchor[c][0] = anchors_in[((size_t)c * 2 + 0) * B + b];
      anchor[c][1] = anchors_in[((size_t)c * 2 + 1) * B + b];
    }

  float gneg[3];
  for (int k = 0; k < 3; ++k)
    gneg[k] = dr.gravity ? -dr.gravity[(size_t)k * B + b] : -cF.gravity[k];

  float R[MAX_NBODY][9], p[MAX_NBODY][3];
  float cols[MAX_NV][6];
  float vel[MAX_NBODY][6], zeta[MAX_NBODY][6];
  float Ic[MAX_NBODY][INR];
  float f[MAX_NBODY][6], w[MAX_NBODY][6];
  float M[MAX_NV][MAX_NV];
  float x[MAX_NV];

  for (int s = 0; s < nr_substeps; ++s) {
    const float* ctrl_s = ctrl + (ctrl_per_substep ? (size_t)s * nu * B : 0);

    // ---- forward kinematics (parents precede children) -------------------
    for (int i = 0; i < nbody; ++i) {
      const int par = cI.parent[i];
      float Rp[9], pp[3];
      for (int k = 0; k < 9; ++k) Rp[k] = par >= 0 ? R[par][k] : (k % 4 == 0 ? 1.0f : 0.0f);
      for (int k = 0; k < 3; ++k) pp[k] = par >= 0 ? p[par][k] : 0.0f;
      float Rf[9], pf[3], t3[3];
      if (cI.frame_identity[i]) {
        for (int k = 0; k < 9; ++k) Rf[k] = Rp[k];
      } else {
        matmul3(Rp, cF.frame_rot[i], Rf);
      }
      matvec3(Rp, cF.body_pos[i], t3);
      for (int k = 0; k < 3; ++k) pf[k] = pp[k] + t3[k];
      const int jt = cI.jnt_type[i];
      const int qa = cI.qpos_adr[i];
      if (jt == JNT_FREE) {
        for (int k = 0; k < 3; ++k) p[i][k] = qpos[qa + k];
        const float qw = qpos[qa + 3], qx = qpos[qa + 4], qy = qpos[qa + 5], qz = qpos[qa + 6];
        R[i][0] = 1 - 2 * (qy * qy + qz * qz);
        R[i][1] = 2 * (qx * qy - qw * qz);
        R[i][2] = 2 * (qx * qz + qw * qy);
        R[i][3] = 2 * (qx * qy + qw * qz);
        R[i][4] = 1 - 2 * (qx * qx + qz * qz);
        R[i][5] = 2 * (qy * qz - qw * qx);
        R[i][6] = 2 * (qx * qz - qw * qy);
        R[i][7] = 2 * (qy * qz + qw * qx);
        R[i][8] = 1 - 2 * (qx * qx + qy * qy);
      } else if (jt == JNT_HINGE) {
        float sn, cs;
        sincosf(qpos[qa], &sn, &cs);
        float Ra[9];
        for (int k = 0; k < 9; ++k)
          Ra[k] = ((k % 4 == 0) ? 1.0f : 0.0f) + sn * cF.rod_K[i][k] + (1.0f - cs) * cF.rod_KK[i][k];
        matmul3(Rf, Ra, R[i]);
        float D[9];
        for (int k = 0; k < 9; ++k) D[k] = Rf[k] - R[i][k];
        matvec3(D, cF.jnt_pos[i], t3);
        for (int k = 0; k < 3; ++k) p[i][k] = pf[k] + t3[k];
      } else {
        for (int k = 0; k < 9; ++k) R[i][k] = Rf[k];
        for (int k = 0; k < 3; ++k) p[i][k] = pf[k];
      }
    }

    // ---- world Jacobian columns --------------------------------------------
    for (int i = 0; i < nbody; ++i) {
      const int jt = cI.jnt_type[i];
      const int d = cI.dof_adr[i];
      if (jt == JNT_FREE) {
        for (int k = 0; k < 3; ++k) {
          for (int j = 0; j < 6; ++j) cols[d + k][j] = 0.0f;
          cols[d + k][3 + k] = 1.0f;
        }
        for (int k = 0; k < 3; ++k) {
          float a[3] = {R[i][0 * 3 + k], R[i][1 * 3 + k], R[i][2 * 3 + k]};
          float pa[3];
          cross3(p[i], a, pa);
          for (int j = 0; j < 3; ++j) {
            cols[d + 3 + k][j] = a[j];
            cols[d + 3 + k][3 + j] = pa[j];
          }
        }
      } else if (jt == JNT_HINGE) {
        float a[3], off[3], anc[3], pa[3];
        matvec3(R[i], cF.jnt_axis[i], a);
        matvec3(R[i], cF.jnt_pos[i], off);
        for (int k = 0; k < 3; ++k) anc[k] = p[i][k] + off[k];
        cross3(anc, a, pa);
        for (int j = 0; j < 3; ++j) {
          cols[d][j] = a[j];
          cols[d][3 + j] = pa[j];
        }
      }
    }

    // ---- velocities, bias wrenches, spatial inertias ------------------------
    for (int i = 0; i < nbody; ++i) {
      const int par = cI.parent[i];
      const int jt = cI.jnt_type[i];
      const int d = cI.dof_adr[i];
      float own[6], mov[6];
      for (int j = 0; j < 6; ++j) {
        own[j] = 0.0f;
        mov[j] = 0.0f;
      }
      if (jt == JNT_FREE) {
        for (int j = 0; j < 6; ++j) {
          float acc = 0.0f, accm = 0.0f;
          for (int k = 0; k < 6; ++k) acc += cols[d + k][j] * qvel[d + k];
          for (int k = 3; k < 6; ++k) accm += cols[d + k][j] * qvel[d + k];
          own[j] = acc;
          mov[j] = accm;
        }
      } else if (jt == JNT_HINGE) {
        for (int j = 0; j < 6; ++j) {
          own[j] = cols[d][j] * qvel[d];
          mov[j] = own[j];
        }
      }
      float* v = vel[i];
      for (int j = 0; j < 6; ++j) v[j] = (par >= 0 ? vel[par][j] : 0.0f) + own[j];
      // zeta_i = zeta_par + v x mov  (motion cross product)
      float c1[3], c2[3], c3[3];
      cross3(v, mov, c1);
      cross3(v, mov + 3, c2);
      cross3(v + 3, mov, c3);
      for (int k = 0; k < 3; ++k) {
        const float zp = par >= 0 ? zeta[par][k] : 0.0f;
        const float zpl = par >= 0 ? zeta[par][3 + k] : gneg[k];
        zeta[i][k] = zp + c1[k];
        zeta[i][3 + k] = zpl + (c2[k] + c3[k]);
      }

      // compact world-origin spatial inertia of body i
      float Ricom[9], S[9], com[3], t3[3];
      matmul3(R[i], cF.icom_rot[i], Ricom);
      for (int m = 0; m < 3; ++m)
        for (int n = 0; n < 3; ++n) S[m * 3 + n] = Ricom[m * 3 + n] * cF.body_inertia[i][n];
      matvec3(R[i], cF.body_ipos[i], t3);
      for (int k = 0; k < 3; ++k) com[k] = p[i][k] + t3[k];
      const float mass = cF.body_mass[i];
      // c c^T with c = skew(com)
      const float cc[9] = {
          com[2] * com[2] + com[1] * com[1], -com[1] * com[0], -com[2] * com[0],
          -com[0] * com[1], com[2] * com[2] + com[0] * com[0], -com[2] * com[1],
          -com[0] * com[2], -com[1] * com[2], com[1] * com[1] + com[0] * com[0]};
      float* I = Ic[i];
      for (int m = 0; m < 3; ++m)
        for (int n = 0; n < 3; ++n) {
          // I_c = (Ricom diag(I)) Ricom^T
          const float ic = S[m * 3 + 0] * Ricom[n * 3 + 0] + S[m * 3 + 1] * Ricom[n * 3 + 1] +
                           S[m * 3 + 2] * Ricom[n * 3 + 2];
          I[m * 3 + n] = ic + mass * cc[m * 3 + n];
        }
      for (int k = 0; k < 3; ++k) I[9 + k] = mass * com[k];
      I[12] = mass;
      if (dr.mass_scale) {
        const float sc = dr.mass_scale[(size_t)i * B + b];
        for (int k = 0; k < INR; ++k) I[k] *= sc;
      }
      // f_bias = I zeta + v x* (I v)
      float Iv[6], Iz[6], a1[3], a2[3], a3[3];
      inertia_matvec(I, v, Iv);
      inertia_matvec(I, zeta[i], Iz);
      cross3(v, Iv, a1);
      cross3(v + 3, Iv + 3, a2);
      cross3(v, Iv + 3, a3);
      for (int k = 0; k < 3; ++k) {
        f[i][k] = Iz[k] + (a1[k] + a2[k]);
        f[i][3 + k] = Iz[3 + k] + a3[k];
      }
      for (int j = 0; j < 6; ++j) w[i][j] = 0.0f;
    }

    // ---- CRBA: composite inertias, chain entries of M ----------------------
    for (int i = nbody - 1; i > 0; --i) {
      const int par = cI.parent[i];
      if (par >= 0)
        for (int k = 0; k < INR; ++k) Ic[par][k] += Ic[i][k];
    }
    for (int d = 0; d < nv; ++d) {
      float F[6];
      inertia_matvec(Ic[cI.dof_body[d]], cols[d], F);
      for (int j = d; j != -1; j = cI.lam[j]) M[d][j] = dot6(cols[j], F);
      const float arm = dr.armature_scale ? cF.dof_armature[d] * dr.armature_scale[b]
                                          : cF.dof_armature[d];
      M[d][d] += arm;
    }

    // ---- penalty contacts with stick-slip anchors --------------------------
    for (int c = 0; c < ncon; ++c) {
      const int bd = cI.con_body[c];
      float kn = cF.con_k[c], dn = cF.con_d[c];
      if (dr.contact_stiffness_scale) {
        const float om = cF.omega_c * dr.contact_stiffness_scale[b];
        kn = fminf(cF.con_meff[c] * (om * om), cF.con_kcap[c]);
        dn = fminf(cF.con_dw[c] * om, cF.con_dcap[c]);
      }
      float xo[3], xc[3];
      matvec3(R[bd], cF.con_pos[c], xo);
      for (int k = 0; k < 3; ++k) xc[k] = p[bd][k] + xo[k];
      if (s == 0 && !have_anchors) {
        anchor[c][0] = xc[0];
        anchor[c][1] = xc[1];
      }
      const float depth = cF.con_radius[c] - xc[2];
      const bool in_contact = depth > 0.0f;
      float wx[3], vpt[3];
      cross3(vel[bd], xc, wx);
      for (int k = 0; k < 3; ++k) vpt[k] = vel[bd][3 + k] + wx[k];
      float fn = in_contact ? kn * depth - dn * vpt[2] : 0.0f;
      fn = fmaxf(fn, 0.0f);
      const float mu = dr.friction_scale ? cF.con_friction[c] * dr.friction_scale[b]
                                         : cF.con_friction[c];
      const float f_max = mu * fn;
      const float kt = cF.con_kt[c], ct = cF.con_ct[c];
      float ax = in_contact ? anchor[c][0] : xc[0];
      float ay = in_contact ? anchor[c][1] : xc[1];
      const float dx = xc[0] - ax, dy = xc[1] - ay;
      const float ftx = -(kt * dx + ct * vpt[0]);
      const float fty = -(kt * dy + ct * vpt[1]);
      const float ft_norm = sqrtf(ftx * ftx + fty * fty);
      const float cone = fminf(1.0f, f_max / (ft_norm + 1e-9f));
      const float disp_norm = sqrtf(dx * dx + dy * dy);
      const float max_disp = f_max / kt;
      const float slide = fminf(1.0f, max_disp / (disp_norm + 1e-9f));
      anchor[c][0] = in_contact ? xc[0] - dx * slide : xc[0];
      anchor[c][1] = in_contact ? xc[1] - dy * slide : xc[1];
      const float fc[3] = {ftx * cone, fty * cone, fn};
      float mom[3];
      cross3(xc, fc, mom);
      for (int k = 0; k < 3; ++k) {
        w[bd][k] += mom[k];
        w[bd][3 + k] += fc[k];
      }
    }

    // ---- backward wrench accumulation, generalized bias C -------------------
    for (int i = 0; i < nbody; ++i)
      for (int j = 0; j < 6; ++j) f[i][j] = f[i][j] - w[i][j];
    for (int i = nbody - 1; i > 0; --i) {
      const int par = cI.parent[i];
      if (par >= 0)
        for (int j = 0; j < 6; ++j) f[par][j] += f[i][j];
    }

    // ---- generalized forces: x = tau - C -----------------------------------
    float tau[MAX_NV];
    for (int d = 0; d < nv; ++d) tau[d] = 0.0f;
    for (int a = 0; a < nu; ++a) {
      const int d = cI.act_dof[a];
      const float u = ctrl_s[(size_t)a * B + b];
      float force;
      if (cI.act_is_position[a]) {
        const float kp = dr.kp_scale ? cF.act_kp[a] * dr.kp_scale[(size_t)a * B + b] : cF.act_kp[a];
        const float kv = dr.kv_scale ? cF.act_kv[a] * dr.kv_scale[(size_t)a * B + b] : cF.act_kv[a];
        const float target = dr.ctrl_offset ? u + dr.ctrl_offset[(size_t)a * B + b] : u;
        force = kp * (target - qpos[cI.act_qpos[a]]) - kv * qvel[d];
      } else {
        force = u * cF.act_gear[a];
      }
      float lo = cF.act_lo[a], hi = cF.act_hi[a];
      if (dr.forcerange_scale) {
        const float sc = dr.forcerange_scale[(size_t)a * B + b];
        lo *= sc;
        hi *= sc;
      }
      force = fminf(fmaxf(force, lo), hi);
      tau[d] += force * (cI.act_is_position[a] ? cF.act_gear[a] : 1.0f);
    }
    const float damp_s = dr.damping_scale ? dr.damping_scale[b] : 1.0f;
    const float fl_s = dr.frictionloss_scale ? dr.frictionloss_scale[b] : 1.0f;
    for (int d = 0; d < nv; ++d) {
      const float damping = dr.damping_scale ? cF.dof_damping[d] * damp_s : cF.dof_damping[d];
      const float fl = dr.frictionloss_scale ? cF.dof_frictionloss[d] * fl_s : cF.dof_frictionloss[d];
      tau[d] = tau[d] - damping * qvel[d];
      tau[d] = tau[d] - fl * tanhf(qvel[d] / 0.05f);
    }
    for (int i = 0; i < nbody; ++i) {
      if (cI.jnt_type[i] != JNT_HINGE || !cI.jnt_limited[i]) continue;
      const int qa = cI.qpos_adr[i], d = cI.dof_adr[i];
      const float over_hi = fmaxf(qpos[qa] - cF.jnt_hi[i], 0.0f);
      const float under_lo = fmaxf(cF.jnt_lo[i] - qpos[qa], 0.0f);
      const bool engaged = (over_hi > 0.0f) || (under_lo > 0.0f);
      tau[d] += cF.limit_stiffness * (under_lo - over_hi) - (engaged ? cF.jnt_dlim[i] * qvel[d] : 0.0f);
    }
    for (int d = 0; d < nv; ++d) x[d] = tau[d] - dot6(cols[d], f[cI.dof_body[d]]);

    // ---- tree-sparse LTDL: M = L^T D L, in place on the chain entries -------
    float inv_d[MAX_NV];
    for (int k = nv - 1; k >= 0; --k) {
      inv_d[k] = 1.0f / M[k][k];
      for (int i = cI.lam[k]; i != -1; i = cI.lam[i]) {
        const float a = M[k][i] * inv_d[k];
        for (int j = i; j != -1; j = cI.lam[j]) M[i][j] = M[i][j] - a * M[k][j];
        M[k][i] = a;
      }
    }
    for (int i = nv - 1; i >= 0; --i)
      for (int j = cI.lam[i]; j != -1; j = cI.lam[j]) x[j] = x[j] - M[i][j] * x[i];
    for (int k = 0; k < nv; ++k) x[k] = x[k] * inv_d[k];
    for (int i = 0; i < nv; ++i)
      for (int j = cI.lam[i]; j != -1; j = cI.lam[j]) x[i] = x[i] - M[i][j] * x[j];

    // ---- semi-implicit Euler ------------------------------------------------
    for (int d = 0; d < nv; ++d) qvel[d] = qvel[d] + dt * x[d];
    for (int i = 0; i < nbody; ++i) {
      const int jt = cI.jnt_type[i];
      const int qa = cI.qpos_adr[i], d = cI.dof_adr[i];
      if (jt == JNT_FREE) {
        for (int k = 0; k < 3; ++k) qpos[qa + k] = qpos[qa + k] + dt * qvel[d + k];
        const float wx = qvel[d + 3], wy = qvel[d + 4], wz = qvel[d + 5];
        const float speed = sqrtf(wx * wx + wy * wy + wz * wz);
        const float half = 0.5f * (speed * dt);
        const float safe = fmaxf(speed, 1e-9f);
        float sh, ch;
        sincosf(half, &sh, &ch);
        const float bw = ch, bx = (wx / safe) * sh, by = (wy / safe) * sh, bz = (wz / safe) * sh;
        const float aw = qpos[qa + 3], ax = qpos[qa + 4], ay = qpos[qa + 5], az = qpos[qa + 6];
        float ow = aw * bw - ax * bx - ay * by - az * bz;
        float ox = aw * bx + ax * bw + ay * bz - az * by;
        float oy = aw * by - ax * bz + ay * bw + az * bx;
        float oz = aw * bz + ax * by - ay * bx + az * bw;
        const float n = sqrtf(ow * ow + ox * ox + oy * oy + oz * oz);
        qpos[qa + 3] = ow / n;
        qpos[qa + 4] = ox / n;
        qpos[qa + 5] = oy / n;
        qpos[qa + 6] = oz / n;
      } else if (jt == JNT_HINGE) {
        qpos[qa] = qpos[qa] + dt * qvel[d];
      }
    }
  }

  for (int k = 0; k < nq; ++k) qpos_out[(size_t)k * B + b] = qpos[k];
  for (int k = 0; k < nv; ++k) qvel_out[(size_t)k * B + b] = qvel[k];
  if (anchors_out != nullptr)
    for (int c = 0; c < ncon; ++c) {
      anchors_out[((size_t)c * 2 + 0) * B + b] = anchor[c][0];
      anchors_out[((size_t)c * 2 + 1) * B + b] = anchor[c][1];
    }
}

extern "C" void rlx_engine_table_sizes(int* size_i, int* size_f, int* maxima) {
  *size_i = (int)sizeof(ModelI);
  *size_f = (int)sizeof(ModelF);
  maxima[0] = MAX_NBODY;
  maxima[1] = MAX_NQ;
  maxima[2] = MAX_NV;
  maxima[3] = MAX_NU;
  maxima[4] = MAX_NCON;
}

extern "C" int rlx_engine_substep(const void* model_i, const void* model_f,
                                  const float* qpos_in, const float* qvel_in,
                                  const float* ctrl, int ctrl_per_substep,
                                  const float* anchors_in,
                                  float* qpos_out, float* qvel_out, float* anchors_out,
                                  const float* const* dr_fields,  // 11 host pointers, null = none
                                  int B, int nr_substeps, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = cudaMemcpyToSymbolAsync(cI, model_i, sizeof(ModelI), 0,
                                            cudaMemcpyHostToDevice, s);
  if (err != cudaSuccess) return (int)err;
  err = cudaMemcpyToSymbolAsync(cF, model_f, sizeof(ModelF), 0, cudaMemcpyHostToDevice, s);
  if (err != cudaSuccess) return (int)err;
  DomainPtrs dr;
  dr.mass_scale = dr_fields[0];
  dr.damping_scale = dr_fields[1];
  dr.frictionloss_scale = dr_fields[2];
  dr.armature_scale = dr_fields[3];
  dr.friction_scale = dr_fields[4];
  dr.contact_stiffness_scale = dr_fields[5];
  dr.kp_scale = dr_fields[6];
  dr.kv_scale = dr_fields[7];
  dr.forcerange_scale = dr_fields[8];
  dr.ctrl_offset = dr_fields[9];
  dr.gravity = dr_fields[10];
  const int threads = 32;
  const int blocks = (B + threads - 1) / threads;
  if (B > 0)
    engine_substep_kernel<<<blocks, threads, 0, s>>>(qpos_in, qvel_in, ctrl, ctrl_per_substep,
                                                     anchors_in, qpos_out, qvel_out,
                                                     anchors_out, dr, B, nr_substeps);
  return (int)cudaGetLastError();
}
