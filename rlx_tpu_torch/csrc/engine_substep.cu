// Physics substeps, a group of lanes per env, with the env's state in
// shared memory.
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
// Bound: operations.  Per env-substep the Ant needs ~9,600 f32 operations
// (ops/engine_substep_cuda.py::substep_flops) against ~250 bytes of state
// moved per launch (qpos, qvel, ctrl, anchors in and out once), so the
// card's f32 rate bounds it, not its memory.
//
// Design.  An earlier kernel ran one thread per env in blocks of 32: one
// warp per SM at B=4096, its ~2,000 floats of per-env arrays (sized by
// compile-time caps, indexed at run time) in local memory, its model tables
// in __constant__ memory copied from the host before every launch, and
// batch-last I/O that cost the wrapper a transpose of each input.  Here:
//
// 1. Parallelism: GROUP lanes per env (32, one warp; or 16, two envs a
//    warp, which the wrapper picks once a batch fills the SMs), BLOCK_THREADS
//    / GROUP envs per block, so B=4096 runs 2048-4096 warps.  The lanes
//    split each phase over the tree's parallel work: FK and the velocity
//    recursion level by level over (body in level x row); the Jacobian
//    columns over dofs; spatial inertias and bias wrenches over bodies;
//    composite inertias and the backward wrench sums deepest level first
//    over (parent x chunk of entries), each lane adding the children in a
//    fixed order (no atomics); M's chain entries over the (d, j) list;
//    contacts, actuators and the integrator over contacts, dofs and bodies;
//    the LTDL factor and both solves over the targets of a host-made
//    schedule (dofs grouped by height in the dof tree, so disjoint subtrees
//    factor together; the root free joint's dense 6x6 block by one lane in
//    registers).  Phases are separated by __syncwarp().
// 2. Per-env state lives in dynamic shared memory, laid out by the host
//    from the model's counts (nbody, nq, nv, ncon, chain entries): no array
//    is sized by a compile-time cap, M and its factor L are lists of the
//    chain entries, and nothing per env goes to local memory.  (ptxas still
//    reports a 32-byte stack frame: sincosf's slow path for |x| > 105615
//    reduces its argument in a local array.)
// 3. Model tables and the schedule are one flat 32-bit device buffer
//    (floats bit-cast), built and uploaded once per model by the wrapper
//    and copied into shared memory once per block (16 bytes a thread).  Its
//    header holds scalars and section offsets and also travels as the
//    kernel parameter H, so the offsets are operands, not loads.
//    TABLE_SCALARS / TABLE_SECTIONS below name them, and the wrapper checks
//    its own list against rlx_engine_table_names() when it loads the
//    library.  Nothing is copied from the host per launch.
// 4. Batch-first I/O: qpos [B, nq], qvel [B, nv], ctrl [B, nu] or
//    [S, B, nu], anchors [B, ncon, 2] are read and written as the caller
//    holds them; lane k of env b touches element k of row b (coalesced).
//    DomainParams fields keep their batch-last shapes ([nbody, B], [B],
//    ...) and come as optional pointers (null = the model's value).
//
// Sums run in the plain version's order wherever they reduce over the tree
// (children in descending index, contacts ascending); the LTDL applies a
// group's updates in descending dof order inside each group.

#include <cuda_runtime.h>
#include <math.h>

#define BLOCK_THREADS 128  // GROUP lanes per env, BLOCK_THREADS / GROUP envs per block

#define JNT_FREE 0
#define JNT_HINGE 3
#define INR 13  // compact spatial inertia: [0..8] TL row-major, [9..11] h = m*com, [12] m

// Header scalars (floats bit-cast), then one offset per section, all in
// 32-bit words from the start of the table; o_* are offsets in floats
// into an env's region of shared memory.  The header also travels as a
// kernel parameter (Header, in the parameter bank): the offsets become
// operands of the address arithmetic instead of shared-memory loads.
#define TABLE_SCALARS(X)                                                       \
  X(nbody) X(nq) X(nv) X(nu) X(ncon) X(nent) X(free_block) X(nlevel) X(ngroup) \
  X(ndepth) X(env_floats) X(timestep) X(gravity_x) X(gravity_y) X(gravity_z)   \
  X(omega_c) X(limit_stiffness) X(o_qpos) X(o_qvel) X(o_anchor) X(o_gneg)      \
  X(o_R) X(o_p) X(o_cols) X(o_vel) X(o_mov) X(o_zeta) X(o_Ic) X(o_f) X(o_wc)  \
  X(o_M) X(o_L) X(o_x) X(o_inv_d)

#define TABLE_SECTIONS(X)                                                      \
  X(parent) X(jnt_type) X(qpos_adr) X(dof_adr) X(frame_identity) X(frame_rot) \
  X(body_pos) X(icom_rot) X(body_ipos) X(body_mass) X(body_inertia)           \
  X(jnt_axis) X(jnt_pos) X(level_start) X(level_body)                         \
  X(child_start) X(child_list) X(bcon_start) X(bcon_list) X(dof_body)         \
  X(dof_armature) X(dof_damping) X(dof_frictionloss) X(dof_limited)           \
  X(dof_qadr) X(dof_lo) X(dof_hi) X(dof_dlim) X(dact_start) X(dact_list)      \
  X(ent_start) X(ent_d) X(ent_j) X(act_qpos) X(act_is_position) X(act_kp)     \
  X(act_kv) X(act_gear) X(act_lo) X(act_hi) X(con_body) X(con_pos)            \
  X(con_radius) X(con_friction) X(con_k) X(con_d) X(con_meff) X(con_dw)       \
  X(con_kcap) X(con_dcap) X(con_kt) X(con_ct) X(grp_start) X(grp_ent)         \
  X(grp_diag) X(ftgt_start) X(ftgt_entry) X(ftgt_cstart) X(fc_ki) X(fc_kj)    \
  X(stgt_start) X(stgt_dof) X(stgt_cstart) X(sc_e) X(sc_i) X(depth_start)     \
  X(depth_dof)

#define X_ENUM_S(n) S_##n,
#define X_ENUM_T(n) T_##n,
#define X_NAME(n) #n ","
enum { TABLE_SCALARS(X_ENUM_S) S_COUNT };
enum { TABLE_SECTIONS(X_ENUM_T) T_COUNT };

struct Header {
  int w[S_COUNT + T_COUNT];
};

// int and float sections of the table, a scalar, an env array
#define TI(sec) (tab + H.w[S_COUNT + T_##sec])
#define TF(sec) (reinterpret_cast<const float*>(tab + H.w[S_COUNT + T_##sec]))
#define SI(name) (H.w[S_##name])
#define SF(name) (__int_as_float(H.w[S_##name]))
#define E(name) (env + H.w[S_o_##name])

// Per-phase cycle counts of lane 0 of every env's group, in a build with
// -DRLX_PHASE_CLOCKS (rlx_tpu_torch/benchmarks/substep_phases.py): summed
// per block in shared memory, then once per block into the device counters;
// a no-op otherwise.
#ifdef RLX_PHASE_CLOCKS
#define NPHASE 13
__device__ unsigned long long rlx_phase_cycles[NPHASE];
#define PHASE(k)                                                   \
  if (lane == 0) {                                                 \
    const long long now = clock64();                               \
    atomicAdd(&phase_sum[k], (unsigned long long)(now - t_last));  \
    t_last = now;                                                  \
  }
#else
#define PHASE(k)
#endif

// The loops over a phase's items and the inner loops over schedule lists
// stay rolled: their trip counts come from the model, and the compiler's
// unrolled copies doubled the kernel's code and ran slower.
#define LANES(it, n) _Pragma("unroll 1") for (int it = lane; it < (n); it += GROUP)

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

__device__ __forceinline__ float pick3(int n, float a, float b, float c) {
  return n == 0 ? a : (n == 1 ? b : c);
}

// FK of one level, lanes over (body, row m): row m of R and p[m].
// R_frame = R_par @ frame_rot; a hinge about axis a turns it by
// 1 + sin K + (1 - cos) K^2 with K = skew(a), K^2 = a a^T - (a . a) 1, so
// that row f of R_frame becomes f + sin (f x a) + (1 - cos) ((f . a) a -
// (a . a) f), and moves p by (R_frame - R) jnt_pos; a free joint takes R
// and p from qpos; a jointless body keeps the frame.
template <int GROUP>
__device__ __forceinline__ void fk_level(const Header& H, const int* tab, float* env, int L,
                                         int lane) {
  const int l0 = TI(level_start)[L], nl = TI(level_start)[L + 1] - l0;
  const float* q = E(qpos);
  float* R = E(R);
  float* p = E(p);
  LANES(it, nl * 3) {
    const int i = TI(level_body)[l0 + it / 3], m = it % 3;
    const int par = TI(parent)[i];
    const int jt = TI(jnt_type)[i];
    const int qa = TI(qpos_adr)[i];
    float* Rm = R + i * 9 + m * 3;
    if (jt == JNT_FREE) {
      const float qw = q[qa + 3], qx = q[qa + 4], qy = q[qa + 5], qz = q[qa + 6];
      Rm[0] = pick3(m, 1 - 2 * (qy * qy + qz * qz), 2 * (qx * qy + qw * qz), 2 * (qx * qz - qw * qy));
      Rm[1] = pick3(m, 2 * (qx * qy - qw * qz), 1 - 2 * (qx * qx + qz * qz), 2 * (qy * qz + qw * qx));
      Rm[2] = pick3(m, 2 * (qx * qz + qw * qy), 2 * (qy * qz - qw * qx), 1 - 2 * (qx * qx + qy * qy));
      p[i * 3 + m] = q[qa + m];
      continue;
    }
    float rp0, rp1, rp2, ppm;  // row m of R_par, p_par[m]
    if (par >= 0) {
      rp0 = R[par * 9 + m * 3 + 0];
      rp1 = R[par * 9 + m * 3 + 1];
      rp2 = R[par * 9 + m * 3 + 2];
      ppm = p[par * 3 + m];
    } else {
      rp0 = m == 0 ? 1.0f : 0.0f;
      rp1 = m == 1 ? 1.0f : 0.0f;
      rp2 = m == 2 ? 1.0f : 0.0f;
      ppm = 0.0f;
    }
    float rf0 = rp0, rf1 = rp1, rf2 = rp2;  // row m of R_frame
    if (!TI(frame_identity)[i]) {
      const float* C = TF(frame_rot) + 9 * i;
      rf0 = rp0 * C[0] + rp1 * C[3] + rp2 * C[6];
      rf1 = rp0 * C[1] + rp1 * C[4] + rp2 * C[7];
      rf2 = rp0 * C[2] + rp1 * C[5] + rp2 * C[8];
    }
    const float* bp = TF(body_pos) + 3 * i;
    const float pfm = ppm + (rp0 * bp[0] + rp1 * bp[1] + rp2 * bp[2]);
    if (jt == JNT_HINGE) {
      float sn, cs;
      sincosf(q[qa], &sn, &cs);
      const float* a = TF(jnt_axis) + 3 * i;
      const float a0 = a[0], a1 = a[1], a2 = a[2];
      const float fa = rf0 * a0 + rf1 * a1 + rf2 * a2, aa = a0 * a0 + a1 * a1 + a2 * a2;
      const float omc = 1.0f - cs;
      float r[3];
      r[0] = rf0 + sn * (rf1 * a2 - rf2 * a1) + omc * (fa * a0 - aa * rf0);
      r[1] = rf1 + sn * (rf2 * a0 - rf0 * a2) + omc * (fa * a1 - aa * rf1);
      r[2] = rf2 + sn * (rf0 * a1 - rf1 * a0) + omc * (fa * a2 - aa * rf2);
      for (int n = 0; n < 3; ++n) Rm[n] = r[n];
      const float* jp = TF(jnt_pos) + 3 * i;
      p[i * 3 + m] = pfm + ((rf0 - r[0]) * jp[0] + (rf1 - r[1]) * jp[1] + (rf2 - r[2]) * jp[2]);
    } else {
      Rm[0] = rf0;
      Rm[1] = rf1;
      Rm[2] = rf2;
      p[i * 3 + m] = pfm;
    }
  }
  __syncwarp();
}

// Velocities and velocity-product accelerations of one level, lanes over
// (body, k < 3): v = v_par + own, stored at components k and 3 + k, and
// zeta = zeta_par + v x mov at the same two, from the own and moving parts
// the velocity phase stored for every body (own in Ic's words, which are
// free until the inertia phase).
template <int GROUP>
__device__ __forceinline__ void velocity_level(const Header& H, const int* tab, float* env,
                                               int L, int lane) {
  const int l0 = TI(level_start)[L], nl = TI(level_start)[L + 1] - l0;
  const float* own = E(Ic);
  const float* mov = E(mov);
  float* vel = E(vel);
  LANES(it, nl * 3) {
    const int i = TI(level_body)[l0 + it / 3], k = it % 3;
    const int par = TI(parent)[i];
    const int k1 = (k + 1) % 3, k2 = (k + 2) % 3;
    const float* vp = vel + 6 * par;
    const float* o = own + 6 * i;
    const float* m = mov + 6 * i;
    const float w0 = (par >= 0 ? vp[k] : 0.0f) + o[k];
    const float w1 = (par >= 0 ? vp[k1] : 0.0f) + o[k1];
    const float w2 = (par >= 0 ? vp[k2] : 0.0f) + o[k2];
    const float u0 = (par >= 0 ? vp[3 + k] : 0.0f) + o[3 + k];
    const float u1 = (par >= 0 ? vp[3 + k1] : 0.0f) + o[3 + k1];
    const float u2 = (par >= 0 ? vp[3 + k2] : 0.0f) + o[3 + k2];
    const float c1 = w1 * m[k2] - w2 * m[k1];
    const float c2 = w1 * m[3 + k2] - w2 * m[3 + k1];
    const float c3 = u1 * m[k2] - u2 * m[k1];
    vel[i * 6 + k] = w0;
    vel[i * 6 + 3 + k] = u0;
    E(zeta)[i * 6 + k] = (par >= 0 ? E(zeta)[par * 6 + k] : 0.0f) + c1;
    E(zeta)[i * 6 + 3 + k] = (par >= 0 ? E(zeta)[par * 6 + 3 + k] : E(gneg)[k]) + (c2 + c3);
  }
  __syncwarp();
}

// Composite inertias and the backward wrench sums together, deepest level
// first, lanes over (parent in level L-1, chunk c < CHUNKS = GROUP / 4);
// chunk c holds entries c, c + CHUNKS, ... of the parent's 19 (0..12 its
// Ic, 13..18 its wrench f) in registers, and adds each child's in turn,
// children in descending index, as the plain version's loop from the last
// body down does.
template <int GROUP>
__device__ __forceinline__ void sum_children(const Header& H, const int* tab, float* env,
                                             int lane) {
  constexpr int ENTRIES = INR + 6, CHUNKS = GROUP / 4, PER = (ENTRIES + CHUNKS - 1) / CHUNKS;
  for (int L = SI(nlevel) - 1; L > 0; --L) {
    const int l0 = TI(level_start)[L - 1], nl = TI(level_start)[L] - l0;
    LANES(it, nl * CHUNKS) {
      const int q = TI(level_body)[l0 + it / CHUNKS], chunk = it % CHUNKS;
      const int c0 = TI(child_start)[q], c1 = TI(child_start)[q + 1];
      if (c0 == c1) continue;
      float* buf[PER];
      int width[PER];
      float acc[PER];
#pragma unroll
      for (int n = 0; n < PER; ++n) {
        const int k = chunk + CHUNKS * n;
        buf[n] = k < INR ? E(Ic) + k : E(f) + (k - INR);
        width[n] = k < INR ? INR : 6;
        acc[n] = k < ENTRIES ? buf[n][q * width[n]] : 0.0f;
      }
#pragma unroll 1
      for (int c = c0; c < c1; ++c) {
        const int ch = TI(child_list)[c];
#pragma unroll
        for (int n = 0; n < PER; ++n)
          if (chunk + CHUNKS * n < ENTRIES) acc[n] += buf[n][ch * width[n]];
      }
#pragma unroll
      for (int n = 0; n < PER; ++n)
        if (chunk + CHUNKS * n < ENTRIES) buf[n][q * width[n]] = acc[n];
    }
    __syncwarp();
  }
}

// Entry (d, j), j <= d < 6, of the root free joint's dense 6x6 block of M:
// its chain entries are the first 21 of the list, row by row, each row from
// the diagonal down.
#define BLK(d, j) ((d) * ((d) + 1) / 2 + (d) - (j))

// At least 5 blocks an SM (20 warps, what shared memory allows the 16-lane
// variant on the Ant) leaves ptxas up to 102 registers a thread; without a
// minimum it kept to 48 and spilled.
template <int GROUP>
__global__ void __launch_bounds__(BLOCK_THREADS, 5)
engine_substep_kernel(const __grid_constant__ Header H,
                      const int* __restrict__ table, int table_words,
                      const float* __restrict__ qpos_in,   // [B, nq]
                      const float* __restrict__ qvel_in,   // [B, nv]
                      const float* __restrict__ ctrl,      // [S, B, nu] or [B, nu]
                      int ctrl_per_substep,
                      const float* __restrict__ anchors_in,  // [B, ncon, 2] or null
                      float* __restrict__ qpos_out,
                      float* __restrict__ qvel_out,
                      float* __restrict__ anchors_out,     // [B, ncon, 2] or null
                      DomainPtrs dr, int B, int nr_substeps) {
  extern __shared__ __align__(16) int smem[];
  // table_words is a multiple of 4 (the wrapper pads the table)
  for (int k = threadIdx.x; k < table_words / 4; k += blockDim.x)
    reinterpret_cast<int4*>(smem)[k] = reinterpret_cast<const int4*>(table)[k];
#ifdef RLX_PHASE_CLOCKS
  __shared__ unsigned long long phase_sum[NPHASE];
  if (threadIdx.x < NPHASE) phase_sum[threadIdx.x] = 0;
#endif
  __syncthreads();
  const int* tab = smem;
  const int lane = threadIdx.x % GROUP;
  const int slot = threadIdx.x / GROUP;
  // Past the ragged end a group recomputes env B - 1 and stores nothing, so
  // that every lane of a warp reaches each __syncwarp().
  const bool active = blockIdx.x * (BLOCK_THREADS / GROUP) + slot < B;
  const int b = active ? blockIdx.x * (BLOCK_THREADS / GROUP) + slot : B - 1;
  float* env = reinterpret_cast<float*>(smem + table_words) + slot * SI(env_floats);
#ifdef RLX_PHASE_CLOCKS
  long long t_last = clock64();
#endif

  const int nbody = SI(nbody), nq = SI(nq), nv = SI(nv), nu = SI(nu), ncon = SI(ncon);
  const float dt = SF(timestep);
  const bool have_anchors = anchors_in != nullptr;
  float* qp = E(qpos);
  float* qv = E(qvel);
  LANES(k, nq) qp[k] = qpos_in[(size_t)b * nq + k];
  LANES(k, nv) qv[k] = qvel_in[(size_t)b * nv + k];
  if (have_anchors) LANES(k, 2 * ncon) E(anchor)[k] = anchors_in[(size_t)b * 2 * ncon + k];
  if (lane < 3)
    E(gneg)[lane] = dr.gravity ? -dr.gravity[(size_t)lane * B + b]
                               : -pick3(lane, SF(gravity_x), SF(gravity_y), SF(gravity_z));
  __syncwarp();
  PHASE(0)

  for (int s = 0; s < nr_substeps; ++s) {
    // ---- forward kinematics, level by level ---------------------------------
    for (int L = 0; L < SI(nlevel); ++L) fk_level<GROUP>(H, tab, env, L, lane);
    PHASE(1)

    // ---- world Jacobian columns, lanes over dofs ---------------------------
    LANES(d, nv) {
      const int i = TI(dof_body)[d];
      const int k = d - TI(dof_adr)[i];
      const float* Ri = E(R) + 9 * i;
      const float pi[3] = {E(p)[3 * i], E(p)[3 * i + 1], E(p)[3 * i + 2]};
      float* col = E(cols) + 6 * d;
      float a[3], pa[3];
      if (TI(jnt_type)[i] == JNT_FREE) {
        if (k < 3) {
          for (int j = 0; j < 6; ++j) col[j] = j == 3 + k ? 1.0f : 0.0f;
          continue;
        }
        for (int j = 0; j < 3; ++j) a[j] = Ri[j * 3 + k - 3];
        cross3(pi, a, pa);
      } else {
        float off[3], anc[3];
        matvec3(Ri, TF(jnt_axis) + 3 * i, a);
        matvec3(Ri, TF(jnt_pos) + 3 * i, off);
        for (int j = 0; j < 3; ++j) anc[j] = pi[j] + off[j];
        cross3(anc, a, pa);
      }
      for (int j = 0; j < 3; ++j) {
        col[j] = a[j];
        col[3 + j] = pa[j];
      }
    }
    __syncwarp();
    PHASE(2)

    // ---- velocities and velocity-product accelerations ---------------------
    // each body's own part J_i qdot_i and moving part (the angular dofs'
    // share for a free joint), lanes over (body, component), then the
    // recursion level by level
    LANES(it, nbody * 6) {
      const int i = it / 6, j = it % 6;
      const int jt = TI(jnt_type)[i], d = TI(dof_adr)[i];
      const float* cols = E(cols);
      float own = 0.0f, mov = 0.0f;
      if (jt == JNT_FREE) {
        for (int n = 0; n < 6; ++n) own += cols[(d + n) * 6 + j] * qv[d + n];
        for (int n = 3; n < 6; ++n) mov += cols[(d + n) * 6 + j] * qv[d + n];
      } else if (jt == JNT_HINGE) {
        own = cols[d * 6 + j] * qv[d];
        mov = own;
      }
      E(Ic)[i * 6 + j] = own;
      E(mov)[i * 6 + j] = mov;
    }
    __syncwarp();
    for (int L = 0; L < SI(nlevel); ++L) velocity_level<GROUP>(H, tab, env, L, lane);
    PHASE(3)

    // ---- penalty contacts with stick-slip anchors, lanes over contacts ------
    LANES(c, ncon) {
      const int bd = TI(con_body)[c];
      float kn = TF(con_k)[c], dn = TF(con_d)[c];
      if (dr.contact_stiffness_scale) {
        const float om = SF(omega_c) * dr.contact_stiffness_scale[b];
        kn = fminf(TF(con_meff)[c] * (om * om), TF(con_kcap)[c]);
        dn = fminf(TF(con_dw)[c] * om, TF(con_dcap)[c]);
      }
      const float* vb = E(vel) + 6 * bd;
      float* anchor = E(anchor) + 2 * c;
      float xo[3], xc[3];
      matvec3(E(R) + 9 * bd, TF(con_pos) + 3 * c, xo);
      for (int k = 0; k < 3; ++k) xc[k] = E(p)[3 * bd + k] + xo[k];
      if (s == 0 && !have_anchors) {
        anchor[0] = xc[0];
        anchor[1] = xc[1];
      }
      const float depth = TF(con_radius)[c] - xc[2];
      const bool in_contact = depth > 0.0f;
      float wx[3], vpt[3];
      cross3(vb, xc, wx);
      for (int k = 0; k < 3; ++k) vpt[k] = vb[3 + k] + wx[k];
      float fn = in_contact ? kn * depth - dn * vpt[2] : 0.0f;
      fn = fmaxf(fn, 0.0f);
      const float mu = dr.friction_scale ? TF(con_friction)[c] * dr.friction_scale[b]
                                         : TF(con_friction)[c];
      const float f_max = mu * fn;
      const float kt = TF(con_kt)[c], ct = TF(con_ct)[c];
      const float ax = in_contact ? anchor[0] : xc[0];
      const float ay = in_contact ? anchor[1] : xc[1];
      const float dx = xc[0] - ax, dy = xc[1] - ay;
      const float ftx = -(kt * dx + ct * vpt[0]);
      const float fty = -(kt * dy + ct * vpt[1]);
      const float ft_norm = sqrtf(ftx * ftx + fty * fty);
      const float cone = fminf(1.0f, f_max / (ft_norm + 1e-9f));
      const float disp_norm = sqrtf(dx * dx + dy * dy);
      const float max_disp = f_max / kt;
      const float slide = fminf(1.0f, max_disp / (disp_norm + 1e-9f));
      anchor[0] = in_contact ? xc[0] - dx * slide : xc[0];
      anchor[1] = in_contact ? xc[1] - dy * slide : xc[1];
      const float fc[3] = {ftx * cone, fty * cone, fn};
      float mom[3];
      cross3(xc, fc, mom);
      float* wc = E(wc) + 6 * c;
      for (int k = 0; k < 3; ++k) {
        wc[k] = mom[k];
        wc[3 + k] = fc[k];
      }
    }
    __syncwarp();
    PHASE(4)

    // ---- spatial inertias and net wrenches, lanes over bodies ---------------
    // f = I zeta + v x* (I v) - (the body's contact wrenches, ascending)
    LANES(i, nbody) {
      const float* Ri = E(R) + 9 * i;
      const float* bi = TF(body_inertia) + 3 * i;
      float Ricom[9], S[9], com[3], t3[3];
      matmul3(Ri, TF(icom_rot) + 9 * i, Ricom);
      for (int m = 0; m < 3; ++m)
        for (int n = 0; n < 3; ++n) S[m * 3 + n] = Ricom[m * 3 + n] * bi[n];
      matvec3(Ri, TF(body_ipos) + 3 * i, t3);
      for (int k = 0; k < 3; ++k) com[k] = E(p)[3 * i + k] + t3[k];
      const float mass = TF(body_mass)[i];
      const float sc = dr.mass_scale ? dr.mass_scale[(size_t)i * B + b] : 1.0f;
      // c c^T with c = skew(com)
      const float cc[9] = {
          com[2] * com[2] + com[1] * com[1], -com[1] * com[0], -com[2] * com[0],
          -com[0] * com[1], com[2] * com[2] + com[0] * com[0], -com[2] * com[1],
          -com[0] * com[2], -com[1] * com[2], com[1] * com[1] + com[0] * com[0]};
      float I[INR];
      for (int m = 0; m < 3; ++m)
        for (int n = 0; n < 3; ++n) {
          // I_c = (Ricom diag(I)) Ricom^T
          const float ic = S[m * 3 + 0] * Ricom[n * 3 + 0] + S[m * 3 + 1] * Ricom[n * 3 + 1] +
                           S[m * 3 + 2] * Ricom[n * 3 + 2];
          const float tl = ic + mass * cc[m * 3 + n];
          I[m * 3 + n] = tl * sc;
        }
      for (int k = 0; k < 3; ++k) {
        const float h = mass * com[k];
        I[9 + k] = h * sc;
      }
      I[12] = mass * sc;
      for (int k = 0; k < INR; ++k) E(Ic)[INR * i + k] = I[k];

      float v[6], Iv[6], Iz[6], a1[3], a2[3], a3[3], fb[6];
      for (int k = 0; k < 6; ++k) v[k] = E(vel)[6 * i + k];
      inertia_matvec(I, v, Iv);
      inertia_matvec(I, E(zeta) + 6 * i, Iz);
      cross3(v, Iv, a1);
      cross3(v + 3, Iv + 3, a2);
      cross3(v, Iv + 3, a3);
      for (int k = 0; k < 3; ++k) {
        fb[k] = Iz[k] + (a1[k] + a2[k]);
        fb[3 + k] = Iz[3 + k] + a3[k];
      }
      float w[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll 1
      for (int c = TI(bcon_start)[i]; c < TI(bcon_start)[i + 1]; ++c) {
        const float* wc = E(wc) + 6 * TI(bcon_list)[c];
        for (int k = 0; k < 6; ++k) w[k] += wc[k];
      }
      for (int k = 0; k < 6; ++k) E(f)[6 * i + k] = fb[k] - w[k];
    }
    __syncwarp();
    PHASE(5)

    // ---- composite inertias and backward wrench sums ------------------------
    sum_children<GROUP>(H, tab, env, lane);
    PHASE(6)

    // ---- M's chain entries, lanes over dofs: F = Ic[body(d)] col_d in
    // registers, then M[d][j] = col_j . F along row d's chain (the diagonal,
    // first, with the armature)
    float* M = E(M);
    LANES(d, nv) {
      float F[6];
      inertia_matvec(E(Ic) + INR * TI(dof_body)[d], E(cols) + 6 * d, F);
      const int e0 = TI(ent_start)[d], e1 = TI(ent_start)[d + 1];
      const float arm = dr.armature_scale ? TF(dof_armature)[d] * dr.armature_scale[b]
                                          : TF(dof_armature)[d];
      M[e0] = dot6(E(cols) + 6 * d, F) + arm;
#pragma unroll 1
      for (int e = e0 + 1; e < e1; ++e) M[e] = dot6(E(cols) + 6 * TI(ent_j)[e], F);
    }
    PHASE(7)

    // ---- generalized forces x = tau - C, lanes over dofs ---------------------
    float* x = E(x);
    LANES(d, nv) {
      const float qvd = qv[d];
      float tau = 0.0f;
#pragma unroll 1
      for (int n = TI(dact_start)[d]; n < TI(dact_start)[d + 1]; ++n) {
        const int a = TI(dact_list)[n];
        const float u = ctrl[ctrl_per_substep ? ((size_t)s * B + b) * nu + a : (size_t)b * nu + a];
        const bool is_pos = TI(act_is_position)[a];
        const float gear = TF(act_gear)[a];
        float force;
        if (is_pos) {
          const float kp = dr.kp_scale ? TF(act_kp)[a] * dr.kp_scale[(size_t)a * B + b] : TF(act_kp)[a];
          const float kv = dr.kv_scale ? TF(act_kv)[a] * dr.kv_scale[(size_t)a * B + b] : TF(act_kv)[a];
          const float target = dr.ctrl_offset ? u + dr.ctrl_offset[(size_t)a * B + b] : u;
          force = kp * (target - qp[TI(act_qpos)[a]]) - kv * qvd;
        } else {
          force = u * gear;
        }
        float lo = TF(act_lo)[a], hi = TF(act_hi)[a];
        if (dr.forcerange_scale) {
          const float sc = dr.forcerange_scale[(size_t)a * B + b];
          lo *= sc;
          hi *= sc;
        }
        force = fminf(fmaxf(force, lo), hi);
        tau += force * (is_pos ? gear : 1.0f);
      }
      const float damping = dr.damping_scale ? TF(dof_damping)[d] * dr.damping_scale[b]
                                             : TF(dof_damping)[d];
      const float fl = dr.frictionloss_scale ? TF(dof_frictionloss)[d] * dr.frictionloss_scale[b]
                                             : TF(dof_frictionloss)[d];
      tau = tau - damping * qvd;
      tau = tau - fl * tanhf(qvd / 0.05f);
      if (TI(dof_limited)[d]) {
        const float qd = qp[TI(dof_qadr)[d]];
        const float over_hi = fmaxf(qd - TF(dof_hi)[d], 0.0f);
        const float under_lo = fmaxf(TF(dof_lo)[d] - qd, 0.0f);
        const bool engaged = (over_hi > 0.0f) || (under_lo > 0.0f);
        tau += SF(limit_stiffness) * (under_lo - over_hi) - (engaged ? TF(dof_dlim)[d] * qvd : 0.0f);
      }
      x[d] = tau - dot6(E(cols) + 6 * d, E(f) + 6 * TI(dof_body)[d]);
    }
    __syncwarp();
    PHASE(8)

    // ---- tree-sparse LTDL: M = L^T D L on the chain entries, and the solve
    // x = L^{-1} D^{-1} L^{-T} (tau - C) ------------------------------------
    // Group g holds the dofs of height g in the dof tree (outside the root
    // free joint's block): every descendant of a group's dof sits in an
    // earlier group, so the group's rows of M, and its dofs' entries of
    // L^{-T} x, are final.  Lanes over those rows' entries (k, i) take
    // 1 / D_k and L[k][i] = M[k][i] / D_k; then lanes over the group's
    // targets subtract, in descending k, L[k][i] M[k][j] from each target
    // entry (i, j) of M, and L[k][j] x[k] from each target x[j].  The root
    // free joint's dense 6x6 block (dofs 0..5, above every other dof) is
    // factored and solved last, by one lane in registers; the other rows'
    // D^{-1} and L^{-1} follow by depth (each row from its ancestors).
    float* inv_d = E(inv_d);
    float* Lk = E(L);
    for (int g = 0; g < SI(ngroup); ++g) {
      const int r0 = TI(grp_start)[g];
      LANES(it, TI(grp_start)[g + 1] - r0) {
        const int e = TI(grp_ent)[r0 + it], diag = TI(grp_diag)[r0 + it];
        const float inv = 1.0f / M[diag];
        if (e == diag)
          inv_d[TI(ent_d)[e]] = inv;
        else
          Lk[e] = M[e] * inv;
      }
      __syncwarp();
      const int t0 = TI(ftgt_start)[g], nt = TI(ftgt_start)[g + 1] - t0;
      const int s0 = TI(stgt_start)[g], ns = TI(stgt_start)[g + 1] - s0;
      LANES(it, nt + ns) {
        if (it < nt) {
          const int t = t0 + it;
          const int e = TI(ftgt_entry)[t];
          float val = M[e];
#pragma unroll 1
          for (int c = TI(ftgt_cstart)[t]; c < TI(ftgt_cstart)[t + 1]; ++c)
            val = val - Lk[TI(fc_ki)[c]] * M[TI(fc_kj)[c]];
          M[e] = val;
        } else {
          const int t = s0 + it - nt;
          const int j = TI(stgt_dof)[t];
          float val = x[j];
#pragma unroll 1
          for (int c = TI(stgt_cstart)[t]; c < TI(stgt_cstart)[t + 1]; ++c)
            val = val - Lk[TI(sc_e)[c]] * x[TI(sc_i)[c]];
          x[j] = val;
        }
      }
      __syncwarp();
    }
    if (SI(free_block) && lane == 0) {
      float A[21], id[6];
#pragma unroll
      for (int e = 0; e < 21; ++e) A[e] = M[e];
#pragma unroll
      for (int k = 5; k >= 0; --k) {
        id[k] = 1.0f / A[BLK(k, k)];
#pragma unroll
        for (int i = k - 1; i >= 0; --i) {
          const float a = A[BLK(k, i)] * id[k];
#pragma unroll
          for (int j = i; j >= 0; --j) A[BLK(i, j)] = A[BLK(i, j)] - a * A[BLK(k, j)];
          A[BLK(k, i)] = a;
        }
      }
#pragma unroll
      for (int e = 0; e < 21; ++e) Lk[e] = A[e];  // the diagonal's words are not read
#pragma unroll
      for (int k = 0; k < 6; ++k) inv_d[k] = id[k];
      // the block's L^T, D^{-1} and L on x[0..5], from what this lane stored
      float X[6];
#pragma unroll
      for (int k = 0; k < 6; ++k) X[k] = x[k];
#pragma unroll
      for (int i = 5; i >= 0; --i)
#pragma unroll
        for (int j = i - 1; j >= 0; --j) X[j] = X[j] - Lk[BLK(i, j)] * X[i];
#pragma unroll
      for (int k = 0; k < 6; ++k) X[k] = X[k] * inv_d[k];
#pragma unroll
      for (int i = 0; i < 6; ++i)
#pragma unroll
        for (int j = i - 1; j >= 0; --j) X[i] = X[i] - Lk[BLK(i, j)] * X[j];
#pragma unroll
      for (int k = 0; k < 6; ++k) x[k] = X[k];
    }
    __syncwarp();
    PHASE(9)

    for (int D = 0; D < SI(ndepth); ++D) {
      const int d0 = TI(depth_start)[D];
      LANES(it, TI(depth_start)[D + 1] - d0) {
        const int i = TI(depth_dof)[d0 + it];
        float val = x[i] * inv_d[i];
#pragma unroll 1
        for (int e = TI(ent_start)[i] + 1; e < TI(ent_start)[i + 1]; ++e)
          val = val - Lk[e] * x[TI(ent_j)[e]];
        x[i] = val;
      }
      __syncwarp();
    }
    PHASE(10)

    // ---- semi-implicit Euler, lanes over jointed bodies ----------------------
    LANES(i, nbody) {
      const int jt = TI(jnt_type)[i];
      const int qa = TI(qpos_adr)[i], d = TI(dof_adr)[i];
      if (jt == JNT_FREE) {
        float w[6];
        for (int k = 0; k < 6; ++k) {
          w[k] = qv[d + k] + dt * x[d + k];
          qv[d + k] = w[k];
        }
        for (int k = 0; k < 3; ++k) qp[qa + k] = qp[qa + k] + dt * w[k];
        const float wx = w[3], wy = w[4], wz = w[5];
        const float speed = sqrtf(wx * wx + wy * wy + wz * wz);
        const float half = 0.5f * (speed * dt);
        const float safe = fmaxf(speed, 1e-9f);
        float sh, ch;
        sincosf(half, &sh, &ch);
        const float bw = ch, bx = (wx / safe) * sh, by = (wy / safe) * sh, bz = (wz / safe) * sh;
        const float aw = qp[qa + 3], ax = qp[qa + 4], ay = qp[qa + 5], az = qp[qa + 6];
        const float ow = aw * bw - ax * bx - ay * by - az * bz;
        const float ox = aw * bx + ax * bw + ay * bz - az * by;
        const float oy = aw * by - ax * bz + ay * bw + az * bx;
        const float oz = aw * bz + ax * by - ay * bx + az * bw;
        const float n = sqrtf(ow * ow + ox * ox + oy * oy + oz * oz);
        qp[qa + 3] = ow / n;
        qp[qa + 4] = ox / n;
        qp[qa + 5] = oy / n;
        qp[qa + 6] = oz / n;
      } else if (jt == JNT_HINGE) {
        const float w = qv[d] + dt * x[d];
        qv[d] = w;
        qp[qa] = qp[qa] + dt * w;
      }
    }
    __syncwarp();
    PHASE(11)
  }

  if (active) {
    LANES(k, nq) qpos_out[(size_t)b * nq + k] = qp[k];
    LANES(k, nv) qvel_out[(size_t)b * nv + k] = qv[k];
    if (anchors_out != nullptr)
      LANES(k, 2 * ncon) anchors_out[(size_t)b * 2 * ncon + k] = E(anchor)[k];
  }
  PHASE(12)
#ifdef RLX_PHASE_CLOCKS
  __syncthreads();
  if (threadIdx.x < NPHASE) atomicAdd(&rlx_phase_cycles[threadIdx.x], phase_sum[threadIdx.x]);
#endif
}

// "name,name,...," of the header scalars then the sections, in order.
extern "C" const char* rlx_engine_table_names() {
  return TABLE_SCALARS(X_NAME) "|" TABLE_SECTIONS(X_NAME);
}

extern "C" int rlx_engine_block_threads() { return BLOCK_THREADS; }

#ifdef RLX_PHASE_CLOCKS
// Reads and zeroes the per-phase cycle sums (synchronous).
extern "C" int rlx_engine_phase_cycles(unsigned long long* out) {
  cudaError_t err = cudaMemcpyFromSymbol(out, rlx_phase_cycles, sizeof(rlx_phase_cycles));
  if (err != cudaSuccess) return (int)err;
  static const unsigned long long zeros[NPHASE] = {};
  return (int)cudaMemcpyToSymbol(rlx_phase_cycles, zeros, sizeof(zeros));
}
#endif

typedef void (*KernelFn)(const Header, const int*, int, const float*, const float*,
                         const float*, int, const float*, float*, float*, float*, DomainPtrs,
                         int, int);

// The kernel's variants: 32 or 16 lanes per env (index 0, 1), or -1 for
// another count.
static int variant(int lanes_per_env) {
  return lanes_per_env == 32 ? 0 : lanes_per_env == 16 ? 1 : -1;
}

static KernelFn kernel_for(int lanes_per_env) {
  return variant(lanes_per_env) == 0 ? engine_substep_kernel<32> : engine_substep_kernel<16>;
}

// Opts the kernel in to `smem` bytes of dynamic shared memory on the
// current device (once per size, variant and device).
static cudaError_t grant_shared(int lanes_per_env, int smem) {
  static int granted[2][64];  // bytes granted beyond the default 48 KB
  const int v = variant(lanes_per_env);
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess || smem <= 48 * 1024 || (device < 64 && smem <= granted[v][device]))
    return err;
  err = cudaFuncSetAttribute(kernel_for(lanes_per_env),
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess && device < 64) granted[v][device] = smem;
  return err;
}

static int shared_bytes(int table_words, int env_floats, int lanes_per_env) {
  // the table, then each env's state
  return (table_words + BLOCK_THREADS / lanes_per_env * env_floats) * 4;
}

// Blocks of the kernel one SM holds at once for this table.
extern "C" int rlx_engine_blocks_per_sm(int table_words, int env_floats, int lanes_per_env,
                                        int* blocks) {
  if (variant(lanes_per_env) < 0) return (int)cudaErrorInvalidValue;
  const int smem = shared_bytes(table_words, env_floats, lanes_per_env);
  cudaError_t err = grant_shared(lanes_per_env, smem);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel_for(lanes_per_env),
                                                            BLOCK_THREADS, smem);
}

// header: host copy of the table's first S_COUNT + T_COUNT words;
// table: the whole table on the device; lanes_per_env: 32 or 16.
extern "C" int rlx_engine_substep(const int* header, const int* table, int table_words,
                                  int lanes_per_env,
                                  const float* qpos_in, const float* qvel_in,
                                  const float* ctrl, int ctrl_per_substep,
                                  const float* anchors_in,
                                  float* qpos_out, float* qvel_out, float* anchors_out,
                                  const float* const* dr_fields,  // 11 host pointers, null = none
                                  int B, int nr_substeps, void* stream) {
  if (variant(lanes_per_env) < 0 || table_words % 4 != 0) return (int)cudaErrorInvalidValue;
  Header H;
  for (int k = 0; k < S_COUNT + T_COUNT; ++k) H.w[k] = header[k];
  const int smem = shared_bytes(table_words, H.w[S_env_floats], lanes_per_env);
  cudaError_t err = grant_shared(lanes_per_env, smem);
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
  const int envs = BLOCK_THREADS / lanes_per_env;
  const int blocks = (B + envs - 1) / envs;
  if (B > 0)
    kernel_for(lanes_per_env)<<<blocks, BLOCK_THREADS, smem, (cudaStream_t)stream>>>(
        H, table, table_words, qpos_in, qvel_in, ctrl, ctrl_per_substep, anchors_in, qpos_out,
        qvel_out, anchors_out, dr, B, nr_substeps);
  return (int)cudaGetLastError();
}
