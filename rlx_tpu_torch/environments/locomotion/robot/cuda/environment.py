"""Robot locomotion: velocity-command tracking with terrain, a curriculum and
eight axes of domain randomization, batched on the PyTorch physics engine
(the JAX package's ``robot/tpu/environment.py``).

- the env batch is stepped as ``[B, ...]`` tensors;
- per-env model randomization feeds the engine's ``DomainParams``
  multipliers;
- per-env terrain is a height grid in the env state, queried by the
  engine's penalty contacts.  On the plane a CUDA step runs the substep
  kernel; over a heightfield it runs the engine's eager path on the card,
  as the JAX package sends terrain to XLA and not to its kernel;
- the auto-reset is masked per env, with the curriculum, terrain and
  randomization state carried across episode boundaries.

Observation layout, normalization, reward terms, commands, curriculum and
the asymmetric ``policy_observation_indices`` /
``critic_observation_indices`` follow the JAX package.  Every random draw
comes from the env state's ``torch.Generator`` in the JAX package's
program order, and ``reset`` / ``step`` take any other ``Draws`` in its
place (``draws.py``).  With parallel seeds the env holds ``S * N`` envs,
seed-major, and the state S generators: seed s's rows draw from its own,
so they step as its one-seed env of N envs (the curriculum, terrain and
randomization state are per env already).  The model is read from the robot's ``.npz``
(``robots/configs.py``), so the env needs no MuJoCo bindings.
"""

import numpy as np
import torch

from rlx_tpu_torch.environments.env import EnvState, make_generator
from rlx_tpu_torch.environments.locomotion.robot.cuda import components as comp
from rlx_tpu_torch.environments.locomotion.robot.cuda import randomization as dr
from rlx_tpu_torch.environments.locomotion.robot.cuda.draws import GeneratorDraws
from rlx_tpu_torch.environments.locomotion.robot.cuda.randomization import where_rows
from rlx_tpu_torch.environments.locomotion.robot.cuda.rewards import get_reward_function
from rlx_tpu_torch.environments.locomotion.robot.cuda.terrain import get_terrain_function
from rlx_tpu_torch.environments.locomotion.robot.robots.configs import ROBOT_CONFIGS
from rlx_tpu_torch.environments.spaces import BoxSpace
from rlx_tpu_torch.physics import engine, load_model
from rlx_tpu_torch.physics.engine import DomainParams
from rlx_tpu_torch.physics.spatial import quat_to_rot


def select(mask, new, old):
    """Per-env select between two dicts of ``[B, ...]`` tensors."""
    return {name: where_rows(mask, value, old[name]) for name, value in new.items()}


def einsum(equation, *operands):
    """``torch.einsum`` with its operands promoted to one type first, as
    ``jnp.einsum`` does (a float32 pose against float64 velocities)."""
    dtype = operands[0].dtype
    for operand in operands[1:]:
        dtype = torch.promote_types(dtype, operand.dtype)
    return torch.einsum(equation, *(operand.to(dtype) for operand in operands))


class LocomotionEnv:
    # every draw goes through a Draws whose rows come from each seed's own
    # generator (draws.py): an env of S * N envs runs S seeds
    parallel_seeds = True
    # a CUDA graph captures the step (training_program.py): every draw comes
    # from the state's generators, the auto-reset is a masked select, the
    # indices the step takes are device tensors and the engine's constants
    # are uploaded once, so nothing is read back or copied up from the host
    capturable = True

    def __init__(self, env_config, nr_envs, device="cuda"):
        self.env_config = env_config
        self.nr_envs = nr_envs
        self.device = torch.device(device)
        self.robot_config = ROBOT_CONFIGS[env_config.robot]
        self.robot_dimensions_mean = self.robot_config["robot_dimensions_mean"]

        m = load_model(self.robot_config["model_path"])
        self.xml_path = self.robot_config["xml_path"]  # offscreen render path (rlx_tpu_torch.render)
        self.timestep = float(env_config.timestep) if env_config.timestep > 0 else m.timestep
        if abs(self.timestep - m.timestep) > 1e-9:
            m = m._replace(timestep=self.timestep)
        self.model = m
        dev = self.device
        # the env computes in torch's default float type (float32; the
        # substep kernel takes nothing else); the keyframe, and so a reset
        # pose, stays float32 in any case, as the JAX package's
        self.dtype = dtype = torch.get_default_dtype()
        self.qpos0 = torch.as_tensor(np.asarray(m.qpos0, np.float32), device=dev)

        # --- static robot indices -----------------------------------------
        self.nr_actuator_joints = len(m.act_dof)
        # every index set the step takes is a device tensor: a capture
        # refuses the upload that indexing with a numpy array makes
        self.actuator_dof_adr = torch.as_tensor([m.dof_adr[b] for b in m.act_joint_body], dtype=torch.int64,
                                                device=dev)
        self.actuator_qpos_adr = torch.as_tensor([m.qpos_adr[b] for b in m.act_joint_body], dtype=torch.int64,
                                                 device=dev)
        self.nominal_joint_positions = self.qpos0[self.actuator_qpos_adr]
        self.max_joint_velocities = torch.as_tensor(
            self.robot_config["actuator_joint_max_velocities"], dtype=dtype, device=dev
        )
        self.total_mass = float(np.sum(m.body_mass))

        joint_ranges = np.asarray([m.jnt_range[b] for b in m.act_joint_body], dtype=np.float32)  # [nu, 2]
        soft = env_config.reward["soft_joint_position_limit"]
        mid = joint_ranges.mean(axis=1)
        half = (joint_ranges[:, 1] - joint_ranges[:, 0]) / 2.0 * soft
        self.soft_joint_limits = torch.as_tensor(np.stack([mid - half, mid + half], axis=1), dtype=dtype, device=dev)

        capacity = np.abs(np.asarray(m.act_forcerange)).max(axis=1)
        capacity = np.where(np.isfinite(capacity) & (capacity > 0), capacity, 1.0)
        self.actuator_force_capacity = torch.as_tensor(capacity.astype(np.float32), dtype=dtype, device=dev)

        # feet: geoms named '*_foot'; collision spheres: group 5
        foot_geoms = [g for g, name in enumerate(m.geom_name) if name.endswith("_foot")]
        self.nr_feet = len(foot_geoms)
        self.feet_body = torch.as_tensor([m.geom_body[g] for g in foot_geoms], dtype=torch.int64, device=dev)
        self.feet_local_pos = torch.as_tensor(
            np.asarray([m.geom_pos[g] for g in foot_geoms], dtype=np.float32), dtype=dtype, device=dev
        )
        self.foot_radius = float(m.geom_size[foot_geoms[0], 0])

        # logical feet: multi-sphere feet (heel + toe) share one gait state,
        # so air / ground timers see the OR of the group's contacts
        groups = self.robot_config.get("foot_groups")
        if groups is None:
            groups = [[i] for i in range(self.nr_feet)]
        self.foot_groups = groups
        same = np.zeros((self.nr_feet, self.nr_feet), dtype=bool)
        for group in groups:
            for i in group:
                for j in group:
                    same[i, j] = True
        self.foot_same_group = torch.as_tensor(same, device=dev)

        col_geoms = [g for g in range(len(m.geom_name)) if m.geom_group[g] == 5]
        self.collision_body = torch.as_tensor([m.geom_body[g] for g in col_geoms], dtype=torch.int64, device=dev)
        self.collision_local_pos = torch.as_tensor(
            np.asarray([m.geom_pos[g] for g in col_geoms], dtype=np.float32), dtype=dtype, device=dev
        )
        radii = np.asarray([m.geom_size[g, 0] for g in col_geoms], dtype=np.float32)
        self.collision_sphere_radii = torch.as_tensor(radii, dtype=dtype, device=dev)

        # nominal standing pose: heights and baseline collision overlaps
        R0, p0 = engine.kinematics(m, self.qpos0.cpu()[None].to(dtype))
        feet0 = self._bodies_points(R0, p0, self.feet_body.cpu(), self.feet_local_pos.cpu())[0].numpy()
        col0 = self._bodies_points(R0, p0, self.collision_body.cpu(), self.collision_local_pos.cpu())[0].numpy()
        self.feet_symmetry_pairs = _symmetry_pairs(feet0)
        self.nominal_imu_height_over_ground = float(m.qpos0[2])
        self.nominal_qpos_height_over_ground = float(m.qpos0[2])
        d0 = np.linalg.norm(col0[:, None] - col0[None], axis=-1)
        touch0 = d0 <= (radii[:, None] + radii[None])
        self.nr_collisions_in_nominal = int((touch0.sum() - len(radii)) // 2)
        self.ground_penetration_in_nominal = torch.as_tensor(
            np.maximum(radii - col0[:, 2], 0.0), dtype=dtype, device=dev
        )

        # --- components ----------------------------------------------------
        self.control_function = comp.get_control_function(env_config.control_type, self)
        self.control_frequency_hz = self.robot_config["control_frequency_hz"]
        self.nr_substeps = int(round(1.0 / self.control_frequency_hz / self.timestep))
        self.dt = self.timestep * self.nr_substeps
        self.horizon = int(round(env_config.episode_length_in_seconds * self.control_frequency_hz))

        self.command_function = comp.get_command_function(env_config.command["type"], self, env_config.command)
        self.command_sampling = comp.get_sampling_function(env_config.command["sampling_type"], self)
        self.termination_function = comp.get_termination_function(
            env_config.termination["type"], self, env_config.termination
        )
        self.terrain_function = get_terrain_function(env_config.terrain["type"], self, env_config.terrain)
        self.reward_function = get_reward_function(env_config.reward["type"], self, env_config.reward)

        drc = env_config.domain_randomization
        get_dr = dr.get_domain_randomization_function
        self.dr_sampling = comp.get_sampling_function(drc["sampling_type"], self)
        self.perturbation_sampling = comp.get_sampling_function(drc["perturbation"]["sampling_type"], self)
        self.action_delay = get_dr("action_delay", drc["action_delay"]["type"], self, drc["action_delay"])
        self.initial_state = get_dr("initial_state", drc["initial_state"]["type"], self, drc["initial_state"])
        self.observation_noise = get_dr("observation_noise", drc["observation_noise"]["type"], self,
                                        drc["observation_noise"])
        self.joint_dropout = get_dr("joint_dropout", drc["joint_dropout"]["type"], self, drc["joint_dropout"])
        self.model_dr = get_dr("mujoco_model", drc["mujoco_model"]["type"], self, drc["mujoco_model"])
        self.perturbation = get_dr("perturbation", drc["perturbation"]["type"], self, drc["perturbation"])
        self.seen_robot = get_dr("seen_robot", drc["seen_robot"]["type"], self, drc["seen_robot"])
        self.unseen_robot = get_dr("unseen_robot", drc["unseen_robot"]["type"], self, drc["unseen_robot"])

        self.curriculum_nr_levels = env_config.env_curriculum_nr_levels
        self.curriculum_success_vel_diff = env_config.env_curriculum_level_success_normalized_xy_vel_diff
        self.curriculum_success_length = env_config.env_curriculum_level_success_episode_length

        self.policy_exteroception = comp.get_exteroceptive_observation_function(
            env_config.policy_exteroceptive_observation_type, self
        )
        self.critic_exteroception = comp.get_exteroceptive_observation_function(
            env_config.critic_exteroceptive_observation_type, self
        )

        # --- spaces and the observation index layout ------------------------
        nu, nf = self.nr_actuator_joints, self.nr_feet
        self.single_action_space = BoxSpace(
            low=joint_ranges[:, 0], high=joint_ranges[:, 1], shape=(nu,),
            center=self.nominal_joint_positions,
            scale=torch.full((nu,), self.robot_config["scaling_factor"], device=dev),
            device=dev,
        )
        self._build_observation_indices(nu, nf)

    # --- variant hooks (soccer) ---------------------------------------------

    def nr_extra_observations(self):
        """Extra observation channels appended after exteroception (gait
        phase features); variants override it with ``extra_observation``."""
        return 0

    def extra_observation(self, internal):
        """[B, nr_extra_observations()] un-normalized extra channels."""
        return None

    def extra_internal_init(self, nr_envs):
        """Extra internal-state entries created at reset."""
        return {}

    def extra_episode_start(self, internal, mask, draws, eval_mode):
        """Masked per-episode resampling of variant state."""
        return internal

    def internal_step_update(self, internal):
        """Per-control-step advance of variant state (after the reward and
        the observation)."""
        return internal

    # --- static helpers ------------------------------------------------------

    def _build_observation_indices(self, nu, nf):
        """Observation layout and the asymmetric policy / critic index sets."""
        idx = 0

        def take(k):
            nonlocal idx
            out = np.arange(idx, idx + k)
            idx += k
            return out

        layout = {}
        for name, size in (
            ("joint_positions", nu), ("joint_velocities", nu), ("joint_previous_actions", nu),
            ("feet_ground_contact", nf), ("feet_time_on_ground", nf), ("feet_time_in_air", nf),
            ("imu_linear_vel", 3), ("imu_angular_vel", 3), ("goal_velocities", 3), ("gravity_vector", 3),
            ("policy_exteroception", self.policy_exteroception.nr_exteroceptive_observations),
            ("critic_exteroception", self.critic_exteroception.nr_exteroceptive_observations),
            ("extra", self.nr_extra_observations()),
        ):
            layout[name] = take(size)
            setattr(self, f"{name}_obs_idx", torch.as_tensor(layout[name], device=self.device))

        self.single_observation_space = BoxSpace(low=-np.inf, high=np.inf, shape=(idx,), device=self.device)
        policy = ("joint_positions", "joint_velocities", "joint_previous_actions", "imu_angular_vel",
                  "goal_velocities", "gravity_vector", "policy_exteroception", "extra")
        critic = ("joint_positions", "joint_velocities", "joint_previous_actions", "feet_ground_contact",
                  "feet_time_on_ground", "feet_time_in_air", "imu_linear_vel", "imu_angular_vel",
                  "goal_velocities", "gravity_vector", "critic_exteroception", "extra")
        self.policy_observation_indices = np.concatenate([layout[n] for n in policy]).astype(np.int32)
        self.critic_observation_indices = np.concatenate([layout[n] for n in critic]).astype(np.int32)

    @staticmethod
    def _bodies_points(R, p, bodies, local):
        """World positions [B, k, 3] of points ``local`` [k, 3] on ``bodies``."""
        return p[:, bodies] + einsum("bfij,fj->bfi", R[:, bodies], local)

    def feet_world_positions(self, qpos):
        R, p = engine.kinematics(self.model, qpos)
        return self._bodies_points(R, p, self.feet_body, self.feet_local_pos)

    def _domain_params(self, internal):
        """The engine's DomainParams (batch-last) from the internal state;
        the joint locks ride on a per-dof damping scale ``[nv, B]``."""
        nv = self.model.nv
        damping = (internal["seen_damping_scale"] * internal["unseen_damping_scale"])[None].repeat(nv, 1)
        lock = self.joint_dropout.damping_mask(internal)           # [B, nu]
        damping[self.actuator_dof_adr] = (damping[self.actuator_dof_adr] * lock.T).to(damping.dtype)
        kp = (internal["seen_kp_scale"] * internal["unseen_kp_scale"] * self.joint_dropout.kp_mask(internal)).T
        kv = (internal["seen_kv_scale"] * internal["unseen_kv_scale"]).T
        return DomainParams(
            mass_scale=(internal["seen_mass_scale"] * internal["unseen_mass_scale"]).T,
            damping_scale=damping,
            frictionloss_scale=internal["seen_frictionloss_scale"],
            armature_scale=internal["seen_armature_scale"],
            friction_scale=internal["dr_friction_scale"],
            contact_stiffness_scale=internal["dr_contact_stiffness_scale"],
            kp_scale=kp,
            kv_scale=kv,
            forcerange_scale=internal["seen_forcerange_scale"].T,
            ctrl_offset=None,  # offsets are folded into the target by PDControl
            gravity=internal["dr_gravity"].T,
        )

    # --- protocol --------------------------------------------------------------

    def reset(self, seed, eval_mode=False, draws=None):
        """``seed`` is one seed, or with parallel seeds a list of S (seed
        s's ``nr_envs // S`` rows from its own generator); ``draws`` (a
        ``Draws``) replaces the new generators' draws."""
        B, dev = self.nr_envs, self.device
        generator = make_generator(seed, dev)
        if draws is None:
            draws = GeneratorDraws(generator, dev)

        internal = {}
        internal.update(self.command_function.init_state(B))
        internal.update(self.reward_function.init_state(B))
        internal.update(self.action_delay.init_state(B))
        internal.update(self.joint_dropout.init_state(B))
        internal.update(self.model_dr.init_state(B))
        internal.update(self.seen_robot.init_state(B))
        internal.update(self.unseen_robot.init_state(B))
        internal.update(self.terrain_function.init_state(B))
        internal["env_curriculum_coeff"] = torch.full((B,), 1.0 if eval_mode else 0.0, device=dev)
        internal["env_curriculum_levels_in_a_row"] = torch.zeros(B, device=dev)
        internal["max_command_velocity"] = torch.full((B,), self.command_function.max_command_velocity(), device=dev)
        internal["last_action"] = torch.zeros((B, self.nr_actuator_joints), device=dev)
        internal["second_last_action"] = torch.zeros((B, self.nr_actuator_joints), device=dev)
        internal["imu_height_over_ground"] = torch.full((B,), self.nominal_imu_height_over_ground, device=dev)
        internal.update(self.extra_internal_init(B))

        internal, qpos, qvel = self._episode_start(
            internal, torch.ones(B, dtype=torch.bool, device=dev), draws, eval_mode
        )
        physics = {
            "qpos": qpos, "qvel": qvel, "internal": internal,
            # stick-friction anchors carried across control steps
            "contact_anchor": engine.contact_anchor_init(self.model, qpos),
        }
        observation, _ = self._observe(physics, torch.zeros((B, self.nr_actuator_joints), device=dev), draws)

        zeros = torch.zeros(B, device=dev)
        falses = torch.zeros(B, dtype=torch.bool, device=dev)
        info = {
            "rollout/episode_return": zeros,
            "rollout/episode_length": zeros,
            "rollout/episode_tracking": zeros,
            "env_curriculum/coefficient": internal["env_curriculum_coeff"],
        }
        for name in self.reward_function_info_keys():
            info[name] = zeros
        episode_store = {
            "episode_return": zeros,
            "episode_length": zeros,
            "episode_total_xy_velocity_diff_abs": zeros,
        }
        return EnvState(
            physics=physics, observation=observation, final_observation=observation,
            reward=zeros, terminated=falses, truncated=falses,
            info=info, episode_store=episode_store, generator=generator, eval_mode=eval_mode,
        )

    def reward_function_info_keys(self):
        keys = [
            "track_xy_vel_cmd", "track_yaw_vel_cmd", "z_velocity", "imu_acceleration",
            "angular_velocity", "angular_position", "actuator_joint_nominal_diff",
            "joint_position_limit", "joint_velocity_limit", "joint_velocity",
            "joint_acceleration", "joint_torque", "power_draw_penalty", "action_rate",
            "action_smoothness", "collision", "ground_penetration", "base_height",
            "foot_air_time", "symmetry_air", "foot_slip", "foot_z_velocity", "total",
        ]
        return [f"reward/{k}" for k in keys] + ["env_info/xy_vel_diff_abs", "env_info/xy_vel_diff_abs_normalized"]

    def _episode_start(self, internal, mask, draws, eval_mode):
        """Per-env episode initialization for the envs selected by ``mask`` [B]."""
        B = mask.shape[0]
        cc = internal["env_curriculum_coeff"]

        fresh = self.terrain_function.sample(dict(internal), draws, cc)
        internal = select(mask, fresh, internal) if fresh is not internal else internal
        center = self.terrain_function.center_height(internal)
        internal["center_height"] = center if center is not None else torch.zeros(B, device=self.device)

        # domain randomization at episode start: forced in eval mode
        should = self.dr_sampling.setup(draws, B) | bool(eval_mode)
        should = should & mask
        internal = self.seen_robot.sample(internal, should, draws, cc)
        internal = self.unseen_robot.sample(internal, should, draws, cc)
        internal = self.model_dr.sample(internal, should, draws, cc)
        internal = self.action_delay.sample(internal, should, draws, cc)
        internal = self.joint_dropout.sample(internal, should, draws, cc)

        # clear the per-episode accumulators of the masked envs
        zeroed = dict(internal)
        zeroed.update(self.reward_function.init_state(B))
        zeroed.update(self.action_delay.setup(dict(internal)))
        zeroed["last_action"] = torch.zeros_like(internal["last_action"])
        zeroed["second_last_action"] = torch.zeros_like(internal["second_last_action"])
        internal = select(mask, zeroed, internal)

        # commands (forced at episode start)
        should_cmd = self.command_sampling.setup(draws, B) & mask
        internal = self.command_function.get_next_command(internal, should_cmd, draws)

        qpos, qvel = self.initial_state.setup(internal, draws, cc)
        internal["imu_height_over_ground"] = torch.where(
            mask, qpos[:, 2] - internal["center_height"], internal["imu_height_over_ground"]
        )
        # feet velocities are finite differences: seed the previous positions
        # with the reset pose, so the first step reads ~zero foot velocity
        internal["previous_feet_positions"] = where_rows(
            mask, self.feet_world_positions(qpos), internal["previous_feet_positions"]
        )
        internal = self.extra_episode_start(internal, mask, draws, eval_mode)
        return internal, qpos, qvel

    def _trunk_frame(self, qpos, qvel):
        R = quat_to_rot(qpos[:, 3:7])                       # body -> world
        local_lin = einsum("bji,bj->bi", R, qvel[:, :3])
        local_ang = qvel[:, 3:6]                            # already body-local
        roll = torch.atan2(R[:, 2, 1], R[:, 2, 2])
        pitch = -torch.asin(torch.clamp(R[:, 2, 0], -1.0, 1.0))
        yaw = torch.atan2(R[:, 1, 0], R[:, 0, 0])
        euler = torch.stack([roll, pitch, yaw], dim=1)
        gravity_vec = -R[:, 2, :]                           # R^T (0, 0, -1)
        return R, local_lin, local_ang, euler, gravity_vec

    def _physical_quantities(self, qpos, qvel, internal, action):
        """Forward-kinematics quantities shared by the reward and the
        observation."""
        R_all, p_all = engine.kinematics(self.model, qpos)
        _, local_lin, local_ang, euler, gravity_vec = self._trunk_frame(qpos, qvel)
        feet_pos = self._bodies_points(R_all, p_all, self.feet_body, self.feet_local_pos)
        col_pos = self._bodies_points(R_all, p_all, self.collision_body, self.collision_local_pos)
        ground_at_feet = self.terrain_function.height_at(internal, feet_pos[..., 0], feet_pos[..., 1])
        feet_contacts = (feet_pos[..., 2] - self.foot_radius) <= ground_at_feet
        feet_vel = (feet_pos - internal["previous_feet_positions"]) / self.dt

        target = self.control_function.process_action(action, internal)
        dp = self._domain_params(internal)
        torques = engine.actuator_forces_T(self.model, qpos.T, qvel.T, target.T, dp).T
        return {
            "imu_linear_velocity": local_lin,
            "imu_angular_velocity": local_ang,
            "imu_orientation_euler": euler,
            "joint_positions": qpos[:, self.actuator_qpos_adr],
            "joint_velocities": qvel[:, self.actuator_dof_adr],
            "feet_contacts": feet_contacts,
            "feet_velocities": feet_vel,
            "feet_positions": feet_pos,
            "feet_rotations": R_all[:, self.feet_body],  # [B, nf, 3, 3] body -> world
            "collision_sphere_positions": col_pos,
            "joint_torques": torques,
            "gravity_vector": gravity_vec,
            "trunk_pos": p_all[:, 0],
            "trunk_yaw": euler[:, 2],
        }

    def _assemble_observation(self, internal, obsdata, action, draws):
        """Concatenate, add noise, normalize and clip."""
        policy_ext = self.policy_exteroception.get(internal, obsdata["trunk_pos"], obsdata["trunk_yaw"])
        critic_ext = self.critic_exteroception.get(internal, obsdata["trunk_pos"], obsdata["trunk_yaw"])
        parts = [
            obsdata["joint_positions"], obsdata["joint_velocities"], action,
            obsdata["feet_contacts"].to(action.dtype),
            internal["feet_time_on_ground"], internal["feet_time_in_air"],
            obsdata["imu_linear_velocity"], obsdata["imu_angular_velocity"],
            internal["goal_velocities"], obsdata["gravity_vector"],
            policy_ext, critic_ext,
        ]
        if len(self.extra_obs_idx) > 0:
            parts.append(self.extra_observation(internal))
        o = self.observation_noise.modify(internal, torch.cat(parts, dim=1), draws).clone()

        def scale(idx, fn):
            o[:, idx] = fn(o[:, idx]).to(o.dtype)

        scale(self.joint_positions_obs_idx, lambda x: (x - internal["actuator_joint_nominal_positions"]) / 3.14)
        scale(self.joint_velocities_obs_idx, lambda x: x / 100.0)
        scale(self.joint_previous_actions_obs_idx, lambda x: x / 10.0)
        scale(self.feet_ground_contact_obs_idx, lambda x: x / 0.5 - 1.0)
        scale(self.feet_time_on_ground_obs_idx, lambda x: torch.clamp(x / 2.5 - 1.0, -1.0, 1.0))
        scale(self.feet_time_in_air_obs_idx, lambda x: torch.clamp(x / 2.5 - 1.0, -1.0, 1.0))
        scale(self.imu_linear_vel_obs_idx, lambda x: torch.clamp(x / 10.0, -1.0, 1.0))
        scale(self.imu_angular_vel_obs_idx, lambda x: torch.clamp(x / 50.0, -1.0, 1.0))
        for idx in (self.policy_exteroception_obs_idx, self.critic_exteroception_obs_idx):
            if len(idx) > 0:
                scale(idx, lambda x: torch.clamp(x / 5.0 - 1.0, -1.0, 1.0))
        o = torch.nan_to_num(o, nan=0.0, posinf=0.0, neginf=0.0)
        return torch.clamp(o, -10.0, 10.0)

    def _observe(self, physics, action, draws):
        obsdata = self._physical_quantities(physics["qpos"], physics["qvel"], physics["internal"], action)
        return self._assemble_observation(physics["internal"], obsdata, action, draws), obsdata

    def step(self, state, action, draws=None):
        """One control step, in the JAX package's order: delay -> PD targets
        -> physics -> velocity clipping -> in-episode randomization and
        perturbation -> reward (old commands) -> command resample ->
        observation -> termination -> bookkeeping and curriculum -> masked
        auto-reset and edge teleport.  ``draws`` (a ``Draws``) replaces the
        state generator's draws."""
        if draws is None:
            draws = GeneratorDraws(state.generator, self.device)
        physics = state.physics
        internal = dict(physics["internal"])
        B = self.nr_envs

        # --- act: delay -> PD targets -> physics ---------------------------
        delayed, internal = self.action_delay.delay_action(action, internal)    # [S, B, nu]
        targets = self.control_function.process_action(delayed, internal)
        dp = self._domain_params(internal)
        terrain = self.terrain_function.engine_terrain(internal)
        qpos, qvel, contact_anchor = engine.step(
            self.model, physics["qpos"], physics["qvel"], targets[0], nr_substeps=self.nr_substeps,
            dr=dp, terrain=terrain, ctrl_sequence=targets, contact_state=physics["contact_anchor"],
        )

        # velocity clipping
        max_qvel = torch.full((B, self.model.nv), 100.0, device=self.device)
        max_qvel[:, self.actuator_dof_adr] = internal["actuator_joint_max_velocities"].to(max_qvel.dtype)
        qvel = torch.minimum(torch.maximum(qvel, -max_qvel), max_qvel)

        # --- in-episode domain randomization --------------------------------
        cc = internal["env_curriculum_coeff"]
        should_dr = self.dr_sampling.step(draws, B)
        internal = self.seen_robot.sample(internal, should_dr, draws, cc)
        internal = self.unseen_robot.sample(internal, should_dr, draws, cc)
        internal = self.model_dr.sample(internal, should_dr, draws, cc)
        internal = self.action_delay.sample(internal, should_dr, draws, cc)
        internal = self.joint_dropout.sample(internal, should_dr, draws, cc)
        should_pert = self.perturbation_sampling.step(draws, B, cc)
        qpos, qvel = self.perturbation.sample(qpos, qvel, internal, should_pert, draws)

        # --- terrain height bookkeeping --------------------------------------
        trunk_xy_ground = self.terrain_function.height_at(internal, qpos[:, 0:1], qpos[:, 1:2])[:, 0]
        internal["imu_height_over_ground"] = qpos[:, 2] - trunk_xy_ground

        # --- reward on the commands before the resample ---------------------
        obsdata = self._physical_quantities(qpos, qvel, internal, action)
        info = dict(state.info)
        reward, xy_diff_abs = self.reward_function.reward_and_info(internal, obsdata, action, info)

        # --- command resample, then the policy-facing observation ------------
        should_cmd = self.command_sampling.step(draws, B)
        internal = self.command_function.get_next_command(internal, should_cmd, draws)
        observation = self._assemble_observation(internal, obsdata, action, draws)

        # --- termination / truncation ------------------------------------------
        terminated = self.termination_function.should_terminate(internal)
        terminated = terminated | torch.any(torch.abs(qvel[:, :3]) >= 100.0, dim=1)
        episode_length = state.episode_store["episode_length"] + 1.0
        truncated = (episode_length >= self.horizon) & ~terminated
        done = terminated | truncated

        # --- bookkeeping -----------------------------------------------------
        internal = self.reward_function.step(
            internal, obsdata["feet_contacts"], obsdata["joint_velocities"],
            obsdata["imu_linear_velocity"], obsdata["feet_positions"],
        )
        internal = self.internal_step_update(internal)
        internal["second_last_action"] = internal["last_action"]
        internal["last_action"] = action
        episode_return = state.episode_store["episode_return"] + reward
        episode_xy_diff = state.episode_store["episode_total_xy_velocity_diff_abs"] + xy_diff_abs

        info["rollout/episode_return"] = torch.where(done, episode_return, info["rollout/episode_return"])
        info["rollout/episode_length"] = torch.where(done, episode_length, info["rollout/episode_length"])

        # --- curriculum update on done ---------------------------------------
        mean_diff = episode_xy_diff / torch.clamp(episode_length, min=1.0)
        mean_norm_diff = mean_diff / torch.clamp(internal["max_command_velocity"], min=1e-6)
        # episode tracking quality in [0, 1]: 1 - mean |v - v_cmd| / v_max,
        # the curriculum's own success measure and the family's learning metric
        info["rollout/episode_tracking"] = torch.where(
            done, torch.clamp(1.0 - mean_norm_diff, 0.0, 1.0), info["rollout/episode_tracking"]
        )
        success = (mean_norm_diff <= self.curriculum_success_vel_diff) & (
            episode_length >= self.curriculum_success_length
        )
        levels = internal["env_curriculum_levels_in_a_row"]
        levels_new = torch.where(success, torch.where(levels >= 0, levels + 1, 1.0),
                                 torch.where(levels < 0, levels - 1, -1.0))
        coeff_new = torch.clamp(cc + levels_new / self.curriculum_nr_levels, 0.0, 1.0)
        if state.eval_mode:
            coeff_new = torch.ones_like(coeff_new)
        internal["env_curriculum_levels_in_a_row"] = torch.where(done, levels_new, levels)
        internal["env_curriculum_coeff"] = torch.where(done, coeff_new, cc)
        info["env_curriculum/coefficient"] = internal["env_curriculum_coeff"]

        # --- masked auto-reset (episode start for the done envs) ---------------
        internal, qpos_r, qvel_r = self._episode_start(internal, done, draws, state.eval_mode)

        # terrain edge teleport: a pose-only reinitialization when the robot
        # walks near the grid's edge
        half = self.terrain_function.half_extent_m
        ax, ay = torch.abs(qpos[:, 0]), torch.abs(qpos[:, 1])
        near_edge = (((half - 0.5) < ax) & (ax < half)) | (((half - 0.5) < ay) & (ay < half))
        pose_mask = done | (near_edge & ~done)
        new_qpos = where_rows(pose_mask, qpos_r, qpos)
        new_qvel = where_rows(pose_mask, qvel_r, qvel)
        contact_anchor = where_rows(pose_mask, engine.contact_anchor_init(self.model, new_qpos), contact_anchor)

        physics_out = {"qpos": new_qpos, "qvel": new_qvel, "internal": internal, "contact_anchor": contact_anchor}
        reset_obs, _ = self._observe(physics_out, torch.zeros_like(action), draws)
        new_observation = torch.where(done[:, None], reset_obs, observation)

        episode_store = {
            "episode_return": torch.where(done, 0.0, episode_return),
            "episode_length": torch.where(done, 0.0, episode_length),
            "episode_total_xy_velocity_diff_abs": torch.where(done, 0.0, episode_xy_diff),
        }
        return state.replace(
            physics=physics_out,
            observation=new_observation,
            final_observation=observation,
            reward=reward,
            terminated=terminated,
            truncated=truncated,
            info=info,
            episode_store=episode_store,
        )

    def close(self):
        pass


def _symmetry_pairs(feet_world_nominal):
    """Mirror-image foot pairing: mutual nearest neighbours of the nominal
    foot positions after folding |y|."""
    folded = np.asarray(feet_world_nominal, dtype=np.float64).copy()
    folded[:, 1] = np.abs(folded[:, 1])
    d = np.linalg.norm(folded[:, None] - folded[None], axis=-1) + np.eye(len(folded)) * 1e3
    nearest = d.argmin(axis=1)
    pairs = sorted(
        {(min(i, nearest[i]), max(i, nearest[i])) for i in range(len(folded)) if nearest[nearest[i]] == i}
    )
    if not pairs:
        pairs = [(i, i) for i in range(len(folded))]
    return np.asarray(pairs, dtype=np.int32)
