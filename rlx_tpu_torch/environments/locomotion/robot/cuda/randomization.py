"""Domain randomization: eight axes, batched (the JAX package's
``robot/tpu/randomization.py``).

Every axis samples small per-env tensors that either feed the engine's
``DomainParams`` multipliers (dynamics), shift what the controller and the
observation treat as nominal (seen robot), or perturb ``qpos`` / ``qvel``
directly (kicks):

- action_delay      -> per-substep delayed control sequence (ring buffer)
- initial_state     -> randomized reset qpos / qvel, lifted over the terrain
- joint_dropout     -> open: servo gain 0; locked: servo gain 0 and 1000x
                       joint damping
- mujoco_model      -> contact friction / stiffness scale, gravity vector
- observation_noise -> uniform additive noise at observation indices
- perturbation      -> trunk / joint velocity and joint position kicks
- seen_robot        -> nominal positions, action scaling, joint limits and
                       velocities (the controller sees them) plus coupled
                       mass / gain / damping multipliers
- unseen_robot      -> hidden servo zero offsets and mass / gain multipliers

Each has a ``None*`` twin that leaves everything as it is.  Every draw
comes from a ``Draws`` (``draws.py``).
"""

import numpy as np
import torch


def where_rows(should, new, old):
    """Per-env select; ``should`` [B] broadcast over trailing dims."""
    return torch.where(should.reshape(should.shape + (1,) * (new.ndim - 1)), new, old)


# --- action delay -------------------------------------------------------------

class DefaultActionDelay:
    """Ring buffer of past targets; each substep reads a delayed slot."""

    def __init__(self, env, cfg):
        self.env = env
        self.min_delay_substeps = round(cfg["min_delay_s"] / env.timestep)
        self.max_delay_substeps = round(cfg["max_delay_s"] / env.timestep)
        self.buffer_length = self.max_delay_substeps + 1

    def init_state(self, nr_envs):
        nu, dev = self.env.nr_actuator_joints, self.env.device
        return {
            "action_delay_buffer": torch.zeros((nr_envs, self.buffer_length, nu), device=dev),
            "action_delay_ptr": torch.zeros(nr_envs, dtype=torch.int32, device=dev),
            "action_delay_steps": torch.full((nr_envs,), self.min_delay_substeps, dtype=torch.int32, device=dev),
        }

    def setup(self, internal):
        internal = dict(internal)
        internal["action_delay_buffer"] = torch.zeros_like(internal["action_delay_buffer"])
        internal["action_delay_ptr"] = torch.zeros_like(internal["action_delay_ptr"])
        return internal

    def sample(self, internal, should, draws, curriculum_coeff):
        effective_max = self.min_delay_substeps + torch.floor(
            curriculum_coeff * (self.max_delay_substeps - self.min_delay_substeps)
        ).to(torch.int32)
        sampled = draws.randint(curriculum_coeff.shape, self.min_delay_substeps, self.max_delay_substeps + 1)
        sampled = torch.minimum(sampled, effective_max)
        internal = dict(internal)
        internal["action_delay_steps"] = torch.where(should, sampled, internal["action_delay_steps"])
        return internal

    def delay_action(self, action, internal):
        """action [B, nu] -> per-substep controls [S, B, nu] and the updated
        buffer."""
        S, L = self.env.nr_substeps, self.buffer_length
        buffer = internal["action_delay_buffer"]            # [B, L, nu]
        ptr = internal["action_delay_ptr"].long()           # [B]
        delay = internal["action_delay_steps"].long()       # [B]
        sub = torch.arange(S, device=action.device)         # [S]
        read_idx = torch.remainder(ptr[None, :] + sub[:, None] - delay[None, :], L)   # [S, B]
        batch = torch.arange(buffer.shape[0], device=action.device)
        buffered = buffer[batch[None, :], read_idx]         # [S, B, nu]
        delayed = torch.where((sub[:, None] >= delay[None, :])[:, :, None], action[None], buffered)

        write_idx = torch.remainder(ptr[None, :] + sub[:, None], L)      # [S, B]
        onehot = (torch.arange(L, device=action.device)[None, None, :] == write_idx[:, :, None]).any(dim=0)
        new_buffer = torch.where(onehot[:, :, None], action[:, None, :], buffer)

        internal = dict(internal)
        internal["action_delay_buffer"] = new_buffer
        internal["action_delay_ptr"] = torch.remainder(ptr + S, L).to(torch.int32)
        return delayed, internal


class NoneActionDelay(DefaultActionDelay):
    def __init__(self, env, cfg):
        self.env = env
        self.min_delay_substeps = 0
        self.max_delay_substeps = 0
        self.buffer_length = 1

    def sample(self, internal, should, draws, curriculum_coeff):
        return internal

    def delay_action(self, action, internal):
        return action[None].expand((self.env.nr_substeps,) + action.shape), internal


# --- initial state ------------------------------------------------------------

class RandomInitialState:
    """Randomized reset pose and velocities, lifted so no foot starts under
    the ground."""

    def __init__(self, env, cfg):
        self.env = env
        self.roll = cfg["roll_angle_pi_factor"] * np.pi
        self.pitch = cfg["pitch_angle_pi_factor"] * np.pi
        self.yaw = cfg["yaw_angle_pi_factor"] * np.pi
        self.joint_offset = cfg["actuator_joint_position_offset_to_nominal"]
        self.joint_nominal_factor = cfg["actuator_joint_nominal_position_factor"]
        self.joint_velocity_max_factor = cfg["joint_velocity_max_factor"]
        self.trunk_velocity_clip_mass_factor = cfg["trunk_velocity_clip_mass_factor"]
        self.trunk_velocity_clip_limit = cfg["trunk_velocity_clip_limit"]
        self.rpy_max = torch.tensor([self.roll, self.pitch, self.yaw], dtype=torch.float32,
                                    device=env.device).to(env.dtype)

    def setup(self, internal, draws, curriculum_coeff):
        """-> (qpos [B, nq], qvel [B, nv])."""
        env = self.env
        B = curriculum_coeff.shape[0]
        cc = curriculum_coeff
        dev = cc.device
        rpy = cc[:, None] * draws.uniform((B, 3), -1.0, 1.0) * self.rpy_max
        quat = _rpy_to_quat(rpy)

        nominal = internal["actuator_joint_nominal_positions"]      # [B, nu]
        factor = cc[:, None] * self.joint_nominal_factor
        joints = nominal * draws.uniform(nominal.shape, 1.0 - factor, 1.0 + factor)
        joints = joints + cc[:, None] * draws.uniform(nominal.shape, -self.joint_offset, self.joint_offset)
        limits = internal["joint_position_limits"]
        joints = torch.minimum(torch.maximum(joints, limits[..., 0]), limits[..., 1])

        jv_factor = cc[:, None] * self.joint_velocity_max_factor
        joint_vels = internal["actuator_joint_max_velocities"] * draws.uniform(nominal.shape, -jv_factor, jv_factor)

        max_trunk_v = min(float(env.total_mass) * self.trunk_velocity_clip_mass_factor, self.trunk_velocity_clip_limit)
        lin_v = cc[:, None] * draws.uniform((B, 3), -max_trunk_v, max_trunk_v)
        ang_v = cc[:, None] * draws.uniform((B, 3), -max_trunk_v, max_trunk_v)

        center = internal.get("center_height", torch.zeros(B, device=dev))
        qpos = env.qpos0[None].repeat(B, 1)
        qpos[:, 2] = env.nominal_qpos_height_over_ground + center
        qpos[:, 3:7] = quat
        qpos[:, env.actuator_qpos_adr] = joints.to(qpos.dtype)

        qvel = torch.zeros((B, env.model.nv), device=dev)
        qvel[:, 0:3] = lin_v
        qvel[:, 3:6] = ang_v
        qvel[:, env.actuator_dof_adr] = joint_vels.to(qvel.dtype)

        feet_pos = env.feet_world_positions(qpos)                   # [B, nf, 3]
        ground = env.terrain_function.height_at(internal, feet_pos[..., 0], feet_pos[..., 1])
        lift = torch.amax(ground + env.foot_radius - feet_pos[..., 2], dim=1)
        qpos[:, 2] += torch.clamp(lift, min=0.0).to(qpos.dtype)
        return qpos, qvel


def _rpy_to_quat(rpy):
    """[B, 3] xyz euler -> [B, 4] wxyz quaternion."""
    half = rpy / 2.0
    cr, cp, cy = torch.cos(half[:, 0]), torch.cos(half[:, 1]), torch.cos(half[:, 2])
    sr, sp, sy = torch.sin(half[:, 0]), torch.sin(half[:, 1]), torch.sin(half[:, 2])
    return torch.stack(
        [
            cr * cp * cy + sr * sp * sy,
            sr * cp * cy - cr * sp * sy,
            cr * sp * cy + sr * cp * sy,
            cr * cp * sy - sr * sp * cy,
        ],
        dim=1,
    )


class NominalInitialState(RandomInitialState):
    """No randomization: the keyframe pose at nominal height over the local
    ground (the draws are still made, scaled by zero)."""

    def setup(self, internal, draws, curriculum_coeff):
        return super().setup(internal, draws, torch.zeros_like(curriculum_coeff))


# --- observation noise ---------------------------------------------------------

class DefaultObservationNoise:
    def __init__(self, env, cfg):
        self.env = env
        self.cfg = dict(cfg)

    def modify(self, internal, observation, draws):
        env = self.env
        cc = internal["env_curriculum_coeff"][:, None]

        def add(obs, idx, scale):
            if len(idx) == 0 or scale == 0.0:
                return obs
            noise = cc * draws.uniform((obs.shape[0], len(idx)), -scale, scale)
            obs = obs.clone()
            obs[:, idx] += noise.to(obs.dtype)
            return obs

        observation = add(observation, env.joint_positions_obs_idx, self.cfg["joint_position"])
        observation = add(observation, env.joint_velocities_obs_idx, self.cfg["joint_velocity"])
        observation = add(observation, env.imu_angular_vel_obs_idx, self.cfg["imu_angular_velocity"])
        observation = add(observation, env.gravity_vector_obs_idx, self.cfg["gravity_vector"])
        observation = add(observation, env.policy_exteroception_obs_idx, self.cfg["exteroception"])
        return observation


class NoneObservationNoise:
    def __init__(self, env, cfg):
        pass

    def modify(self, internal, observation, draws):
        return observation


# --- joint dropout --------------------------------------------------------------

class DefaultJointDropout:
    """Open (unpowered) and locked (frozen) actuator joints; a lock is the
    servo off and 1000x joint damping."""

    LOCK_DAMPING = 1000.0

    def __init__(self, env, cfg):
        self.env = env
        self.open_chance = cfg["dropout_open_chance"]
        self.lock_chance = cfg["dropout_lock_chance"]

    def init_state(self, nr_envs):
        nu, dev = self.env.nr_actuator_joints, self.env.device
        return {
            "joint_dropout_open": torch.ones((nr_envs, nu), dtype=torch.bool, device=dev),   # True = powered
            "joint_dropout_lock": torch.ones((nr_envs, nu), dtype=torch.bool, device=dev),   # True = movable
        }

    def sample(self, internal, should, draws, curriculum_coeff):
        shape = internal["joint_dropout_open"].shape
        cc = curriculum_coeff[:, None]
        new_open = draws.uniform(shape) > cc * self.open_chance
        new_lock = draws.uniform(shape) > cc * self.lock_chance
        internal = dict(internal)
        internal["joint_dropout_open"] = where_rows(should, new_open, internal["joint_dropout_open"])
        internal["joint_dropout_lock"] = where_rows(should, new_lock, internal["joint_dropout_lock"])
        return internal

    def kp_mask(self, internal):
        """[B, nu] multiplier on servo gains (0 = open or locked)."""
        return (internal["joint_dropout_open"] & internal["joint_dropout_lock"]).to(torch.float32)

    def damping_mask(self, internal):
        """[B, nu] joint damping factor (LOCK_DAMPING on locked joints)."""
        return torch.where(internal["joint_dropout_lock"], 1.0, self.LOCK_DAMPING)


class NoneJointDropout(DefaultJointDropout):
    def __init__(self, env, cfg):
        self.env = env
        self.open_chance = 0.0
        self.lock_chance = 0.0

    def sample(self, internal, should, draws, curriculum_coeff):
        return internal


# --- contact and gravity -------------------------------------------------------------

class DefaultModelDR:
    """Contact friction and stiffness and the gravity vector."""

    def __init__(self, env, cfg):
        self.env = env
        self.friction_factor = cfg["friction_tangential_factor"]
        self.timeconst_log_range = cfg["timeconst_log_range"]
        self.xy_gravity = cfg["xy_gravity"]
        self.z_gravity_factor = cfg["z_gravity_factor"]

    def init_state(self, nr_envs):
        g = float(-self.env.model.gravity[2])
        dev = self.env.device
        return {
            "dr_friction_scale": torch.ones(nr_envs, device=dev),
            "dr_contact_stiffness_scale": torch.ones(nr_envs, device=dev),
            "dr_gravity": torch.tensor([0.0, 0.0, -g], device=dev)[None].repeat(nr_envs, 1),
        }

    def sample(self, internal, should, draws, curriculum_coeff):
        B = should.shape[0]
        cc = curriculum_coeff
        friction = torch.exp(cc * draws.uniform((B,), -1.0, 1.0) * float(np.log(1.0 + self.friction_factor)))
        # omega scale = 1 / sqrt(timeconst scale)
        stiffness = torch.exp(cc * draws.uniform((B,), -0.5, 0.5) * self.timeconst_log_range) ** 0.5
        g = float(-self.env.model.gravity[2])
        gxy = cc[:, None] * draws.uniform((B, 2), -self.xy_gravity, self.xy_gravity)
        gz = -g * (1.0 + cc * draws.uniform((B,), -self.z_gravity_factor, self.z_gravity_factor))
        gravity = torch.cat([gxy, gz[:, None]], dim=1)
        internal = dict(internal)
        internal["dr_friction_scale"] = torch.where(should, friction, internal["dr_friction_scale"])
        internal["dr_contact_stiffness_scale"] = torch.where(should, stiffness, internal["dr_contact_stiffness_scale"])
        internal["dr_gravity"] = where_rows(should, gravity, internal["dr_gravity"])
        return internal


class NoneModelDR(DefaultModelDR):
    def __init__(self, env, cfg):
        self.env = env

    def sample(self, internal, should, draws, curriculum_coeff):
        return internal


# --- perturbations -----------------------------------------------------------------

class DefaultPerturbation:
    """Velocity kicks and joint nudges during episodes."""

    def __init__(self, env, cfg):
        self.env = env
        self.trunk_velocity_clip_mass_factor = cfg["trunk_velocity_clip_mass_factor"]
        self.trunk_velocity_clip_limit = cfg["trunk_velocity_clip_limit"]
        self.trunk_velocity_add_chance = cfg["trunk_velocity_add_chance"]
        self.max_joint_velocity = cfg["max_joint_velocity"]
        self.max_joint_position = cfg["max_joint_position"]

    def sample(self, qpos, qvel, internal, should, draws):
        env = self.env
        B = should.shape[0]
        cc = internal["env_curriculum_coeff"]
        max_v = min(float(env.total_mass) * self.trunk_velocity_clip_mass_factor, self.trunk_velocity_clip_limit)
        kick = cc[:, None] * draws.uniform((B, 6), -max_v, max_v)
        additive = draws.uniform((B,)) < self.trunk_velocity_add_chance
        trunk_v = torch.where(
            additive[:, None], qvel[:, :6] + kick, kick * cc[:, None] + qvel[:, :6] * (1.0 - cc[:, None]),
        )
        trunk_v = torch.where(should[:, None], trunk_v, qvel[:, :6])

        joint_v = qvel[:, 6:] + cc[:, None] * draws.uniform(
            qvel[:, 6:].shape, -self.max_joint_velocity, self.max_joint_velocity
        )
        joint_v = torch.where(should[:, None], joint_v, qvel[:, 6:])
        joint_p = qpos[:, 7:] + cc[:, None] * draws.uniform(
            qpos[:, 7:].shape, -self.max_joint_position, self.max_joint_position
        )
        joint_p = torch.where(should[:, None], joint_p, qpos[:, 7:])
        return torch.cat([qpos[:, :7], joint_p], dim=1), torch.cat([trunk_v, joint_v], dim=1)


class NonePerturbation(DefaultPerturbation):
    def __init__(self, env, cfg):
        self.env = env

    def sample(self, qpos, qvel, internal, should, draws):
        return qpos, qvel


# --- seen robot -----------------------------------------------------------------------

class DefaultSeenRobot:
    """Robot parameters the controller and the observation track."""

    def __init__(self, env, cfg):
        self.env = env
        self.mass_factor = cfg["coupled_mass_inertia_factor"]
        self.decoupled_mass_factor = cfg["decoupled_mass_inertia_factor"]
        self.p_gain_factor = cfg["p_gain_factor"]
        self.d_gain_factor = cfg["d_gain_factor"]
        self.torque_limit_factor = cfg["torque_limit_factor"]
        self.add_nominal = cfg["add_actuator_joint_nominal_position"]
        self.joint_velocity_max_factor = cfg["joint_velocity_max_factor"]
        self.add_joint_range = cfg["add_joint_range"]
        self.joint_damping_factor = cfg["joint_damping_factor"]
        self.joint_armature_factor = cfg["joint_armature_factor"]
        self.joint_friction_loss_factor = cfg["joint_friction_loss_factor"]
        self.scaling_factor_factor = cfg["scaling_factor_factor"]

    def init_state(self, nr_envs):
        env = self.env
        nu, dev = env.nr_actuator_joints, env.device
        ones = lambda *shape: torch.ones(shape, device=dev)
        return {
            "actuator_joint_nominal_positions": env.nominal_joint_positions[None].repeat(nr_envs, 1),
            "actuator_joint_max_velocities": env.max_joint_velocities[None].repeat(nr_envs, 1),
            "joint_position_limits": env.soft_joint_limits[None].repeat(nr_envs, 1, 1),
            "scaling_factor": torch.full((nr_envs,), env.robot_config["scaling_factor"], device=dev),
            "seen_mass_scale": ones(nr_envs, env.model.nbody),
            "seen_kp_scale": ones(nr_envs, nu),
            "seen_kv_scale": ones(nr_envs, nu),
            "seen_forcerange_scale": ones(nr_envs, nu),
            "seen_damping_scale": ones(nr_envs),
            "seen_armature_scale": ones(nr_envs),
            "seen_frictionloss_scale": ones(nr_envs),
        }

    def sample(self, internal, should, draws, curriculum_coeff):
        env = self.env
        B = should.shape[0]
        nu = env.nr_actuator_joints
        cc = curriculum_coeff[:, None]

        def u(shape, f):
            return 1.0 + cc * draws.uniform(shape, -f, f)

        coupled = u((B, 1), self.mass_factor)
        decoupled = u((B, env.model.nbody), self.decoupled_mass_factor)
        new = {"seen_mass_scale": coupled * decoupled}
        new["seen_kp_scale"] = u((B, nu), self.p_gain_factor)
        new["seen_kv_scale"] = u((B, nu), self.d_gain_factor)
        new["seen_forcerange_scale"] = u((B, nu), self.torque_limit_factor)
        new["seen_damping_scale"] = u((B, 1), self.joint_damping_factor)[:, 0]
        new["seen_armature_scale"] = u((B, 1), self.joint_armature_factor)[:, 0]
        new["seen_frictionloss_scale"] = u((B, 1), self.joint_friction_loss_factor)[:, 0]
        new["actuator_joint_nominal_positions"] = env.nominal_joint_positions[None] + cc * draws.uniform(
            (B, nu), -self.add_nominal, self.add_nominal
        )
        new["actuator_joint_max_velocities"] = env.max_joint_velocities[None] * u(
            (B, nu), self.joint_velocity_max_factor
        )
        new["scaling_factor"] = env.robot_config["scaling_factor"] * u((B, 1), self.scaling_factor_factor)[:, 0]
        internal = dict(internal)
        for name, value in new.items():
            internal[name] = where_rows(should, value, internal[name])
        return internal


class NoneSeenRobot(DefaultSeenRobot):
    def __init__(self, env, cfg):
        self.env = env

    def sample(self, internal, should, draws, curriculum_coeff):
        return internal


# --- unseen robot -----------------------------------------------------------------------

class DefaultUnseenRobot:
    """Hidden dynamics: the controller keeps commanding the seen nominal, but
    the servo zero, the gains and the masses differ."""

    def __init__(self, env, cfg):
        self.env = env
        self.mass_factor = cfg["mass_inertia_factor"]
        self.p_gain_factor = cfg["p_gain_factor"]
        self.d_gain_factor = cfg["d_gain_factor"]
        self.damping_factor = cfg["joint_damping_factor"]
        self.position_offset = cfg["position_offset"]

    def init_state(self, nr_envs):
        env = self.env
        nu, dev = env.nr_actuator_joints, env.device
        return {
            "position_offsets": torch.zeros((nr_envs, nu), device=dev),
            "unseen_mass_scale": torch.ones((nr_envs, env.model.nbody), device=dev),
            "unseen_kp_scale": torch.ones((nr_envs, nu), device=dev),
            "unseen_kv_scale": torch.ones((nr_envs, nu), device=dev),
            "unseen_damping_scale": torch.ones(nr_envs, device=dev),
        }

    def sample(self, internal, should, draws, curriculum_coeff):
        env = self.env
        B = should.shape[0]
        nu = env.nr_actuator_joints
        cc = curriculum_coeff[:, None]

        def u(shape, f):
            return 1.0 + cc * draws.uniform(shape, -f, f)

        new = {"position_offsets": cc * draws.uniform((B, nu), -self.position_offset, self.position_offset)}
        new["unseen_mass_scale"] = u((B, env.model.nbody), self.mass_factor)
        new["unseen_kp_scale"] = u((B, nu), self.p_gain_factor)
        new["unseen_kv_scale"] = u((B, nu), self.d_gain_factor)
        new["unseen_damping_scale"] = u((B, 1), self.damping_factor)[:, 0]
        internal = dict(internal)
        for name, value in new.items():
            internal[name] = where_rows(should, value, internal[name])
        return internal


class NoneUnseenRobot(DefaultUnseenRobot):
    def __init__(self, env, cfg):
        self.env = env

    def sample(self, internal, should, draws, curriculum_coeff):
        return internal


_REGISTRIES = {
    "action_delay": {"default": DefaultActionDelay, "none": NoneActionDelay},
    "initial_state": {"random": RandomInitialState, "nominal": NominalInitialState},
    "observation_noise": {"default": DefaultObservationNoise, "none": NoneObservationNoise},
    "joint_dropout": {"default": DefaultJointDropout, "none": NoneJointDropout},
    "mujoco_model": {"default": DefaultModelDR, "none": NoneModelDR},
    "perturbation": {"default": DefaultPerturbation, "none": NonePerturbation},
    "seen_robot": {"default": DefaultSeenRobot, "none": NoneSeenRobot},
    "unseen_robot": {"default": DefaultUnseenRobot, "none": NoneUnseenRobot},
}


def get_domain_randomization_function(axis, name, env, cfg):
    return _REGISTRIES[axis][name](env, cfg)
