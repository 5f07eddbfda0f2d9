"""The default locomotion reward, 25 shaping terms, batched (the JAX
package's ``robot/tpu/rewards.py``).

Every coefficient is multiplied by the control step ``dt`` once, and every
penalty is scaled by the per-env curriculum coefficient.  Sensor reads map
onto the engine: imu velocities are the free joint's qvel in the trunk
frame, joint torques the recomputed servo forces
(``engine.actuator_forces_T``), foot velocities finite differences of the
forward-kinematics foot positions over one control step.
"""

import torch


class DefaultReward:
    def __init__(self, env, cfg):
        self.env = env
        dt = env.dt
        c = lambda name: cfg[name] * dt
        self.tracking_xy_coeff = c("tracking_xy_velocity_command_coeff")
        self.tracking_xy_temperature = cfg["tracking_xy_temperature"]
        self.tracking_yaw_coeff = c("tracking_yaw_velocity_command_coeff")
        self.tracking_yaw_temperature = cfg["tracking_yaw_temperature"]
        self.alive_clipped_coeff = c("alive_clipped_coeff")
        self.alive_unclipped_coeff = c("alive_unclipped_coeff")
        self.z_velocity_coeff = c("z_velocity_coeff")
        self.imu_acceleration_coeff = c("imu_acceleration_coeff")
        self.roll_pitch_vel_coeff = c("roll_pitch_vel_coeff")
        self.roll_pitch_pos_coeff = c("roll_pitch_pos_coeff")
        self.nominal_diff_coeff = c("actuator_joint_nominal_diff_coeff")
        self.joint_position_limit_coeff = c("joint_position_limit_coeff")
        self.joint_velocity_limit_coeff = c("actuator_joint_velocity_limit_coeff")
        self.soft_velocity_limit = cfg["soft_actuator_joint_velocity_limit"]
        self.joint_velocity_coeff = c("joint_velocity_coeff")
        self.joint_acceleration_coeff = c("joint_acceleration_coeff")
        self.joint_torque_coeff = c("joint_torque_coeff")
        self.power_draw_coeff = c("power_draw_penalty_coeff")
        self.action_rate_coeff = c("action_rate_coeff")
        self.action_smoothness_coeff = c("action_smoothness_coeff")
        self.collision_coeff = c("collision_coeff")
        self.ground_penetration_coeff = c("ground_penetration_coeff")
        self.base_height_coeff = c("base_height_coeff")
        self.foot_air_time_coeff = c("foot_air_time_coeff")
        self.foot_air_time_per_robot_size_m = cfg["foot_air_time_per_robot_size_m"]
        self.symmetry_air_coeff = c("symmetry_air_coeff")
        self.foot_slip_coeff = c("foot_slip_coeff")
        self.foot_z_velocity_coeff = c("foot_z_velocity_coeff")
        self.symmetry_pairs = torch.as_tensor(env.feet_symmetry_pairs, dtype=torch.long, device=env.device)

    def init_state(self, nr_envs):
        env = self.env
        return {
            "feet_time_on_ground": torch.zeros((nr_envs, env.nr_feet), device=env.device),
            "feet_time_in_air": torch.zeros((nr_envs, env.nr_feet), device=env.device),
            "previous_actuator_joint_velocities": torch.zeros((nr_envs, env.nr_actuator_joints), device=env.device),
            "previous_imu_linear_velocity": torch.zeros((nr_envs, 3), device=env.device),
            "previous_feet_positions": torch.zeros((nr_envs, env.nr_feet, 3), device=env.device),
        }

    def extra_terms(self, internal, obsdata, action, info):
        """Variant hook: (extra_tracking, extra_penalty) [B] terms added
        inside the clipped sum (soccer's feet_phase / feet_flat / feet_yaw)."""
        return 0.0, 0.0

    def grouped_contacts(self, feet_contacts):
        """OR of contacts over each sphere's logical-foot group (heel+toe
        feet count as ONE foot for gait timers)."""
        return torch.einsum("bf,gf->bg", feet_contacts.to(torch.float32),
                            self.env.foot_same_group.to(torch.float32)) > 0.0

    def step(self, internal, feet_contacts, joint_velocities, imu_linear_velocity, feet_positions):
        """Post-reward bookkeeping."""
        dt = self.env.dt
        internal = dict(internal)
        gc = self.grouped_contacts(feet_contacts)
        internal["feet_time_on_ground"] = torch.where(gc, internal["feet_time_on_ground"] + dt, 0.0)
        internal["feet_time_in_air"] = torch.where(gc, 0.0, internal["feet_time_in_air"] + dt)
        internal["previous_actuator_joint_velocities"] = joint_velocities
        internal["previous_imu_linear_velocity"] = imu_linear_velocity
        internal["previous_feet_positions"] = feet_positions
        return internal

    def reward_and_info(self, internal, obsdata, action, info):
        """obsdata: dict of batched physical quantities assembled by the env.

        Returns reward [B] and fills info with per-term means.
        """
        env = self.env
        cc = internal["env_curriculum_coeff"]
        dt = env.dt

        imu_lin = obsdata["imu_linear_velocity"]            # [B, 3] local
        imu_ang = obsdata["imu_angular_velocity"]           # [B, 3] local
        joint_pos = obsdata["joint_positions"]              # [B, nu]
        joint_vel = obsdata["joint_velocities"]             # [B, nu]
        feet_contacts = obsdata["feet_contacts"]            # [B, nf] bool
        feet_vel = obsdata["feet_velocities"]               # [B, nf, 3]
        torques = obsdata["joint_torques"]                  # [B, nu]

        goal = internal["goal_velocities"]
        max_v = internal["max_command_velocity"]
        temp_scale = torch.clamp(torch.square(max_v), min=1e-6)

        # tracking
        xy_diff = goal[:, :2] - imu_lin[:, :2]
        xy_diff_norm = torch.sum(torch.square(xy_diff), dim=1)
        track_xy = self.tracking_xy_coeff * torch.exp(
            -xy_diff_norm / (self.tracking_xy_temperature * temp_scale)
        )
        yaw_diff_norm = torch.square(imu_ang[:, 2] - goal[:, 2])
        track_yaw = self.tracking_yaw_coeff * torch.exp(
            -yaw_diff_norm / (self.tracking_yaw_temperature * temp_scale)
        )

        alive_clipped = cc * self.alive_clipped_coeff
        alive_unclipped = cc * self.alive_unclipped_coeff

        z_velocity = cc * self.z_velocity_coeff * -torch.square(imu_lin[:, 2])
        imu_accel = cc * self.imu_acceleration_coeff * -torch.mean(
            torch.square((imu_lin - internal["previous_imu_linear_velocity"]) / dt), dim=1
        )
        ang_vel = cc * self.roll_pitch_vel_coeff * -torch.sum(torch.square(imu_ang[:, :2]), dim=1)
        ang_pos = cc * self.roll_pitch_pos_coeff * -torch.sum(
            torch.square(obsdata["imu_orientation_euler"][:, :2]), dim=1
        )

        keep = internal["actuator_joint_keep_nominal"]
        nominal_diff = cc * self.nominal_diff_coeff * -torch.mean(
            torch.square((joint_pos - internal["actuator_joint_nominal_positions"]) * keep), dim=1
        )

        limits = internal["joint_position_limits"]           # [B, nu, 2]
        lower_pen = -torch.clamp(joint_pos - limits[..., 0], max=0.0).mean(dim=1)
        upper_pen = torch.clamp(joint_pos - limits[..., 1], min=0.0).mean(dim=1)
        pos_limit = cc * self.joint_position_limit_coeff * -(lower_pen + upper_pen)

        soft_vel_limit = self.soft_velocity_limit * internal["actuator_joint_max_velocities"]
        vel_limit = cc * self.joint_velocity_limit_coeff * -torch.clamp(
            torch.abs(joint_vel) - soft_vel_limit, min=0.0
        ).mean(dim=1)

        jvel = cc * self.joint_velocity_coeff * -torch.mean(torch.square(joint_vel), dim=1)
        jaccel = cc * self.joint_acceleration_coeff * -torch.mean(
            torch.square((internal["previous_actuator_joint_velocities"] - joint_vel) / dt), dim=1
        )

        capacity = env.actuator_force_capacity[None]          # [1, nu]
        force_fraction = torques / capacity
        torque = cc * self.joint_torque_coeff * -torch.mean(torch.square(force_fraction), dim=1)
        power_fraction = torch.clamp(torques * joint_vel, min=0.0) / (
            capacity * internal["actuator_joint_max_velocities"]
        )
        power_draw = cc * self.power_draw_coeff * -torch.mean(power_fraction, dim=1)

        action_rate = cc * self.action_rate_coeff * -torch.mean(
            torch.square(action - internal["last_action"]), dim=1
        )
        action_smooth = cc * self.action_smoothness_coeff * -torch.mean(
            torch.square(action - 2 * internal["last_action"] + internal["second_last_action"]),
            dim=1,
        )

        # collisions between designated spheres
        col_pos = obsdata["collision_sphere_positions"]       # [B, ns, 3]
        col_r = env.collision_sphere_radii                     # [ns]
        dists = torch.linalg.norm(col_pos[:, :, None] - col_pos[:, None, :], dim=-1)
        touching = dists <= (col_r[:, None] + col_r[None, :])[None]
        nr_collisions = (touching.sum(dim=(1, 2)) - col_r.shape[0]) // 2
        nr_collisions = torch.clamp(nr_collisions - env.nr_collisions_in_nominal, min=0)
        collision = cc * self.collision_coeff * -nr_collisions.to(torch.float32)

        # ground penetration of collision spheres
        ground_h = env.terrain_function.height_at(internal, col_pos[..., 0], col_pos[..., 1])
        penetration = torch.sum(
            torch.clamp(
                ground_h + col_r[None] - col_pos[..., 2] - env.ground_penetration_in_nominal[None],
                min=0.0,
            ),
            dim=1,
        )
        ground_pen = cc * self.ground_penetration_coeff * -penetration

        height_diff = internal["imu_height_over_ground"] - env.nominal_imu_height_over_ground
        base_height = cc * self.base_height_coeff * -torch.square(height_diff)

        # foot air time: gait terms see logical feet
        grouped = self.grouped_contacts(feet_contacts)
        standing = torch.all(goal == 0.0, dim=1)
        target_air = (~standing).to(torch.float32) * (
            self.foot_air_time_per_robot_size_m * env.robot_dimensions_mean
        )
        air_time = torch.mean(
            grouped * torch.clamp(internal["feet_time_in_air"] - target_air[:, None], max=0.0),
            dim=1,
        )
        foot_air_time = cc * self.foot_air_time_coeff * air_time

        pairs = self.symmetry_pairs                            # [np, 2]
        both_in_air = (~grouped[:, pairs[:, 0]]) & (~grouped[:, pairs[:, 1]])
        symmetry = cc * self.symmetry_air_coeff * -torch.mean(both_in_air.to(torch.float32), dim=1)

        slip = torch.sum(torch.square(feet_vel[..., :2]), dim=-1)  # [B, nf]
        foot_slip = cc * self.foot_slip_coeff * -torch.mean(feet_contacts * slip, dim=1)
        foot_z_vel = cc * self.foot_z_velocity_coeff * -torch.mean(
            torch.square(torch.clamp(feet_vel[..., 2], max=0.0)), dim=1
        )

        tracking = track_xy + track_yaw
        penalty = (
            z_velocity + imu_accel + ang_vel + ang_pos + nominal_diff + pos_limit + vel_limit
            + jvel + jaccel + torque + power_draw + action_rate + action_smooth + collision
            + ground_pen + base_height + foot_air_time + symmetry + foot_slip + foot_z_vel
        )
        extra_tracking, extra_penalty = self.extra_terms(internal, obsdata, action, info)
        reward = tracking + extra_tracking + penalty + extra_penalty + alive_clipped
        reward = torch.clamp(reward, min=0.0) + alive_unclipped
        reward = torch.nan_to_num(reward, nan=0.0, posinf=0.0, neginf=0.0)

        info["reward/track_xy_vel_cmd"] = track_xy
        info["reward/track_yaw_vel_cmd"] = track_yaw
        info["reward/z_velocity"] = z_velocity
        info["reward/imu_acceleration"] = imu_accel
        info["reward/angular_velocity"] = ang_vel
        info["reward/angular_position"] = ang_pos
        info["reward/actuator_joint_nominal_diff"] = nominal_diff
        info["reward/joint_position_limit"] = pos_limit
        info["reward/joint_velocity_limit"] = vel_limit
        info["reward/joint_velocity"] = jvel
        info["reward/joint_acceleration"] = jaccel
        info["reward/joint_torque"] = torque
        info["reward/power_draw_penalty"] = power_draw
        info["reward/action_rate"] = action_rate
        info["reward/action_smoothness"] = action_smooth
        info["reward/collision"] = collision
        info["reward/ground_penetration"] = ground_pen
        info["reward/base_height"] = base_height
        info["reward/foot_air_time"] = foot_air_time
        info["reward/symmetry_air"] = symmetry
        info["reward/foot_slip"] = foot_slip
        info["reward/foot_z_velocity"] = foot_z_vel
        info["reward/total"] = reward

        xy_diff_abs = torch.mean(torch.minimum(torch.abs(xy_diff), 2 * max_v[:, None]), dim=1)
        xy_diff_abs = torch.nan_to_num(xy_diff_abs, nan=1e3, posinf=1e3, neginf=1e3)
        info["env_info/xy_vel_diff_abs"] = xy_diff_abs
        info["env_info/xy_vel_diff_abs_normalized"] = xy_diff_abs / torch.clamp(max_v, min=1e-6)
        return reward, xy_diff_abs


REWARD_FUNCTIONS = {"default": DefaultReward}


def get_reward_function(name, env, cfg):
    return REWARD_FUNCTIONS[name](env, cfg)
