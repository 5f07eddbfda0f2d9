"""PQN (parallelized Q-network) on one device, the JAX package's ``pqn.tpu``:
replay-free on-policy Q-learning.

Per learning iteration:

- rollout: ``nr_steps`` epsilon-greedy env steps with the Q-network's
  parameters as they were at the iteration's start; epsilon decays
  linearly from ``epsilon_start`` to ``epsilon_end`` over
  ``epsilon_decay_fraction * nr_updates`` iterations;
- Q(lambda) targets by a reverse loop over the rollout (plain PyTorch, as
  the JAX package's reverse scan), bootstrapped from the max Q of each
  step's pre-reset observation;
- ``nr_epochs`` independent permutations of the flat batch, each split into
  ``nr_minibatches`` minibatches; per minibatch a squared TD loss, a
  global-norm gradient clip at ``max_grad_norm`` and Adam (eps 1e-8), the
  learning rate annealed linearly on the optimizer step count when asked.

The Q-network is flax's default (lecun) init with a LayerNorm after every
Dense (on an IMAGES env a ``NatureCNN`` trunk, fed the rollout's float32
frames) and has no target network.  Evaluation, save, load and test mode
follow the JAX package's PQN: an evaluation of ``horizon`` greedy steps
from a fresh eval reset after each eval/save iteration, and with
``runner.save_model`` a ``latest.model`` holding the Q-network's
parameters.

With parallel seeds (``parallel_seeds.py``) the Q-network is seed-stacked:
each seed's epsilon-greedy draws and permutations come from its own
generator, the Q(lambda) targets run over ``[T, S * N]``, and each
minibatch's loss is mapped over the seeds and clipped per seed.
"""

import math
import time

import numpy as np
import torch
from torch.profiler import record_function

from rlx_tpu_torch.algorithms.evaluation import collect_test_returns
from rlx_tpu_torch.algorithms.parallel_seeds import (
    NoGenerator, ParallelSeeds, check_config, finish, nr_parallel_seeds, stack_modules,
)
from rlx_tpu_torch.algorithms.pqn.cuda.general_properties import GeneralProperties
from rlx_tpu_torch.algorithms.train_state import clip_by_global_norm_
from rlx_tpu_torch.algorithms.training_program import (
    eval_reset_seed, run_training_program, train_reset_seed,
)
from rlx_tpu_torch.models.mlp import DiscreteQNet
from rlx_tpu_torch.models.policy_factory import image_shape
from rlx_tpu_torch.utils import checkpoint as ckpt
from rlx_tpu_torch.utils.logging import MetricsLogger, rlx_logger


class PQN:
    def __init__(self, config, train_env, eval_env, run_path=None, writer=None):
        self.config = config
        self.train_env = train_env
        self.eval_env = eval_env
        self.device = train_env.device

        a = config.algorithm
        check_config(config)
        self.save_model = config.runner.save_model
        self.save_path = ckpt.save_path_for(config, run_path)
        self.seed = config.environment.seed
        nr_seeds = nr_parallel_seeds(config)
        self.parallel = ParallelSeeds(self.seed, nr_seeds, self.device) if nr_seeds > 1 else None
        self.total_timesteps = int(a.total_timesteps)
        self.nr_envs = config.environment.nr_envs
        self.learning_rate = a.learning_rate
        self.anneal_learning_rate = a.anneal_learning_rate
        self.nr_steps = a.nr_steps
        self.nr_epochs = a.nr_epochs
        self.nr_minibatches = a.nr_minibatches
        self.gamma = a.gamma
        self.q_lambda = a.q_lambda
        self.max_grad_norm = a.max_grad_norm
        self.logging_active = a.logging_active
        self.evaluation_active = a.evaluation_active

        self.batch_size = self.nr_envs * self.nr_steps
        self.minibatch_size = self.batch_size // self.nr_minibatches
        self.nr_updates = max(self.total_timesteps // self.batch_size, 1)
        self.eval_save_frequency = a.evaluation_and_save_frequency
        if self.eval_save_frequency == -1:
            self.eval_save_frequency = self.batch_size * self.nr_updates
        self.nr_eval_save_iterations = max(self.total_timesteps // self.eval_save_frequency, 1)
        self.nr_updates_per_eval_save_iteration = self.eval_save_frequency // self.batch_size

        self.epsilon_start = a.epsilon_start
        self.epsilon_end = a.epsilon_end
        self.epsilon_decay_updates = max(int(a.epsilon_decay_fraction * self.nr_updates), 1)

        self.horizon = train_env.horizon
        self.os_shape = tuple(train_env.single_observation_space.shape)
        self.nr_actions = train_env.single_action_space.n

        self.logger = MetricsLogger(config.runner.track_console, writer)
        rlx_logger.info(f"Using device: {self.device}")

        # parameters are initialized on the CPU from the seed, then moved
        build = lambda: DiscreteQNet(math.prod(self.os_shape), self.nr_actions, tuple(a.critic_hidden_sizes),
                                     a.activation, layer_norm_all=True, image_shape=image_shape(train_env))
        if self.parallel is None:
            with torch.random.fork_rng(devices=[]):
                torch.manual_seed(self.seed)
                self.q_net = build()
        else:
            self.q_net = stack_modules(self.parallel.init(build))
        self.q_net.to(self.device)
        self.optimizer = torch.optim.Adam(self.q_net.parameters(), lr=self.learning_rate, eps=1e-8)
        self.nr_optimizer_steps = 0
        if self.parallel is None:
            self.generator = torch.Generator(device=self.device).manual_seed(self.seed)
            # seeds of the eval and test resets
            self.host_generator = torch.Generator().manual_seed(self.seed)
        else:
            self.generator = self.host_generator = NoGenerator()
        self.env_state = None
        self.nr_train_resets = 0
        self.metrics_history = []  # per-iteration float metrics when logging is active
        self.eval_history = None

    def epsilon(self, update_step):
        fraction = min(update_step / self.epsilon_decay_updates, 1.0)
        return self.epsilon_start + fraction * (self.epsilon_end - self.epsilon_start)

    def learning_rate_at(self, count):
        """Learning rate for the optimizer step that follows ``count`` steps."""
        if not self.anneal_learning_rate:
            return self.learning_rate
        return self.learning_rate * (1.0 - (count // (self.nr_minibatches * self.nr_epochs)) / self.nr_updates)

    @torch.no_grad()
    def greedy_action(self, observation):
        if self.parallel is not None:
            P = self.parallel
            return P.merge(P.map(self.greedy_action_of, {"q_net": self.q_net}, P.split(observation)))
        return self.greedy_action_of(observation)

    def greedy_action_of(self, observation):
        return torch.argmax(self.q_net(observation), dim=-1).to(torch.int32)

    def _exploration_draws(self):
        """(random actions, uniform draws) of a rollout step, each seed's
        from its own generator, in its one-seed order."""
        P = self.parallel
        draws = P.draw(lambda g: {
            "random_action": torch.randint(0, self.nr_actions, (self.nr_envs,), generator=g, device=self.device,
                                           dtype=torch.int32),
            "draw": torch.rand((self.nr_envs,), generator=g, device=self.device)})
        return P.merge(draws["random_action"]), P.merge(draws["draw"])

    # ------------------------------------------------------------------ train

    @torch.no_grad()
    def _rollout(self, env_state, epsilon):
        observations, final_observations, actions, rewards, terminations = ([] for _ in range(5))
        info_sums = None
        for _ in range(self.nr_steps):
            observation = env_state.observation
            greedy = self.greedy_action(observation)
            if self.parallel is None:
                random_action = torch.randint(0, self.nr_actions, greedy.shape, generator=self.generator,
                                              device=self.device, dtype=torch.int32)
                draw = torch.rand(greedy.shape, generator=self.generator, device=self.device)
            else:
                random_action, draw = self._exploration_draws()
            action = torch.where(draw < epsilon, random_action, greedy)
            env_state = self.train_env.step(env_state, action)
            observations.append(observation)
            final_observations.append(env_state.final_observation)
            actions.append(action)
            rewards.append(env_state.reward)
            terminations.append(env_state.terminated)
            if info_sums is None:
                info_sums = {k: v.float().sum() for k, v in env_state.info.items()}
            else:
                for k, v in env_state.info.items():
                    info_sums[k] = info_sums[k] + v.float().sum()
        batch = tuple(torch.stack(x) for x in (observations, final_observations, actions, rewards,
                                               terminations))
        infos = {k: v / (self.nr_steps * self.train_env.nr_envs) for k, v in info_sums.items()}
        return env_state, batch, infos

    def q_lambda_targets(self, rewards, terminations, next_values):
        """Q(lambda) targets ``[T, N]`` by a reverse loop over T, from the
        carry ``r[T-1] + gamma * next_q[T-1] * (1 - d[T-1])``:
        ``target_t = r_t + gamma * (lambda * carry + (1 - lambda) * next_q_t)
        * (1 - d_t)``, each target the carry of the step before it."""
        terminations = terminations.to(torch.float32)
        carry = rewards[-1] + self.gamma * next_values[-1] * (1.0 - terminations[-1])
        targets = [None] * rewards.shape[0]
        for t in reversed(range(rewards.shape[0])):
            mixed = self.q_lambda * carry + (1.0 - self.q_lambda) * next_values[t]
            carry = targets[t] = rewards[t] + self.gamma * mixed * (1.0 - terminations[t])
        return torch.stack(targets)

    def learning_iteration(self, env_state, update_step):
        """One rollout, its Q(lambda) targets and the minibatch epochs; returns
        the new env state and the iteration's metrics (device scalars)."""
        epsilon = self.epsilon(update_step)
        with record_function("pqn/rollout"):
            env_state, batch, infos = self._rollout(env_state, epsilon)
        metrics = self._learn(batch)
        metrics["epsilon/epsilon"] = torch.tensor(epsilon)
        return env_state, {**infos, **metrics}

    def _learn(self, batch, epoch_indices=None):
        """Q(lambda) targets of a rollout ``(observations, final_observations,
        actions, rewards, terminations)``, each ``[T, N, ...]``, then the
        minibatch epochs (``_optimize``); returns their metrics."""
        observations, final_observations, actions, rewards, terminations = batch
        T, N = rewards.shape
        with torch.no_grad(), record_function("pqn/targets"):
            if self.parallel is None:
                next_values = self.q_net(final_observations.reshape((T * N,) + self.os_shape)).max(dim=-1).values
            else:
                P = self.parallel
                next_values = P.merge_time(P.map(lambda o: self.q_net(o).max(dim=-1).values, {"q_net": self.q_net},
                                                 P.split_time(final_observations)), T)
            q_targets = self.q_lambda_targets(rewards, terminations, next_values.reshape(T, N))
        if self.parallel is not None:
            with record_function("pqn/update"):
                P = self.parallel
                return self._optimize_seeds((P.split_time(observations), P.split_time(actions),
                                             P.split_time(q_targets)), epoch_indices)
        with record_function("pqn/update"):
            return self._optimize(
                (observations.reshape((T * N,) + self.os_shape), actions.reshape(-1), q_targets.reshape(-1)),
                epoch_indices
            )

    def _optimize(self, batch_arrays, epoch_indices=None):
        """Minibatch epochs over a flat batch ``(observations, actions,
        q_targets)``.  ``epoch_indices`` ([nr_epochs, batch]) are the
        per-epoch permutations; drawn from ``self.generator`` when not given."""
        observations, actions, q_targets = batch_arrays
        if epoch_indices is None:
            epoch_indices = torch.stack([
                torch.randperm(self.batch_size, generator=self.generator, device=self.device)
                for _ in range(self.nr_epochs)
            ])
        minibatches = epoch_indices.to(self.device).reshape(-1, self.minibatch_size)
        params = list(self.q_net.parameters())
        history = []
        lr = self.learning_rate
        for idx in minibatches:
            q = self.q_net(observations[idx])
            q_action = torch.gather(q, -1, actions[idx].long()[:, None]).squeeze(-1)
            loss = (0.5 * (q_action - q_targets[idx]) ** 2).mean()
            grads = torch.autograd.grad(loss, params)
            with torch.no_grad():
                grad_norm = clip_by_global_norm_(list(grads), self.max_grad_norm)
            for p, g in zip(params, grads):
                p.grad = g
            lr = self.learning_rate_at(self.nr_optimizer_steps)
            self.optimizer.param_groups[0]["lr"] = lr
            self.optimizer.step()
            self.nr_optimizer_steps += 1
            history.append({"loss/q_loss": loss.detach(), "q_value/q_value": q_action.detach().mean(),
                            "gradients/critic_grad_norm": grad_norm})
        out = {k: torch.stack([h[k] for h in history]).mean() for k in history[0]}
        out["lr/learning_rate"] = torch.tensor(lr)
        return out

    def _minibatch_loss(self, observations, actions, q_targets):
        q = self.q_net(observations)
        q_action = torch.gather(q, -1, actions.long()[:, None]).squeeze(-1)
        return (0.5 * (q_action - q_targets) ** 2).mean(), q_action.detach().mean()

    def _optimize_seeds(self, batch_arrays, epoch_indices=None):
        """``_optimize`` for every seed at once: ``batch_arrays`` ``[S, batch,
        ...]``, ``epoch_indices`` ``[S, nr_epochs, batch]`` (each seed's own
        permutations, from its generator unless given)."""
        P = self.parallel
        if epoch_indices is None:
            epoch_indices = P.draw(lambda g: torch.stack([
                torch.randperm(self.batch_size, generator=g, device=self.device) for _ in range(self.nr_epochs)]))
        minibatches = epoch_indices.to(self.device).reshape(P.nr_seeds, -1, self.minibatch_size)
        params = list(self.q_net.parameters())
        history = []
        lr = self.learning_rate
        for m in range(minibatches.shape[1]):
            mb = tuple(P.take(x, minibatches[:, m]) for x in batch_arrays)
            loss, q_mean = P.map(self._minibatch_loss, {"q_net": self.q_net}, *mb)
            grads = torch.autograd.grad(loss.sum(), params)
            with torch.no_grad():
                grad_norm = clip_by_global_norm_(list(grads), self.max_grad_norm, per_seed=True)
            for p, g in zip(params, grads):
                p.grad = g
            lr = self.learning_rate_at(self.nr_optimizer_steps)
            self.optimizer.param_groups[0]["lr"] = lr
            self.optimizer.step()
            self.nr_optimizer_steps += 1
            history.append({"loss/q_loss": loss.detach(), "q_value/q_value": q_mean,
                            "gradients/critic_grad_norm": grad_norm})
        out = {k: torch.stack([h[k] for h in history]).mean(dim=0) for k in history[0]}
        out["lr/learning_rate"] = torch.tensor(lr)
        return out

    # ------------------------------------------------------- eval/save loop

    @torch.no_grad()
    def _eval_iteration(self, eval_save_iteration):
        """``horizon`` greedy steps from a fresh eval reset -> the mean
        episode return and length."""
        seed = eval_reset_seed(self)
        with record_function("pqn/eval"):
            eval_env_state = self.eval_env.reset(seed, eval_mode=True)
            for _ in range(self.horizon):
                eval_env_state = self.eval_env.step(eval_env_state, self.greedy_action(eval_env_state.observation))
        if self.parallel is None:
            eval_metrics = {f"eval/{k}": float(eval_env_state.info[f"rollout/{k}"].mean())
                            for k in ("episode_return", "episode_length")}
        else:
            eval_metrics = {f"eval/{k}": self.parallel.split(eval_env_state.info[f"rollout/{k}"]).mean(dim=1).cpu().numpy()
                            for k in ("episode_return", "episode_length")}
        if self.logging_active:
            self.logger.log_dict(eval_metrics, (eval_save_iteration + 1) * self.eval_save_frequency)
        return eval_metrics

    def _init_train_carry(self):
        self.env_state = self.train_env.reset(train_reset_seed(self))
        return self.env_state

    def _eval_save_iteration(self, env_state, eval_save_iteration):
        for j in range(self.nr_updates_per_eval_save_iteration):
            update_step = eval_save_iteration * self.nr_updates_per_eval_save_iteration + j
            env_state, metrics = self.learning_iteration(env_state, update_step)
            if self.logging_active:
                iteration = update_step + 1
                values = {k: float(v) for k, v in metrics.items()}
                now = time.time()
                values["time/sps"] = int(self.batch_size / max(now - self._last_log_time, 1e-9))
                self._last_log_time = now
                values["steps/nr_env_steps"] = iteration * self.batch_size
                values["steps/nr_updates"] = iteration * self.nr_epochs * self.nr_minibatches
                self.metrics_history.append(values)
                self.logger.log_dict(values, iteration * self.batch_size)
        self.env_state = env_state
        eval_metrics = self._eval_iteration(eval_save_iteration) if self.evaluation_active else None
        if self.save_model:
            self.save()
        return env_state, eval_metrics

    def train(self):
        start = self._last_log_time = time.time()
        self.env_state, eval_history = run_training_program(self)
        if self.parallel is not None:
            finish(self, (self.q_net, self.optimizer))
        self.eval_history = None
        if eval_history is not None:
            steps = ((np.arange(self.nr_eval_save_iterations) + 1) * self.nr_updates_per_eval_save_iteration
                     * self.batch_size)
            self.eval_history = {"steps": steps, **eval_history}
        rlx_logger.info(f"Average time: {time.time() - start:.2f} s")

    # ----------------------------------------------------- save / load / test

    def checkpoint_tree(self):
        return {"critic": self.q_net.state_dict()}

    def restore_from_tree(self, tree):
        self.q_net.load_state_dict(tree["critic"])

    def save(self, file_name="latest.model"):
        ckpt.save_model_file(self.save_path, file_name, self.checkpoint_tree(), self.config.algorithm.to_dict())

    @classmethod
    def load(cls, config, train_env, eval_env, run_path, writer, explicitly_set_algorithm_params):
        return ckpt.load_model(cls, config, train_env, eval_env, run_path, writer,
                               explicitly_set_algorithm_params)

    @torch.no_grad()
    def test(self, episodes):
        """Greedy rollouts until ``episodes`` episodes are done."""
        seed = int(torch.randint(2**31 - 1, (), generator=self.host_generator))
        env_state = self.eval_env.reset(seed, eval_mode=True)
        step = lambda state: self.eval_env.step(state, self.greedy_action(state.observation))
        return collect_test_returns(step, env_state, episodes, self.horizon)

    def general_properties():
        return GeneralProperties
