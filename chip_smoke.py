"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each prints one line; any failure exits nonzero):

1. the card's name and power limit (nvidia-smi);
2. build the CUDA kernels from ``rlx_tpu_torch/csrc`` (nvcc, sm_90a);
3. kernel B1 (GAE) against its plain version at [64, 4096] (the PPO
   path's shape) and a ragged [64, 4097], at T = 1, 17, 65 and 200 with a
   ragged B = 1000, and with float terminations; two launches on the path's
   input must give the same bits;
4. kernel B2 (physics substep) against ``engine.step_reference``, 4
   substeps: the Ant at B=4096 and B=1024 (the PPO and FastTD3 batches) and
   a ragged B=1000, with entry-pose and given anchors, every DomainParams
   field set, a ctrl_sequence, and the Ant without contacts / actuators;
   kernel, device, host, plain and bound times at both batches;
5. PPO on ``locomotion.ant.cuda`` at the flagship size (4096 envs x 64
   steps, minibatch 32768, 4 epochs, 512/256/128 ELU+LayerNorm policy and
   critic, bf16 trunk) for 3 iterations through the runner's entry points,
   with the kernels' launch counters proving the path went through them:
   the first iteration eager, the next two replays of the captured
   learning iteration (``capture_choice`` must choose it), whose launches
   the counters count as they run;
6. one more PPO iteration, eager, under torch.profiler: wall time, device
   busy time and idle share, per-phase host spans, the top kernels by
   device time;
7. kernel B3 (C51 projection) against its plain version at [8192, 101] ->
   101 (the FastTD3 path's shape), a ragged [8193, 101], [4096, 51] -> 101,
   positions beyond the support and on atoms, every position at v_max
   (b = A_out - 1), rows whose 101 positions all clip to one end,
   101 -> 2 atoms, [64, 8192] -> 101 and [1027, 101] -> 11; two launches on
   the path's input must give the same bits;
8. FastTD3 on ``locomotion.ant.cuda`` at full width (1024 envs, batch 8192,
   n_step 3, 101 atoms, 512/256/128 ELU+LayerNorm policy and twin critic,
   f32, the default 1e6-transition buffer) through the entry points: 5
   prefill and 64 learning steps in 4 log lines, with the launch counters
   proving every update went through B3 and every env step through B2;
9. 16 more FastTD3 learning steps under torch.profiler, as phase 6;
10. PPO at the flagship width through ``Runner(argv=[...]).run()``: 2
    eval/save iterations of 1 learning iteration each (the second a
    replay of the captured iteration, as in phases 18, 19 and 24), evaluation and
    ``save_model`` on, ``environment.horizon`` cut from 1000 to 200 (the
    widths stay full), in a run directory under a temporary directory; the
    counters must read 2 B1 and 2 * 64 + 2 * 200 B2 launches, the history
    must step at 262144 and 524288, ``latest.model`` and ``best.model``
    must exist.  Then the same runner in test mode from ``latest.model``:
    every loaded parameter equal to the trained model's bit for bit, 10
    finite returns, at most 200 B2 launches.  Train, eval and test wall
    time, save and load ms and the checkpoint's MiB;
11. phase 8's FastTD3 saved with its optimizer state, loaded through the
    runner's test mode (1024 envs, horizon 200, 4 episodes): every
    parameter, target, normalizer entry, AdamW moment and the update count
    equal bit for bit, finite returns, at most 200 B2 launches;
12. SAC on ``locomotion.ant.cuda`` at the JAX bench's off-policy shape
    (1024 envs, batch 8192, 512/256/128 policy and twin critic, relu, f32,
    learning_starts 1024, a 1024 * 1024-transition buffer, evaluation off):
    1 prefill and 64 learning steps in 4 log lines, B2 launched exactly 65
    times, env-steps/s per log line; then 16 more steps under
    torch.profiler, as phase 6;
13. TD3 and DDPG at the same shape, 32 learning steps each: B2 exactly 33
    launches each, finite losses, env-steps/s;
14. SAC through ``Runner(argv=[...]).run()`` at that shape with its
    optimizer state (1 prefill + 16 learning steps, B2 exactly 17), then
    test mode from its ``latest.model`` (1024 envs, horizon 200, 4
    episodes): every parameter, target, ``log_alpha``, Adam moment and the
    update count equal bit for bit, at most 200 B2 launches;
15. C51 on ``classic.cart_pole.cuda`` through the Runner at the
    ``cartpole_spot_c51`` recipe (8 envs, batch 128, (512,) relu, 51 atoms
    over 0..500, lr 1e-3) with its optimizer state: the 10k-step prefill and
    256 learning steps, B3 launched exactly once a step, then test mode from
    its ``latest.model`` with every tensor equal bit for bit; B3 against its
    plain version at C51's [128, 51] -> 51 (0..500) and [32, 51] -> 51
    (-10..10), with rows whose every position is an atom or clips to one
    end, and its times and bound at both;
16. DQN, DDQN and DQN-HL-Gauss on CartPole at their recipes: the prefill and
    64 learning steps each, no kernel launched, env-steps/s;
17. PQN on CartPole through the Runner at its recipe: 2 learning iterations
    (the second a replay of the captured iteration), 2 evaluations and saves, then test mode, no kernel launched;
18. discrete PPO on CartPole at the flagship rollout and update shape (4096
    envs x 64 steps, minibatch 32768, 4 epochs) with the PPO defaults'
    network: 2 iterations, B1 launched exactly twice; B1 against its plain
    version on CartPole-like inputs at [64, 4096];
19. PPO, PPO over an observation window and PPO with memory actions on the
    velocity-masked Pendulum through the Runner at the
    ``pendulum_masked_*`` recipes (8 envs x 256 steps): 2 eval/save
    iterations each, B1 launched exactly twice each; B1 against its plain
    version at [256, 8], with its times and bound;
20. kernel B3 against its plain version at the SAC family's shapes:
    FlashSAC's [512, 101] -> 101 over -5..5 and the Pendulum recipes'
    [128, 101] -> 101 over -800..100 (FastSAC) and -300..0 (FlashSAC), each
    with rows whose entropy-shifted positions all lie beyond v_max or below
    v_min; two launches must give the same bits; times and bound at each;
21. FastSAC on the Ant through the Runner (1024 envs, batch 8192, its
    default widths, learning_starts = nr_envs, evaluation off) with its
    optimizer state: 1 prefill + 32 learning steps, B3 exactly 32 and B2
    exactly 33 launches, then test mode from ``latest.model`` with every
    parameter, target, normalizer entry, Adam moment and the update count
    equal bit for bit and at most 200 B2 launches;
22. FlashSAC the same way at its defaults (policy 128 x 2 blocks, critic
    256 x 2 blocks, expansion 4, batch 512, reward normalization on): B3
    exactly 32 and B2 33, the policy's Adam count 16 (delay 2), every
    projected kernel of unit norm per output unit and every BatchNorm
    (scale, bias) and RMSNorm scale of norm sqrt(d) within 1e-5 after the
    last step, the three BatchNorm streams restored bit for bit in test
    mode; then 16 more steps under torch.profiler, as phase 6;
23. REDQ, DroQ, AQE, TQC, SimBa, XQC, SimbaV2 and CrossQ on the Ant at
    their defaults (1024 envs, learning_starts = nr_envs): 16 learning
    steps each, B2 exactly 17 launches and B3 none, finite losses,
    env-steps/s; REDQ's next 16 steps (20 critic updates each) under
    torch.profiler, as phase 6;
24. ESPO and PPO-DTRL on the Ant at the flagship shape (4096 envs x 64
    steps, 512/256/128 ELU+LayerNorm, bf16 trunk; ESPO's 10 full-batch
    epochs, PPO-DTRL minibatch 32768 and 4 epochs): 2 iterations each, B1
    exactly 2 and B2 exactly 128 launches, ESPO's active epochs in [1, 10],
    PPO-DTRL's projected KL parts within 1e-3 of their bounds; one
    PPO-DTRL iteration's wall, device busy time and idle share from the
    device's events (``device_idle``);
25. BRO through the Runner at its defaults (1024 envs, learning_starts =
    nr_envs, 16 learning steps of 10 critic updates, a reset at step 14)
    with its optimizer state and init_copy, then test mode with every
    tensor equal bit for bit; its next 8 steps under torch.profiler; MPO
    (learning_starts = nr_envs) and FastMPO (its 10 per-env prefill steps)
    at their defaults, 16 learning steps each: B2 exactly 17, 17 and 26
    launches, no B1 or B3;
26. REPPO on the Ant at its defaults (4096 envs x 128 steps): 2 iterations
    (the second a replay of the captured iteration), B2 exactly 256 and no
    B1 (phase 49 profiles REPPO at this shape, eager and replayed); then
    through the Runner: 1 iteration, an evaluation and a save at horizon
    200 (B2 exactly 328), then test mode from latest.model with both nets
    and the normalizer equal bit for bit;
27. PPO with an LSTM, GRU, Mamba-2 and transformer memory on the Ant at
    the JAX package's recurrent shape (4096 envs x 32 steps, 4 minibatches
    of 1024 envs, 4 epochs, LSTM/GRU 128 wide; horizon 20, so every env
    resets inside each window): 1 iteration each (eager; phase 49 holds a
    replay against it), B1 exactly 1 and B2 exactly 32 launches, finite
    losses, env-steps/s; the policy's sequence re-run over a fresh window
    from its start carry gives the rollout's log-probabilities within
    1e-4 (phase 49 profiles the LSTM and the transformer, eager and
    replayed); PPO-LSTM
    through the Runner: 1 iteration, an evaluation and a save at horizon
    200 (B2 exactly 232, B1 exactly 1), then test mode from latest.model
    with every tensor equal bit for bit; B1 at [32, 4096] and [32, 4097];
28. PPO-LSTM on ``locomotion.robot.cuda`` (the quadruped, its default
    randomization and curriculum) at the JAX package's ``locomotion_lstm``
    shape (4096 envs x 32 steps, 4 minibatches, 4 epochs, LSTM 128): 2
    iterations on the plane (B1 2, B2 exactly 64: the second a replay of
    the captured iteration, whose launches the counters count as they
    ran); the default heightfield is phase 50's;
29. B2 against ``engine.step_reference`` at the quadruped's and the
    Booster T1's shapes (B=4096, evaluation mode, two env steps after the
    reset): the env's own DomainParams with a per-dof damping scale and
    its delayed PD targets as a ctrl_sequence, within 1e-4 on the envs the
    last step did not reset; times and bound at both;
30. feedforward PPO at the ``locomotion_ppo`` widths (minibatch 32768,
    its 32 steps cut to 8) on the heightfield: 1 iteration (eager, as a
    ``train()`` call's first; phase 50 replays this shape), B1 exactly 1,
    B2 none;
31. PPO-LSTM on ``locomotion.soccer.cuda`` (the Booster T1 on the plane)
    at the ``soccer_lstm`` shape: 1 iteration (B1 1, B2 exactly 32; cut
    from 2: phase 50 replays this shape, phase 44 soccer's train()); then
    through the Runner: 1 iteration, an evaluation
    and a save with the episode cut to 1 s (B2 exactly 82, B1 1), then
    test mode from latest.model with every tensor equal bit for bit and at
    most 50 B2 launches;
32. the pixel envs (``classic.pixel_grid.cuda``, ``classic.pixel_chase.cuda``)
    on the card against the CPU: 128 envs, 64 steps of the same actions from
    the same draws, observations, rewards, done flags, final observations
    and the uint8 frame stack equal exactly; no kernel launched;
33. NatureCNN on the card against the CPU: the four image nets (the C51
    Q-network, the Gaussian and categorical policies, the value critic) at
    batch 256 on 84x84x4 uint8 frames, outputs and every gradient within
    rtol 1e-4, atol 1e-5 (cuDNN held to f32);
34. DQN at the JAX bench's ``bench_conv`` shape (128 envs on pixel_chase,
    batch 256, an 8192-transition uint8 replay, one update a vector step):
    256 learning steps timed after a warm-up, env-steps/s and updates/s,
    the replay's bytes, then 64 steps profiled (spans ``dqn/act``,
    ``/env_step``, ``/store``, ``/sample``, ``/update``);
35. C51 on pixel_chase (128 envs, batch 256): 64 learning steps, B3
    exactly 64; B3 against its plain version at [256, 51] -> 51; DDQN and
    DQN-HL-Gauss 16 steps each, no kernel;
36. discrete PPO with NatureCNN policy and critic on pixel_chase (128 x 64,
    minibatch 2048, 4 epochs): 3 iterations, B1 exactly 3, one more
    profiled; B1 against its plain version at [64, 128]; PQN on pixel_grid,
    2 iterations, no kernel;
37. DQN on pixel_chase through the Runner with 2 evaluations and saves,
    then test mode from latest.model with every tensor equal bit for bit;
38. the native C++ env batcher (``environments/native/envbatch.cpp``, built
    by g++): ``native.cart_pole.host`` and ``native.pendulum.host`` with
    their results on the card and on the CPU, from the same seed under the
    same actions, over two horizons with auto-resets, at 8 and 1,024 envs,
    every output equal bit for bit and no kernel launched; the host time of
    a card step, split into the action's copy down, the C++ step and the
    copy up;
39. PPO on ``native.pendulum.host`` and discrete PPO on
    ``native.cart_pole.host`` at the ``hopper_ppo`` shape (8 envs x 256
    steps, minibatch 64, 10 epochs, (256, 256)): 1 iteration each, B1
    exactly 1; the same on ``classic.pendulum.cuda``; for the bridge's
    cost each Pendulum's rollout timed alone and one more iteration's
    device idle share (the host Pendulum's ``ppo/`` span profile, ~50 s
    of event parsing, was cut when phases 45-46 came in); B1 against
    its plain version at [256, 8] on each host path's inputs;
40. C51 on ``native.cart_pole.host`` at the ``cartpole_spot_c51`` recipe
    and FastTD3 on ``native.pendulum.host`` at ``pendulum_spot_fasttd3``'s:
    the prefill and 256 learning steps, B3 exactly once a step; B3 against
    its plain version at [128, 51] -> 51 and [128, 101] -> 101;
41. PPO on ``native.pendulum.host`` through the Runner with 2 evaluations
    and saves, then test mode from latest.model, every tensor equal bit for
    bit;
42. parallel seeds (``algorithm.nr_parallel_seeds``): PPO on the Ant at
    phase 5's flagship shape with 4 seeds (4 x 4096 envs x 64 steps) for 3
    iterations through ``create_model`` / ``train``, B1 exactly 3 and B2
    exactly 192 launches (phase 5's: the seeds ride in each launch), its
    env-steps/s summed over seeds against phase 5's and the idle share of
    one profiled 4-seed iteration; seed 1 of a 3-seed f32 PPO run on the Ant
    (64 envs x 16 steps) against its one-seed run after one iteration;
    SAC at ``OFFPOLICY_SHAPE`` with 4 seeds (4 x 1024 envs, batch 8192 a
    seed), B2 once a step; C51 on CartPole with 4 seeds, B3 once an update
    at ``[4 x 128, 51]``; B1 at [64, 16384], B2 at B = 16384 and B3 at
    [512, 51] -> 51 against their plain versions;
43. parallel seeds for the last twelve off-policy families: FastSAC
    (batch 8192), FlashSAC, CrossQ, REDQ, DroQ, AQE, TQC, XQC, SimbaV2,
    BRO, MPO and FastMPO on the Ant at 4 seeds x 1024 envs at their phase
    21-23 and 25 shapes, 1 prefill (FastMPO 10) + 8 learning steps and one
    evaluation (horizon cut to 32) each through ``create_model`` /
    ``train``: before the evaluation B2 exactly 9 (FastMPO 18) launches,
    as one seed, B3 exactly 8 for FastSAC and FlashSAC with every launch
    at ``[4 x batch, 101]`` and none for the others; every seed's eval
    return finite; env-steps/s summed over seeds against one seed's from a
    one-seed run of the same program just before (its launches alike);
    seed 1 of 3 against its one-seed run (``c3_checks``): REDQ's and
    FlashSAC's in float64 on the Pendulum (64 envs, batch 128, 4 learning
    steps; FlashSAC with B3's plain version) within 1e-9 over every
    parameter and running statistic, seed 2's mean |err| beyond 1e-3;
    FlashSAC's first-update policy and alpha gradients in f32 on the Ant
    (B2 and B3 on the folded rows, before any Adam step) within 1e-5 of
    the one-seed run's relative to their largest; B3 at [32768, 101] and
    [2048, 101] and B2 at B = 4096 against their plain versions;
44. parallel seeds on the robot and soccer envs (``robot_parallel_seeds``):
    PPO-LSTM on the plane quadruped and on soccer (the Booster T1) at
    phases 28 and 31's widths, 4 seeds x 1024 envs x 32 steps, 2 iterations
    each through ``create_model`` / ``train``, B2 exactly 64 and B1 exactly
    2 launches (one seed's), env-steps/s summed over seeds (the one-seed
    baselines cut for phase 51); 8 eval-mode steps of the 4-seed env, seed 1's
    rows against the one-seed env within 1e-5; B2 at both robots' 4 x 1024
    shapes with the env's own DomainParams against ``step_reference`` in
    float64, within twice the f32 plain version's own max |err| (the two
    f32 versions part by up to ~5e-4 in a few envs there, both as far from
    float64);
45. rendering's device half (``render_device_half``): PPO's
    ``render/offscreen.rollout_qpos`` on the Ant at 64 envs x 50 steps on
    the card, through B2 (exactly 50 launches), against the CPU rollout of
    the same parameters (env 0's poses, f32, max |err| printed and held
    within 1e-4); the frames
    are rendered only where ``mujoco`` imports (the line says which half
    ran);
46. the dp mesh (``mesh_phase``, ``rlx_tpu_torch/benchmarks/mesh_phase.py``):
    2 gloo ranks on the one card (NCCL refuses two ranks on one device):
    PPO on the Ant at 2 x 2048 envs against 1 x 4096 (16 steps, f32
    512/256/128 ELU+LayerNorm, shard-local off): the first update's
    gradients as PPO's own ``_clip_gradients`` leaves them (averaged over
    dp, clipped) within 1e-5 of the dp = 1 run's relative to their
    largest, their norms before the clip within 1e-5 relative, and the
    parameters after the iteration within 1e-5; the rank-step ms, the
    gradients' all_reduce ms and both env-steps/s (the two ranks share one
    card: a gain there is the host's two processes issuing launches, not
    more card); SAC and FastTD3 at dp = 2 (2 x 512 envs, batch 8192),
    every parameter equal on both ranks; B1, B2 and B3 launches per rank;
    then a one-rank NCCL group: the PPO iteration's gradients through
    NCCL's all_reduce and broadcast on the card, back bit for bit, and the
    iteration equal bit for bit to the run with no group (a mesh of one
    rank makes no collective: NCCL at dp > 1 needs a card a rank);
47. deployment (``deployment_phase``): PPO at the ``locomotion_ppo``
    recipe on the Go2 on the plane (4096 envs x 32 steps, 1 iteration:
    eager, a ``train()`` call's first; B1 exactly 1 and B2 exactly 32: one
    launch a control step); B2 at the
    Go2's shape against ``engine.step_reference`` held as in phase 44
    (against float64, at twice the f32 plain version's own error); the
    checkpoint through ``load_policy_apply`` on the card and on the CPU,
    each driving ``Go2DeploymentRunner`` on ``FakeGo2SDK`` over 400
    scripted ticks (Y, B, a joint-velocity spike, B, X, A): the modes
    equal, the targets within 1e-5 in nn mode and equal in the ramps, the
    nn actions within 1e-5 of the training policy's mean on the env's
    policy-indexed observation, an nn tick's median and p99 ms on each;
    PPO-GRU on soccer at ``soccer_lstm``'s widths (1024 envs x 32 steps,
    B1 1, B2 32), saved and exported by ``convert.py`` in a subprocess,
    ``TorchPolicyGRU`` on the card over 32 steps with its carry within
    1e-5 of ``RecurrentPolicy.one_step`` and of the CPU's, the meta JSON
    against the env; PPO over a brax-style stub under
    ``PlaygroundAdapter`` on the card (2 iterations, B1 2), and the
    playground registration's ImportError;
48. (run right after phase 6, while the profiler's tracer keeps every
    record of a replay) the captured learning iteration
    (``capture_phase``): PPO at phase 5's
    flagship shape, discrete PPO at phase 18's, ESPO (its stop set to fire
    within the iteration: ``max_ratio_delta`` 1e-4) and PPO-DTRL at phase
    24's, and PPO over an observation window at phase 19's: one eager
    iteration against the first replay of the captured one from the same
    state (nets, Adam's moments and counts, the device step count, both
    generators, the env state), every tensor and metric equal bit for bit;
    a second replay from the same nets and env state draws fresh noise (its
    env state differs, the model's generator advanced); each replay's B1
    and B2 launches; for the flagship, the captured graph's kernel nodes
    by name (its ``cudaGraphDebugDotPrint`` dump: exactly 64 B2 and 1 B1,
    as the counters count a replay) and one replay under torch.profiler
    with 64 and 1 seen (up to three windows: the tracer drops a record now
    and then),
    env-steps/s over 5 eager and 5 replayed iterations (each read as
    ``train()`` reads it), the device idle share of one replay and of one
    eager iteration, the capture's seconds and the graph pool's MiB;
49. (run right after phase 48) the captured learning iteration of the
    recurrent PPOs, REPPO and PQN (``capture_families_phase``): PPO-LSTM,
    -GRU, -Mamba-2 and -transformer on the Ant at phase 27's shape, REPPO at
    phase 26's and PQN on CartPole at phase 17's recipe: one eager
    iteration against the first replay from the same state (nets, Adam's
    moments and counts, the device step counts, REPPO's normalizer and
    old-policy snapshot, the policy carry and PQN's update step, both
    generators, the env state, every metric) bit for bit; a second replay
    from the same state draws fresh noise; each replay's launches (B1 1 and
    B2 32 for the recurrent PPOs, B2 128 for REPPO, none for PQN); PPO-LSTM's
    graph nodes by name (32 B2, 1 B1); for PPO-LSTM, the transformer and
    REPPO env-steps/s over 3 eager and 3 replayed iterations and the idle
    share of one of each from the device's events;
50. (run right after phase 49) the captured learning iteration on the
    robot and soccer envs (``capture_robot_phase``): PPO-LSTM on the
    robot's plane and on soccer at phases 28 and 31's shape (4096 envs x 32
    steps, LSTM 128), feedforward PPO on the default heightfield at phase
    30's shape, and PPO-LSTM on the heightfield at 4096 envs with its 32
    steps cut to 8: one eager iteration against the first replay from the
    same state bit for bit, as phase 49; a second replay draws fresh noise;
    each replay's launches (B2 32 and B1 1 on the plane and soccer, B2 0
    and B1 1 over the heightfield, whose graph holds the engine's eager
    path); the capture's seconds, pool MiB and graph nodes (CUDA's own
    count); eager (the reference iteration) and replayed (3) env-steps/s,
    with the idle share of one of each from the device's events (for
    feedforward PPO on the heightfield the wall clock only); the 50M-step
    the heightfield's eager physics alone a control step (no B2 launch);
    then ``locomotion_lstm`` at its own shape, 4096 envs x 32 steps on the
    heightfield, through ``model.train()`` for 3 iterations
    (``heightfield_recipes``; it runs the two PPO recipes too when called
    alone): the captured path logged, B1 3 and B2 0 launches, one graph of
    B1 1 a replay, the capture's seconds, pool MiB and graph nodes, each
    iteration's env-steps/s and the recipe's budget in hours a seed at the
    replayed and the eager rate;
51. (run right after phase 50) the captured learning step of the
    off-policy core (``capture_offpolicy_phase``): FastTD3 at phase 8's
    shape, FastSAC at phase 21's and SAC, TD3 and DDPG at
    ``OFFPOLICY_SHAPE``, 1024 envs on the Ant after each one's prefill: an
    eager learning step against the first replay from the same state bit
    for bit (the nets, targets, Adam's state, the normalizer, the replay
    buffer's storage, write head and fill, the metric sums, the step count,
    both generators, the env state, every metric), a second replay draws
    fresh noise, each replay launches B2 1, B3 1 for FastTD3 and FastSAC
    and B1 0 (counters and the graph's kernel nodes by name); the graph's
    node count, capture s and pool MiB; 32 learning steps eager and 32
    replayed through ``_logging_iteration`` as ``train()`` runs them, each
    after 16 untimed, with the idle share of a logging iteration of each;
    then one FastTD3
    ``train()`` through ``create_model``: the captured path logged, B2 and
    B3 once a learning step.

Each kernel is timed three ways: CUDA events around a run of calls
(``ms``: the wrapper's host cost shows when it exceeds the kernel's), the
profiler's time of the kernel alone (``device_ms``), and the host's time
per call over 1,000 enqueues with no sync inside (``host_us``).  The line before the last is the
kernels' JSON record (B1's and B3's ``by_shape`` hold their numbers at the
shapes of phases 15, 19, 20, 27, 35, 36, 39, 40, 42 and 43, B2's at the robots' of phases 29, 44 and 47 and
the 4-seed batches of phases 42 and 43), the
last line the device record.  Needs a CUDA device; never falls back to the CPU.
"""

import json
import logging
import math
import os
import subprocess
import sys
import tempfile
import time

import torch

H100_BYTES_PER_S = 3.35e12   # HBM3, H100 SXM data sheet
H100_F32_FLOPS = 67e12       # f32 outside the tensor cores, H100 SXM data sheet
ITERATIONS = 3
# bench_offpolicy's shape (the JAX package's bench.py): batch 8192,
# 512/256/128 nets, learning_starts = nr_envs; the rest of each
# algorithm's defaults (SAC, TD3, DDPG: relu, no LayerNorm, f32)
OFFPOLICY_SHAPE = {
    "algorithm.batch_size": 8192,
    "algorithm.policy_hidden_sizes": (512, 256, 128),
    "algorithm.critic_hidden_sizes": (512, 256, 128),
    "algorithm.learning_starts": 1024,
    "algorithm.buffer_size": 1024 * 1024,
    "algorithm.evaluation_active": False,
}


def fail(msg):
    print(f"FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def time_ms(fn, reps):
    """Mean device time of ``fn`` over ``reps`` calls (CUDA events, after a warm-up)."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def host_us(fn, calls=1000):
    """Host microseconds per call of ``fn``: ``perf_counter`` over ``calls``
    enqueues with no sync inside (what the wrapper costs the host)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    us = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return us


def max_err(outs, refs, rtol, atol, what):
    """Max |out - ref| over pairs; fails where |out - ref| > atol + rtol |ref|."""
    worst = 0.0
    for o, r in zip(outs, refs):
        if o.shape != r.shape:
            fail(f"{what}: shape {tuple(o.shape)} != {tuple(r.shape)}")
        if o.numel() == 0:
            continue
        if not torch.isfinite(o).all():
            fail(f"{what}: non-finite output")
        diff = (o - r).abs()
        if (diff > atol + rtol * r.abs()).any():
            fail(f"{what}: max |err| {diff.max().item():.3g} beyond rtol={rtol} atol={atol}")
        worst = max(worst, diff.max().item())
    return worst


def kernel_device_ms(fn, reps, kernel_name):
    """Mean device time of the kernel whose name contains ``kernel_name``
    over ``reps`` calls of ``fn``, from torch.profiler's CUDA events: the
    kernel alone, where ``time_ms`` also counts a host that enqueues more
    slowly than the kernel runs.  The tracer may drop events of the window
    (it once kept 45 of 100), so the mean is over the launches it saw, at
    least half, and a window that kept fewer is traced again, three times
    at most."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        times = [e.time_range.elapsed_us() for e in prof.events()
                 if e.device_type == DeviceType.CUDA and kernel_name in e.name]
        if reps // 2 <= len(times) <= reps:
            return sum(times) / len(times) / 1e3
    fail(f"profiler saw {len(times)} launches of {kernel_name} in {reps} calls, three windows running")


def profile_spans(fn, span_prefix):
    """Run ``fn`` once under torch.profiler: wall ms, device busy ms (the sum
    of kernel times; kernels run one at a time on this stream), idle share,
    the host and device time of the ``span_prefix`` record_function spans,
    and the top kernels by device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # A record_function span shows up twice: as a CPU event (host time) and
    # as a GPU annotation (first to last kernel it launched).
    events = prof.events()
    cpu_names = {e.name for e in events if e.device_type == DeviceType.CPU}
    kernel_ms, host_spans_ms, device_spans_ms = {}, {}, {}
    for e in events:
        ms = e.time_range.elapsed_us() / 1e3
        if e.name.startswith(span_prefix):
            spans = host_spans_ms if e.device_type == DeviceType.CPU else device_spans_ms
            spans[e.name] = spans.get(e.name, 0.0) + ms
        elif e.device_type == DeviceType.CUDA and e.name not in cpu_names:
            kernel_ms[e.name] = kernel_ms.get(e.name, 0.0) + ms
    busy_ms = sum(kernel_ms.values())
    top = sorted(kernel_ms.items(), key=lambda kv: -kv[1])[:6]
    return {
        "wall_ms": wall_ms, "device_busy_ms": busy_ms,
        "device_idle_share": 1.0 - busy_ms / wall_ms, "host_spans_ms": host_spans_ms,
        "device_spans_ms": device_spans_ms, "top_kernels_ms": {k[:60]: v for k, v in top},
    }


def device_idle(fn, span_prefix):
    """Run ``fn`` once under torch.profiler with the device's activity only,
    reading the raw events: wall ms, device busy ms (every kernel and copy;
    not the ``span_prefix`` annotations) and idle share.  For programs of
    10^5-10^6 small kernels, where ``profile_spans``' host events and their
    parsing take minutes."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    events = [e for e in prof.profiler.kineto_results.events()
              if e.device_type() == DeviceType.CUDA and not e.name().startswith(span_prefix)]
    busy_ms = sum(e.duration_ns() for e in events) / 1e6
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms, "device_idle_share": 1.0 - busy_ms / wall_ms,
            "device_events": len(events), "read_s": time.perf_counter() - t0}


def kernel_times(fn, plain, kernel_name, reps=200, plain_reps=20):
    """ms (CUDA events), device_ms (the profiler's kernel time), host_us
    and plain_ms of one kernel call ``fn`` and its plain version ``plain``."""
    return dict(ms=time_ms(fn, reps), device_ms=kernel_device_ms(fn, reps, kernel_name), host_us=host_us(fn),
                plain_ms=time_ms(plain, plain_reps))


def roofline(nbytes, flops):
    """(bound ms, what bounds it): the larger of bytes over the memory rate
    and f32 operations over the f32 rate."""
    by_bytes, by_flops = nbytes / H100_BYTES_PER_S, flops / H100_F32_FLOPS
    return max(by_bytes, by_flops) * 1e3, "bytes" if by_bytes >= by_flops else "operations"


def counts():
    """The three kernels' launch counters."""
    from rlx_tpu_torch.ops.engine_substep_cuda import step_cuda
    from rlx_tpu_torch.ops.gae_cuda import gae_advantages_cuda
    from rlx_tpu_torch.ops.projection_cuda import categorical_projection_cuda

    return {"engine_substep": step_cuda.launches, "gae": gae_advantages_cuda.launches,
            "categorical_projection": categorical_projection_cuda.launches}


def zero_counts():
    from rlx_tpu_torch.ops.engine_substep_cuda import step_cuda
    from rlx_tpu_torch.ops.gae_cuda import gae_advantages_cuda
    from rlx_tpu_torch.ops.projection_cuda import categorical_projection_cuda

    torch.cuda.synchronize()
    step_cuda.launches = gae_advantages_cuda.launches = categorical_projection_cuda.launches = 0


def check_logged(name, history, expected_updates=None):
    """Fails unless every logged value is finite (and, when given, the
    logged update counts are ``expected_updates``)."""
    if expected_updates is not None and [m["steps/nr_updates"] for m in history] != expected_updates:
        fail(f"{name} logged updates {[m['steps/nr_updates'] for m in history]} != {expected_updates}")
    for it, metrics in enumerate(history):
        for k, v in metrics.items():
            if not math.isfinite(v):
                fail(f"{name} log line {it}: {k} = {v}")


def same_tree(a, b):
    """Number of tensors in two nested checkpoint trees, failing unless
    every tensor is equal bit for bit and every other leaf equal."""
    if isinstance(a, dict):
        if set(a) != set(b):
            fail(f"checkpoint trees have other keys: {sorted(a)} != {sorted(b)}")
        return sum(same_tree(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        if len(a) != len(b):
            fail("checkpoint trees have lists of other lengths")
        return sum(same_tree(x, y) for x, y in zip(a, b))
    if isinstance(a, torch.Tensor):
        if a.dtype != b.dtype or not torch.equal(a.cpu(), b.cpu()):
            fail(f"a loaded tensor of shape {tuple(a.shape)} differs from the saved one")
        return 1
    if a != b:
        fail(f"a loaded value {b!r} differs from the saved {a!r}")
    return 0


def seed_one_of_three(name, environment, overrides, device):
    """(seed-stacked model after a 3-seed run from seed 3, the one-seed model
    at ``seed_for(3, 1)`` after its run) of off-policy ``name``."""
    from rlx_tpu_torch.algorithms.parallel_seeds import seed_for
    from rlx_tpu_torch.algorithms.training_program import run_training_program
    from rlx_tpu_torch.config import create_model, make_config

    config = lambda **seeds: make_config(f"{name}.cuda", environment, **{
        "runner.device": device, "algorithm.evaluation_active": False, "algorithm.logging_active": False,
        **overrides, **seeds})
    three = create_model(config(**{"algorithm.nr_parallel_seeds": 3, "environment.seed": 3}))
    one = create_model(config(**{"environment.seed": seed_for(3, 1)}))
    return three, one


def first_gradients(model):
    """Record the gradients of the first ``apply_gradients`` of each of the
    policy's, the critic's and alpha's train states: ``{name: [grad, ...]}``,
    filled as ``model`` trains."""
    grads = {}
    for name in ("policy", "critic", "alpha"):
        state = getattr(model, name)
        apply = state.apply_gradients

        def recording(g, *args, name=name, apply=apply, **kwargs):
            grads.setdefault(name, [x.detach().clone() for x in g])
            return apply(g, *args, **kwargs)

        state.apply_gradients = recording
    return grads


def c3_checks(device):
    """Seed 1 of a 3-seed off-policy run is its one-seed run (suspect C3: in
    f32 the two part by rounding that Adam amplifies, as far as which rows
    are drawn makes it):

    - REDQ and FlashSAC in float64 on ``classic.pendulum.cuda`` (64 envs,
      batch 128, 4 learning steps; REDQ 10 critic updates a step; B3 takes
      f32 only, so FlashSAC projects with its plain version there): the max
      |err| of seed 1's parameters and running statistics against its
      one-seed run, and seed 2's mean |err| against the same run;
    - FlashSAC on the Ant in f32 (B2 and B3 on the folded rows; 64 envs and
      batch 128): seed 1's gradients of the first update against the
      one-seed run's, the policy's and alpha's before any Adam step, the
      critic's after the policy's first step: max |err| over max |grad|
      for each.

    Float64 leaves rounding at ~1e-12 on any draw stream and the f32
    gradients at f32 rounding; a seed path that computed something else
    (another batch, draw or statistic) would part both by far more."""
    from rlx_tpu_torch.algorithms.flashsac.cuda import flashsac as flashsac_module
    from rlx_tpu_torch.algorithms.training_program import run_training_program
    from rlx_tpu_torch.models.layers import running_buffers
    from rlx_tpu_torch.ops.distributional import categorical_projection_reference

    def tensors(model, s=None):
        """Every parameter and running statistic of the policy, the critic,
        their targets and alpha (seed s's)."""
        out = []
        for state in ("policy", "critic", "alpha"):
            for attr in ("module", "target"):
                m = getattr(getattr(model, state), attr)
                if m is not None:
                    out += [v if s is None else v[s] for v in list(m.parameters()) + list(running_buffers(m).values())]
        return out

    out = {}
    default, projection = torch.get_default_dtype(), flashsac_module.categorical_projection_dense
    torch.set_default_dtype(torch.float64)
    flashsac_module.categorical_projection_dense = categorical_projection_reference
    try:
        for name, extra in (("redq", {"algorithm.q_update_steps": 10}), ("flashsac", {})):
            three, one = seed_one_of_three(name, "classic.pendulum.cuda", {
                "environment.nr_envs": 64, "algorithm.learning_starts": 64, "algorithm.total_timesteps": 64 * 5,
                "algorithm.logging_frequency": 64 * 4, "algorithm.batch_size": 128, **extra}, device)
            run_training_program(three)
            one.train()
            ref = tensors(one)
            if not all(b.dtype == torch.float64 and torch.isfinite(b).all() for b in ref):
                fail(f"C3: {name}'s float64 run holds non-finite values or values of another type")
            out[f"{name}_float64_max_abs_err"] = max((a - b).abs().max().item() for a, b in zip(tensors(three, 1), ref))
            out[f"{name}_float64_seed2_mean_abs_err"] = (
                sum((a - b).abs().sum().item() for a, b in zip(tensors(three, 2), ref)) / sum(b.numel() for b in ref))
            out[f"{name}_float64_values"] = sum(b.numel() for b in ref)
            del three, one
    finally:
        torch.set_default_dtype(default)
        flashsac_module.categorical_projection_dense = projection

    three, one = seed_one_of_three("flashsac", "locomotion.ant.cuda", {
        "environment.nr_envs": 64, "algorithm.learning_starts": 64, "algorithm.total_timesteps": 64 * 2,
        "algorithm.logging_frequency": 64, "algorithm.batch_size": 128, "environment.initial_state_noise": 0.1},
        device)
    grads3, grads1 = first_gradients(three), first_gradients(one)
    run_training_program(three)
    one.train()
    for name in ("policy", "alpha", "critic"):
        ref = torch.cat([g.reshape(-1) for g in grads1[name]])
        got = torch.cat([g[1].reshape(-1) for g in grads3[name]])
        control = torch.cat([g[2].reshape(-1) for g in grads3[name]])
        scale = ref.abs().max().item()
        out[f"flashsac_first_{name}_grad_rel_err"] = (got - ref).abs().max().item() / scale
        out[f"flashsac_first_{name}_grad_seed2_rel_err"] = (control - ref).abs().max().item() / scale
    return out


def robot_substep_check(kernels, robot, env_class, env_name, overrides, g, B=4096, against_float64=False):
    """B2 against ``engine.step_reference`` on a robot (phases 29 and 47): the
    env at ``B`` envs in evaluation mode (the curriculum at 1: every
    randomization axis drawn), two env steps after the reset, with the env's
    own DomainParams and its delayed PD targets as a ctrl_sequence, compared
    at 1e-4 on the envs that the last step did not reset (a reset leaves a
    foot exactly on the ground, where the first contact's damper turns on
    the last bit of the kinematics).  The damping scale is per dof, [nv, B]:
    the env's times a factor in [0.5, 1.5) for each dof and env (the joint
    locks' 1000x damping make the explicit integrator diverge within a step
    in both packages, so the envs the reset locked have terminated by
    then).  With ``against_float64`` the kernel is held instead, as in
    phase 44, against the plain version in float64 at twice the f32 plain
    version's own max |err| from it: a few envs' stiff contacts leave the
    f32 plain version itself 2e-4 to 6e-4 from float64 there, and the
    kernel's rounding as far in others, so the two f32 versions part by
    more than 1e-4 (the Go2 and the quadruped alike, at every generator
    stream tried); its max |err| against the f32 plain version and the
    envs beyond 1e-4 are reported.  Kernel, device, host, plain and bound
    times go into ``kernels[1]["by_shape"][f"{robot} B={B}"]``."""
    from rlx_tpu_torch.benchmarks.b2_robot_conditioning import float64_reference, substep_case
    from rlx_tpu_torch.ops.engine_substep_cuda import step_cuda, substep_bytes, substep_flops
    from rlx_tpu_torch.physics import engine

    env, state, args, kw = substep_case(env_class, env_name, overrides, g, B)
    internal = state.physics["internal"]
    locks = int((~internal["joint_dropout_lock"]).sum())
    kept = ~(state.terminated | state.truncated)
    changing = bool((kw["ctrl_sequence"][1:] != kw["ctrl_sequence"][:1]).any())
    out = step_cuda(*args, **kw)
    ref = engine.step_reference(*args, **kw)
    torch.cuda.synchronize()
    held = "rtol=atol=1e-4"
    if against_float64:
        ref64 = float64_reference(args, kw)
        worst = lambda outs: max((o[kept].double() - r[kept]).abs().max().item() for o, r in zip(outs, ref64))
        kernel64, plain64 = worst(out), worst(ref)
        if not (all(torch.isfinite(o[kept]).all() for o in out) and kernel64 <= 2.0 * plain64):
            fail(f"substep ({robot}, B={B}): max|err| {kernel64:.3g} against the float64 plain version, beyond twice "
                 f"the f32 plain version's {plain64:.3g}")
        per_env = torch.stack([(o - r).abs().reshape(B, -1).max(1).values for o, r in zip(out, ref)]).max(0).values
        err = per_env[kept].max().item()
        held = (f"{kernel64:.3g} against it in float64, where the f32 plain version stands {plain64:.3g} from it "
                f"(limit twice that); {int((per_env[kept] > 1e-4).sum())} envs beyond 1e-4 of the f32 plain version")
    else:
        err = max_err([o[kept] for o in out], [r[kept] for r in ref], 1e-4, 1e-4,
                      f"substep ({robot}, B={B}, the env's DomainParams)")
    substep = lambda: step_cuda(*args, **kw)
    model = env.model
    flops = substep_flops(model, dr=True) * B * env.nr_substeps
    # the state and anchors in and out, the whole ctrl_sequence and every
    # DomainParams field read once
    nbytes = (substep_bytes(model, B, with_anchors=True)
              + 4 * (kw["ctrl_sequence"].numel() - B * len(model.act_dof))
              + 4 * sum(f.numel() for f in kw["dr"] if f is not None))
    t = kernel_times(substep, lambda: engine.step_reference(*args, **kw), "engine_substep_kernel", reps=50)
    t["bound_ms"], t["bound_by"] = roofline(nbytes, flops)
    print(f"B2 engine_substep on the {robot} (nq {model.nq}, nv {model.nv}, nbody {model.nbody}, ncon "
          f"{len(model.con_body)}) at B={B}, {env.nr_substeps} substeps, against engine.step_reference: "
          f"max|err| {err:.3g} ({held}) over the {int(kept.sum())} envs not just reset, {locks} "
          f"locked joints left, the targets "
          f"{'change' if changing else 'hold'} between substeps; kernel {t['ms']:.4f} ms (device "
          f"{t['device_ms']:.4f} ms, host {t['host_us']:.1f} us a call) plain {t['plain_ms']:.2f} ms bound "
          f"{t['bound_ms']:.5f} ms ({t['bound_by']})")
    row = {**t, "max_abs_err": err}
    if against_float64:
        row.update(max_abs_err_float64=kernel64, plain_max_abs_err_float64=plain64)
    kernels[1]["by_shape"] = {**kernels[1].get("by_shape", {}), f"{robot} B={B}": row}
    kernels[1]["max_abs_err"] = max(kernels[1]["max_abs_err"], err)
    return t, err


def robot_parallel_seeds(kernels, launches_by_path, seeds=4, nr_envs=1024, nr_steps=32):
    """Phase 44: 4-seed PPO-LSTM on the plane robot (the quadruped) and on
    soccer (the Booster T1) at phases 28 and 31's widths, ``seeds`` x
    ``nr_envs`` envs, 2 iterations each through ``create_model`` /
    ``train``: B2 exactly ``2 x nr_steps`` launches and B1 2, one seed's
    counts; env-steps/s summed over seeds (the one-seed baselines, each of
    which paid a capture, were cut to pay for phase 51); 8 env steps (eval mode: every
    randomization axis drawn) of the 4-seed env against the one-seed env
    at seed 1's seed under the same actions; B2 at both robots' folded
    shapes (the 4-seed env's own DomainParams and delayed targets) against
    ``engine.step_reference`` in float64, as accurate as the f32 plain
    version.  Returns the rates a path."""
    from rlx_tpu_torch.algorithms.parallel_seeds import seed_for
    from rlx_tpu_torch.benchmarks.b2_robot_conditioning import float64_reference
    from rlx_tpu_torch.config import create_model, make_config
    from rlx_tpu_torch.environments.locomotion.robot.cuda.environment import LocomotionEnv
    from rlx_tpu_torch.environments.locomotion.soccer.cuda.environment import SoccerEnv
    from rlx_tpu_torch.ops.engine_substep_cuda import step_cuda, substep_bytes, substep_flops
    from rlx_tpu_torch.physics import engine

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(44)
    lstm_shape = {"runner.device": "cuda", "algorithm.nr_steps": nr_steps, "algorithm.nr_minibatches": 4,
                  "algorithm.nr_epochs": 4, "algorithm.rnn_hidden_dim": 128, "algorithm.learning_rate": 3e-4,
                  "algorithm.evaluation_active": False, "algorithm.logging_active": False}
    paths = {"robot_plane": (LocomotionEnv, "locomotion.robot.cuda", {"environment.terrain.type": "plane"}),
             "soccer": (SoccerEnv, "locomotion.soccer.cuda", {})}
    rates = {}
    for path, (env_class, env_name, overrides) in paths.items():
        def train(nr_seeds):
            model = create_model(make_config("ppo_lstm.cuda", env_name, **{
                **lstm_shape, **overrides, "environment.nr_envs": nr_envs,
                "algorithm.total_timesteps": 2 * nr_envs * nr_steps, "algorithm.nr_parallel_seeds": nr_seeds}))
            if model.train_env.nr_envs != nr_seeds * nr_envs:
                fail(f"{path} at {nr_seeds} seeds: the env holds {model.train_env.nr_envs} envs")
            zero_counts()
            t0 = time.perf_counter()
            model.train()
            torch.cuda.synchronize()
            elapsed = time.perf_counter() - t0
            launches = counts()
            expected = {"engine_substep": 2 * nr_steps, "gae": 2, "categorical_projection": 0}
            if launches != expected:
                fail(f"{path} PPO-LSTM at {nr_seeds} seeds: launches {launches} != {expected} (one seed's counts)")
            for p in list(model.policy.parameters()) + list(model.critic.parameters()):
                if not torch.isfinite(p).all():
                    fail(f"{path} PPO-LSTM at {nr_seeds} seeds: non-finite parameters")
            return nr_seeds * 2 * nr_envs * nr_steps / elapsed, elapsed, launches

        rate, train_s, launches = train(seeds)
        launches_by_path[f"{path}_lstm_{seeds}_seeds"] = launches
        rates[path] = {"env_steps_per_s": rate, "train_s": train_s}
        print(f"parallel seeds {path} PPO-LSTM: {seeds} seeds x {nr_envs} envs x {nr_steps} steps, 2 iterations in "
              f"{train_s:.2f} s, {rate:.0f} env-steps/s summed over seeds; launches {launches} (one seed's)")

        # seed 1's rows of the 4-seed env against its one-seed env, eval mode
        config = make_config("ppo_lstm.cuda", env_name, **{"runner.device": "cuda", **overrides})
        env = env_class(config.environment, seeds * nr_envs, device="cuda")
        single = env_class(config.environment, nr_envs, device="cuda")
        seed_list = [seed_for(5, s) for s in range(seeds)]
        state, ref = env.reset(seed_list, eval_mode=True), single.reset(seed_list[1], eval_mode=True)
        rows = slice(nr_envs, 2 * nr_envs)
        errs = {}
        for t in range(8):
            action = 2.0 * torch.rand(seeds * nr_envs, env.nr_actuator_joints, device=dev, generator=g) - 1.0
            state, ref = env.step(state, action), single.step(ref, action[rows])
            for field, got, want in (("observation", state.observation, ref.observation),
                                     ("reward", state.reward, ref.reward),
                                     ("terminated", state.terminated, ref.terminated),
                                     ("truncated", state.truncated, ref.truncated),
                                     ("qpos", state.physics["qpos"], ref.physics["qpos"]),
                                     ("qvel", state.physics["qvel"], ref.physics["qvel"])):
                err = (got[rows].double() - want.double()).abs().max().item()
                errs[field] = max(errs.get(field, 0.0), err)
        torch.cuda.synchronize()
        if max(errs.values()) > 1e-5:
            fail(f"{path}: seed 1's rows of the {seeds}-seed env against its one-seed env {errs} beyond 1e-5")
        print(f"parallel seeds {path} env: 8 eval-mode steps of {seeds} x {nr_envs} envs, seed 1's rows against the "
              f"one-seed env at seed_for(5, 1): max|err| " + json.dumps(errs)
              + (" (bit for bit)" if max(errs.values()) == 0.0 else ""))

        # B2 at the folded shape: the 4-seed env's own DomainParams and
        # delayed targets, on the envs the last step did not reset.  After
        # 8 eval-mode steps the stiff contacts leave the f32 plain version
        # itself up to ~5e-4 from the float64 one in a few of the 4096 envs,
        # and the kernel's rounding as far in others, so the two f32
        # versions part by more than 1e-4 there: the kernel is held against
        # the float64 plain version at twice the f32 plain version's own
        # max |err| (the kernel as accurate as the plain f32 version), and
        # its max |err| against the f32 plain version is reported
        internal = state.physics["internal"]
        action = 2.0 * torch.rand(seeds * nr_envs, env.nr_actuator_joints, device=dev, generator=g) - 1.0
        delayed, _ = env.action_delay.delay_action(action, internal)
        targets = env.control_function.process_action(delayed, internal).contiguous()
        args = (env.model, state.physics["qpos"], state.physics["qvel"], targets[0])
        kw = dict(nr_substeps=env.nr_substeps, dr=env._domain_params(internal), ctrl_sequence=targets,
                  contact_state=state.physics["contact_anchor"])
        kept = ~(state.terminated | state.truncated)
        out, ref_out = step_cuda(*args, **kw), engine.step_reference(*args, **kw)
        ref64 = float64_reference(args, kw)
        torch.cuda.synchronize()
        B = seeds * nr_envs
        robot = env.env_config.robot
        worst = lambda outs: max((o[kept].double() - r[kept]).abs().max().item() for o, r in zip(outs, ref64))
        kernel64, plain64 = worst(out), worst(ref_out)
        if not (all(torch.isfinite(o[kept]).all() for o in out) and kernel64 <= 2.0 * plain64):
            fail(f"substep ({robot}, {seeds} seeds x {nr_envs}): max|err| {kernel64:.3g} against the float64 plain "
                 f"version, beyond twice the f32 plain version's {plain64:.3g}")
        err = max((o[kept] - r[kept]).abs().max().item() for o, r in zip(out, ref_out))
        model = env.model
        nbytes = (substep_bytes(model, B, with_anchors=True)
                  + 4 * (targets.numel() - B * len(model.act_dof))
                  + 4 * sum(f.numel() for f in kw["dr"] if f is not None))
        t = kernel_times(lambda: step_cuda(*args, **kw), lambda: engine.step_reference(*args, **kw),
                         "engine_substep_kernel", reps=50, plain_reps=3)
        t["bound_ms"], t["bound_by"] = roofline(nbytes, substep_flops(model, dr=True) * B * env.nr_substeps)
        kernels[1]["by_shape"] = {**kernels[1].get("by_shape", {}),
                                  f"{robot} B={B} ({path} PPO-LSTM, {seeds} seeds x {nr_envs})": {
                                      **t, "max_abs_err": err, "max_abs_err_float64": kernel64,
                                      "plain_max_abs_err_float64": plain64}}
        kernels[1]["max_abs_err"] = max(kernels[1]["max_abs_err"], err)
        print(f"B2 engine_substep on the {robot} at B={B} ({seeds} seeds x {nr_envs}), {env.nr_substeps} substeps, "
              f"over the {int(kept.sum())} envs not just reset: max|err| {err:.3g} against engine.step_reference, "
              f"{kernel64:.3g} against it in float64, where the f32 plain version stands {plain64:.3g} from it (limit "
              f"twice that); kernel {t['ms']:.4f} ms (device {t['device_ms']:.4f} ms, host {t['host_us']:.1f} us a "
              f"call) plain {t['plain_ms']:.2f} ms bound {t['bound_ms']:.5f} ms ({t['bound_by']})")
        del env, single, state, ref, args, kw, out, ref_out
    return rates


def render_device_half(launches_by_path, workdir, nr_envs=64, nr_steps=50):
    """Phase 45: ``rollout_qpos`` of PPO (random flagship-width nets, f32) on
    the Ant at ``nr_envs`` envs on the card, B2 exactly ``nr_steps``
    launches, against the same parameters' rollout on the CPU; the frames
    of the card's poses where ``mujoco`` imports."""
    from rlx_tpu_torch.config import create_model, make_config
    from rlx_tpu_torch.render.offscreen import render_qpos, rollout_qpos

    overrides = {"environment.nr_envs": nr_envs, "algorithm.nr_steps": 8, "algorithm.minibatch_size": 64,
                 "algorithm.policy_hidden_sizes": (512, 256, 128), "algorithm.critic_hidden_sizes": (512, 256, 128),
                 "algorithm.activation": "elu", "algorithm.layer_norm": True}
    model = create_model(make_config("ppo.cuda", "locomotion.ant.cuda", **overrides, **{"runner.device": "cuda"}))
    cpu = create_model(make_config("ppo.cuda", "locomotion.ant.cuda", **overrides, **{"runner.device": "cpu"}))
    with torch.no_grad():
        # a head that moves the Ant (the orthogonal(0.01) head barely does)
        model.policy.module.mean.weight.mul_(30.0)
    cpu.policy.module.load_state_dict({k: v.cpu() for k, v in model.policy.module.state_dict().items()})
    zero_counts()
    t0 = time.perf_counter()
    poses = rollout_qpos(model, nr_steps)
    card_s = time.perf_counter() - t0
    launches = counts()
    expected = {"engine_substep": nr_steps, "gae": 0, "categorical_projection": 0}
    if launches != expected:
        fail(f"rollout_qpos on the card: launches {launches} != {expected}")
    launches_by_path["render_rollout_qpos"] = launches
    reference = rollout_qpos(cpu, nr_steps)
    err = float(abs(poses - reference).max())
    moved = float(abs(poses[-1, 7:] - poses[0, 7:]).max())
    if poses.shape != (nr_steps, 15) or not (err <= 1e-4) or moved < 1e-2:
        fail(f"rollout_qpos: shape {poses.shape}, max|err| {err:.3g} against the CPU (limit 1e-4), joints moved "
             f"{moved:.3g}")
    try:
        import mujoco  # noqa: F401
    except ImportError:
        half = "device half only: mujoco is not installed here, no frames rendered"
    else:
        frames = render_qpos(model.eval_env.xml_path, poses[:5], os.path.join(workdir, "frames"), 96, 72)
        half = f"both halves: {frames} frames rendered from the card's poses"
    print(f"render: rollout_qpos of PPO on the Ant at {nr_envs} envs x {nr_steps} steps on the card in "
          f"{card_s:.2f} s, B2 {launches['engine_substep']} launches; env 0's poses against the CPU rollout of the "
          f"same parameters max|err| {err:.3g} (limit 1e-4, f32), joints moved up to {moved:.3g} rad; {half}")


def mesh_phase(launches_by_path, workdir, world=2):
    """Phase 46: ``rlx_tpu_torch.benchmarks.mesh_phase`` in ``world`` gloo
    ranks on the one card, then in a one-rank NCCL group (subprocesses,
    each with a time limit)."""
    out = os.path.join(workdir, "mesh")
    os.makedirs(out, exist_ok=True)
    env = {**os.environ, "PYTHONPATH": os.path.dirname(os.path.abspath(__file__))}
    for key in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        env.pop(key, None)
    command = [sys.executable, "-m", "rlx_tpu_torch.benchmarks.mesh_phase", "--out", out]
    procs = [subprocess.Popen(command + ["--rank", str(r), "--world", str(world), "--init",
                                         os.path.join(out, "rendezvous")], env=env) for r in range(world)]
    try:
        codes = [p.wait(timeout=300) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if any(codes):
        fail(f"mesh ranks exited {codes}")
    ranks = [json.load(open(os.path.join(out, f"rank{r}.json"))) for r in range(world)]
    reference = ranks[0]["ppo_dp1"]
    for key, what in (("first_gradient_rel_err", "first gradients after the clip, relative to their largest"),
                      ("first_grad_norm_rel_err", "first gradient norms before the clip, relative"),
                      ("param_err_after_iteration", "parameters after the iteration")):
        if not reference[key] <= 1e-5:
            fail(f"mesh: dp = 2's {what} {reference[key]:.3g} from dp = 1's (limit 1e-5)")
    expected = {"ppo": {"engine_substep": 16, "gae": 1, "categorical_projection": 0},
                "sac": {"engine_substep": 5, "gae": 0, "categorical_projection": 0},
                "fasttd3": {"engine_substep": 5, "gae": 0, "categorical_projection": 4}}
    for r, rank in enumerate(ranks):
        for name, want in expected.items():
            if rank[name]["launches"] != want:
                fail(f"mesh rank {r} {name}: launches {rank[name]['launches']} != {want}")
            if rank[name]["replicated_err"] != 0.0:
                fail(f"mesh rank {r} {name}: parameters differ from rank 0's by {rank[name]['replicated_err']:.3g}")
            launches_by_path[f"{name}_dp2_rank{r}"] = rank[name]["launches"]
    ppo = ranks[0]["ppo"]
    print(f"mesh: 2 gloo ranks on one card: PPO on the Ant at 2 x {ppo['rank_envs']} envs x 16 steps, the first "
          f"update's gradients (PPO's own average and clip) {reference['first_gradient_rel_err']:.3g} from 1 x "
          f"{2 * ppo['rank_envs']} envs' relative to their largest ({reference['largest_gradient']:.3g}), their norms "
          f"before the clip {reference['first_grad_norm_rel_err']:.3g} relative, parameters "
          f"{reference['param_err_after_iteration']:.3g} apart after the iteration (each limit 1e-5); rank-step "
          f"{ppo['iteration_s'] * 1e3:.1f} ms ({ppo['env_steps_per_s']:.0f} env-steps/s for both ranks) against "
          f"{reference['iteration_s'] * 1e3:.1f} ms for one rank ({reference['env_steps_per_s']:.0f}; the two ranks "
          f"share one card: a difference is the host's two processes, not more card); the gradients' all_reduce "
          f"({ranks[0]['all_reduce_mib']:.2f} MiB, "
          f"gloo) {ranks[0]['all_reduce_ms']:.2f} ms; SAC and FastTD3 at 2 x {ranks[0]['sac']['rank_envs']} envs, "
          f"batch 2 x {ranks[0]['sac']['rank_batch']}, parameters equal on both ranks; launches per rank "
          + json.dumps({r: {n: ranks[r][n]["launches"] for n in expected} for r in range(world)}))

    nccl_out = os.path.join(out, "nccl")
    os.makedirs(nccl_out, exist_ok=True)
    proc = subprocess.run([sys.executable, "-m", "rlx_tpu_torch.benchmarks.mesh_phase", "--out", nccl_out,
                           "--nccl-one-rank", "--init", os.path.join(nccl_out, "rendezvous"), "--nr-envs", "1024"],
                          env=env, timeout=300)
    if proc.returncode:
        fail(f"one-rank NCCL group exited {proc.returncode}")
    nccl = json.load(open(os.path.join(nccl_out, "nccl.json")))
    if (not nccl["bit_for_bit"] or nccl["backend"] != "nccl" or not nccl["all_reduce_equal"]
            or not nccl["broadcast_equal"] or not nccl["collective_device"].startswith("cuda")):
        fail(f"one-rank NCCL group: {nccl}")
    launches_by_path["ppo_nccl_one_rank"] = nccl["launches"]
    print(f"mesh: a one-rank NCCL group: the PPO iteration's gradients ({nccl['collective_mib']:.2f} MiB on "
          f"{nccl['collective_device']}) through NCCL's all_reduce ({nccl['all_reduce_ms']:.3f} ms; the first, which "
          f"sets NCCL up, {nccl['first_all_reduce_ms']:.1f} ms) and broadcast "
          f"({nccl['broadcast_ms']:.3f} ms) back bit for bit; the iteration at 1024 envs x 16 steps ({nccl['mesh']}: "
          f"a mesh of one rank makes no collective) equal bit for bit to the run with no group; launches "
          f"{nccl['launches']}.  NCCL at dp > 1 needs a card a rank (torchrun), not run here")


class FakeBraxState:
    """The state of ``FakeBraxEnv``: a brax-style ``State``."""

    def __init__(self, obs, reward, done, metrics, info, t):
        self.obs, self.reward, self.done, self.metrics, self.info, self.t = obs, reward, done, metrics, info, t


class FakeBraxEnv:
    """A brax-training-style stub for ``PlaygroundAdapter`` (the port's
    counterpart of the JAX package's ``tests/test_playground_adapter.py``
    stub): vector dynamics, episodes of 5 steps ended by truncation,
    auto-reset on done, an obs dict with a privileged suffix, its tensors
    on ``device``."""

    action_size = 2
    observation_size = {"state": (4,), "privileged_state": (6,)}
    episode_length = 5

    def __init__(self, nr_envs, device):
        self.nr_envs, self.device = nr_envs, device

    def _obs(self, t):
        base = t[:, None].expand(-1, 4)
        privileged = torch.cat([base, torch.full((t.shape[0], 2), 9.0, device=self.device)], dim=1)
        return {"state": base, "privileged_state": privileged}

    def reset(self, generator):
        t = torch.zeros(self.nr_envs, device=self.device)
        return FakeBraxState(self._obs(t), t, t, {"speed": t}, {"truncation": t}, t)

    def step(self, state, action):
        t = state.t + 1
        done = t >= self.episode_length
        t = torch.where(done, 0.0, t)
        return FakeBraxState(self._obs(t), action.abs().sum(-1), done.float(), {"speed": t},
                             {"truncation": done.float()}, t)


def go2_ticks(seed=47):
    """The scripted remote and robot states of phase 47, ~400 ticks: Y
    (stand up, 60 ticks), B once then no button (nn, 150 ticks, the sticks
    moving), a joint-velocity spike over 25 (forced stand up, 60 ticks),
    nn again (B once, 60 ticks), X (lie down, 60 ticks), A (stop, 10)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    plan = ([("Y",)] * 60 + [("B",)] + [()] * 149 + [("spike",)] + [()] * 59 + [("B",)] + [()] * 59
            + [("X",)] * 60 + [("A",)] * 10)
    nominal = np.array([-0.1, 0.8, -1.5, 0.1, 0.8, -1.5, -0.1, 0.8, -1.5, 0.1, 0.8, -1.5])
    ticks = []
    for buttons in plan:
        quat = np.array([1.0, 0.0, 0.0, 0.0]) + 0.2 * rng.normal(size=4)
        velocities = np.clip(5.0 * rng.normal(size=12), -20.0, 20.0)
        if buttons == ("spike",):
            velocities[3], buttons = 30.0, ()
        ticks.append((buttons, {
            "joint_positions": nominal + 0.2 * rng.normal(size=12), "joint_velocities": velocities,
            "orientation_wxyz": quat / np.linalg.norm(quat), "angular_velocity": 30.0 * rng.normal(size=3),
            "sticks": dict(zip(("Lx", "Rx", "Ry", "Ly"), rng.uniform(-1.2, 1.2, size=4)))}))
    return ticks


def deployment_phase(kernels, launches_by_path, workdir):
    """Phase 47: a policy leaves the framework.  (a) The Go2: one PPO
    iteration at the ``locomotion_ppo`` recipe (4096 envs x 32 steps, the
    algorithm's default widths) on the ``go2`` on the plane (eager, as a
    ``train()`` call's first iteration; a one-iteration call captures
    nothing), B1 once and B2 once a control step (each launch runs the
    step's ``nr_substeps``); B2
    at the Go2's shape against its plain version, held against float64 as
    in phase 44 (``robot_substep_check``); the checkpoint loaded by
    ``load_policy_apply`` on the card and on the CPU, each driving
    ``Go2DeploymentRunner`` on ``FakeGo2SDK`` through ``go2_ticks``: the
    modes equal, the targets within 1e-5 in nn mode and equal in the ramps,
    the nn actions within 1e-5 of the training policy's mean on the env's
    policy-indexed observation; tick times.  (b) Soccer: one PPO-GRU
    iteration at ``soccer_lstm``'s widths (1024 envs x 32 steps, GRU 128)
    through B1 and B2, saved and converted by ``convert.py`` in a
    subprocess (its ``--device`` default); ``TorchPolicyGRU`` on the card
    for 32 steps with its carry on the env's policy-indexed observations,
    within 1e-5 of ``RecurrentPolicy.one_step`` on the card and of
    ``TorchPolicyGRU`` on the CPU; the meta JSON against the env.  (c) The
    playground: PPO on ``FakeBraxEnv`` under ``PlaygroundAdapter`` on the
    card, 2 iterations (B1 2, B2 and B3 none), the parameters finite; the
    registration's create raises ImportError naming mujoco_playground."""
    import numpy as np

    from rlx_tpu_torch.config import create_env, create_model, make_config
    from rlx_tpu_torch.environments import environment_manager as em
    from rlx_tpu_torch.environments.locomotion.robot.cuda.environment import LocomotionEnv
    from rlx_tpu_torch.environments.locomotion.robot.deployment.unitree_go2 import run as go2_run
    from rlx_tpu_torch.environments.locomotion.robot.deployment.unitree_go2.sdk import FakeGo2SDK
    from rlx_tpu_torch.environments.locomotion.soccer.deployment.torch_policy import TorchPolicyGRU
    from rlx_tpu_torch.environments.playground.adapter import GeneralProperties, PlaygroundAdapter
    from rlx_tpu_torch.utils.config_dict import ConfigDict

    dev = torch.device("cuda")
    out = os.path.join(workdir, "deployment")
    rows = {}

    def train(name, model, expected):
        zero_counts()
        t0 = time.perf_counter()
        model.train()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = counts()
        if launches != expected:
            fail(f"{name}: launches {launches} != {expected}")
        policy = getattr(model.policy, "module", model.policy)   # PPO's adapter, or the recurrent net
        for p in policy.parameters():
            if not torch.isfinite(p).all():
                fail(f"{name}: non-finite parameters after training")
        launches_by_path[name] = launches
        return seconds, launches

    # (a) the Go2: train, hold B2 at its shape, save, deploy on the card and the CPU
    go2 = {"environment.robot": "go2", "environment.terrain.type": "plane"}
    nr_steps = 32
    model = create_model(make_config("ppo.cuda", "locomotion.robot.cuda", **{
        **go2, "runner.device": "cuda", "environment.nr_envs": 4096, "algorithm.nr_steps": nr_steps,
        "algorithm.minibatch_size": 32768, "algorithm.nr_epochs": 4, "algorithm.learning_rate": 3e-4,
        "algorithm.total_timesteps": 4096 * nr_steps, "algorithm.evaluation_active": False,
        "algorithm.logging_active": False}), run_path=os.path.join(out, "go2"))
    env = model.train_env
    # one B2 launch runs a control step's nr_substeps (4 for the Go2: 50 Hz at 0.005 s)
    train_s, launches = train("go2_ppo", model, {"engine_substep": nr_steps, "gae": 1, "categorical_projection": 0})
    print(f"deployment go2: 1 PPO iteration at 4096x{nr_steps} on the plane ({env.nr_substeps} substeps a control "
          f"step) in {train_s:.2f} s, launches {launches}")
    b2, b2_err = robot_substep_check(kernels, "go2", LocomotionEnv, "locomotion.robot.cuda", go2,
                                     torch.Generator(device=dev).manual_seed(47), against_float64=True)
    model.save()
    model_path = os.path.join(out, "go2", "models", "latest.model")

    ticks = go2_ticks()

    def deploy(device):
        fake = FakeGo2SDK()
        runner = go2_run.Go2DeploymentRunner(fake, model_path=model_path, device=device)
        runner.policy_apply(np.zeros(go2_run.OBSERVATION_SIZE))   # warm-up, outside the timed ticks
        calls, modes, tick_ms = [], [], []
        apply = runner.policy_apply

        def recorded(observation):
            action = apply(observation)
            calls.append((observation, action))
            return action

        runner.policy_apply = recorded
        for buttons, fields in ticks:
            for name in ("joint_positions", "joint_velocities", "orientation_wxyz", "angular_velocity"):
                setattr(fake.state, name, fields[name].copy())
            fake.state.wireless_remote = go2_run.RemoteControllerState.pack(buttons=buttons, **fields["sticks"])
            t0 = time.perf_counter()
            runner.tick()
            tick_ms.append((time.perf_counter() - t0) * 1e3)
            modes.append(runner.control_mode)
        return fake.published, modes, calls, tick_ms

    zero_counts()
    published, modes, calls, card_ms = deploy("cuda")
    cpu_published, cpu_modes, _, cpu_ms = deploy("cpu")
    if any(counts().values()):
        fail(f"deployment launched a kernel: {counts()}")
    if modes != cpu_modes or len(published) != len(cpu_published):
        fail("go2 deployment: the card's modes or commands differ from the CPU's")
    nn_err, nn_ticks = 0.0, []
    for i, ((targets, kp, kd), (cpu_targets, cpu_kp, cpu_kd)) in enumerate(zip(published, cpu_published)):
        if (kp, kd) != (cpu_kp, cpu_kd):
            fail(f"go2 deployment: command {i} gains {(kp, kd)} on the card, {(cpu_kp, cpu_kd)} on the CPU")
        if kp == 20.0:
            nn_err = max(nn_err, float(np.abs(targets - cpu_targets).max()))
        elif not np.array_equal(targets, cpu_targets):
            fail(f"go2 deployment: ramp command {i} differs between the card and the CPU")
    nn_mode = [i for i, m in enumerate(modes) if m == "nn"]
    if len(calls) != len(nn_mode) or len(calls) < 200 or nn_err > 1e-5:
        fail(f"go2 deployment: {len(calls)} policy calls for {len(nn_mode)} nn ticks, targets {nn_err:.3g} from "
             f"the CPU's (limit 1e-5)")
    observations = torch.as_tensor(np.stack([o for o, _ in calls]), dtype=torch.float32, device=dev)
    full = torch.zeros(len(calls), env.single_observation_space.shape[0], device=dev)
    full[:, torch.as_tensor(env.policy_observation_indices, device=dev)] = observations
    with torch.no_grad():
        mean = model.policy.module(full)[0]
    action_err = float((mean.cpu().double() - torch.as_tensor(np.stack([a for _, a in calls]))).abs().max())
    if not action_err <= 1e-5:
        fail(f"go2 deployment: nn actions {action_err:.3g} from the training policy's mean (limit 1e-5)")
    tick = lambda ms: {"median_ms": float(np.median([ms[i] for i in nn_mode])),
                       "p99_ms": float(np.percentile([ms[i] for i in nn_mode], 99))}
    rows["go2"] = {"train_s": train_s, "launches": launches, "b2_max_abs_err": b2_err, "b2_ms": b2["ms"],
                   "b2_device_ms": b2["device_ms"], "b2_host_us": b2["host_us"], "b2_bound_ms": b2["bound_ms"],
                   "ticks": len(ticks), "nn_ticks": len(nn_mode), "targets_err_card_cpu": nn_err,
                   "action_err_training_policy": action_err, "tick_card": tick(card_ms), "tick_cpu": tick(cpu_ms)}
    print(f"deployment go2: {len(ticks)} ticks of Go2DeploymentRunner on FakeGo2SDK (Y, B, a joint-velocity spike, "
          f"B, X, A), modes {sorted(set(m for m in modes if m))}, {len(published)} commands; nn targets on the card "
          f"{nn_err:.3g} from the CPU's (limit 1e-5), ramps equal; {len(calls)} nn actions {action_err:.3g} from the "
          f"training policy's mean on the env's policy-indexed observation (limit 1e-5); an nn tick on the card "
          f"median {rows['go2']['tick_card']['median_ms']:.3f} ms p99 {rows['go2']['tick_card']['p99_ms']:.3f} ms, on "
          f"the CPU median {rows['go2']['tick_cpu']['median_ms']:.3f} ms p99 {rows['go2']['tick_cpu']['p99_ms']:.3f} "
          f"ms (budget 20 ms at 50 Hz)")
    del model, env

    # (b) soccer: train PPO-GRU, save, convert in a subprocess, run TorchPolicyGRU
    soccer = create_model(make_config("ppo_gru.cuda", "locomotion.soccer.cuda", **{
        "runner.device": "cuda", "environment.nr_envs": 1024, "algorithm.nr_steps": nr_steps,
        "algorithm.nr_minibatches": 4, "algorithm.nr_epochs": 4, "algorithm.rnn_hidden_dim": 128,
        "algorithm.learning_rate": 3e-4, "algorithm.total_timesteps": 1024 * nr_steps,
        "algorithm.evaluation_active": False, "algorithm.logging_active": False}), run_path=os.path.join(out, "soccer"))
    train_s, launches = train("soccer_gru", soccer, {"engine_substep": nr_steps, "gae": 1, "categorical_projection": 0})
    soccer.save()
    pth, meta_path = os.path.join(out, "locomotion_nn.pth"), os.path.join(out, "locomotion_nn_meta.json")
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "rlx_tpu_torch.environments.locomotion.soccer.deployment.convert",
                           "--model", os.path.join(out, "soccer", "models", "latest.model"), "--output", pth,
                           "--meta-output", meta_path],
                          env={**os.environ, "PYTHONPATH": os.path.dirname(os.path.abspath(__file__))},
                          capture_output=True, text=True, timeout=300)
    convert_s = time.perf_counter() - t0
    if proc.returncode:
        fail(f"convert.py exited {proc.returncode}: {proc.stderr[-2000:]}")
    meta = json.load(open(meta_path))
    env = soccer.train_env
    expected_meta = {"policy_observation_indices": np.asarray(env.policy_observation_indices).tolist(),
                     "action_scaling_factor": float(env.robot_config["scaling_factor"]),
                     "nominal_joint_positions": env.nominal_joint_positions.cpu().tolist(),
                     "control_frequency_hz": env.control_frequency_hz, "hidden_dim": 128}
    if any(meta[k] != v for k, v in expected_meta.items()):
        fail(f"convert.py's meta {({k: meta[k] for k in expected_meta})} != the env's {expected_meta}")
    arch = {k: meta[k] for k in ("obs_dim", "action_dim", "obs_encoding_dim", "hidden_dim", "combine_method",
                                 "share_encoder")}
    deployed, cpu_deployed = TorchPolicyGRU(**arch).to(dev), TorchPolicyGRU(**arch)
    deployed.load_state_dict(torch.load(pth, map_location=dev, weights_only=True))
    cpu_deployed.load_state_dict(torch.load(pth, weights_only=True))
    index = torch.as_tensor(meta["policy_observation_indices"], device=dev)
    state = env.reset(47)
    carry, ref_carry, cpu_carry = (deployed.initial_carry(1024), soccer.policy.initialize_carry(1024),
                                   cpu_deployed.initial_carry(1024))
    policy_err = cpu_err = 0.0
    with torch.no_grad():
        for _ in range(nr_steps):
            got, carry = deployed(state.observation[:, index], carry)
            mean, _, ref_carry = soccer.policy.one_step(state.observation, ref_carry)
            cpu_got, cpu_carry = cpu_deployed(state.observation[:, index].cpu(), cpu_carry)
            policy_err = max(policy_err, (got - mean).abs().max().item())
            cpu_err = max(cpu_err, (got.cpu() - cpu_got).abs().max().item())
            state = env.step(state, got)
    torch.cuda.synchronize()
    if not (torch.isfinite(got).all() and policy_err <= 1e-5 and cpu_err <= 1e-5):
        fail(f"TorchPolicyGRU on the card: {policy_err:.3g} from RecurrentPolicy.one_step, {cpu_err:.3g} from the "
             f"CPU's (limit 1e-5)")
    rows["soccer"] = {"train_s": train_s, "launches": launches, "convert_s": convert_s,
                      "policy_err": policy_err, "cpu_err": cpu_err, "arch": arch}
    print(f"deployment soccer: 1 PPO-GRU iteration at 1024x{nr_steps} in {train_s:.2f} s, launches {launches}; "
          f"convert.py (a subprocess on the card) {convert_s:.1f} s, arch {json.dumps(arch)}, meta against the env "
          f"equal; TorchPolicyGRU on the card over {nr_steps} steps with its carry {policy_err:.3g} from "
          f"RecurrentPolicy.one_step on the card and {cpu_err:.3g} from TorchPolicyGRU on the CPU (limit 1e-5)")
    del soccer, env, state

    # (c) the playground: PPO over the stub on the card; the registration raises
    def create(config):
        adapter = PlaygroundAdapter(FakeBraxEnv(3, config.runner.device), nr_envs=3, horizon=5,
                                    device=config.runner.device)
        return adapter, adapter

    em.register_environment("smoke.fake_playground.cuda", lambda n: ConfigDict(name=n, seed=1, nr_envs=3), create,
                            GeneralProperties)
    playground = create_model(make_config("ppo.cuda", "smoke.fake_playground.cuda", **{
        "runner.device": "cuda", "algorithm.total_timesteps": 2 * 3 * 5, "algorithm.nr_steps": 5,
        "algorithm.minibatch_size": 5, "algorithm.nr_epochs": 1, "environment.nr_envs": 3}))
    train_s, launches = train("playground_stub_ppo", playground,
                              {"engine_substep": 0, "gae": 2, "categorical_projection": 0})
    try:
        create_env(make_config("ppo.cuda", "playground.g1_joystick_flat_terrain.cuda", **{"runner.device": "cuda"}))
    except ImportError as e:
        if "mujoco_playground" not in str(e):
            fail(f"playground registration: ImportError without mujoco_playground: {e}")
    else:
        fail("playground registration: creating the env did not raise")
    rows["playground"] = {"train_s": train_s, "launches": launches}
    print(f"deployment playground: PPO over the stub under PlaygroundAdapter on the card, 2 iterations in "
          f"{train_s:.2f} s, launches {launches}, parameters finite; playground.g1_joystick_flat_terrain.cuda "
          f"raises ImportError naming mujoco_playground")
    return rows


def iteration_tensors(model, state, metrics=None):
    """name -> tensor of what a learning iteration changes: the nets'
    parameters, Adam's moments and step counts, the device step count, the
    env state and (given) the metrics."""
    import torch.utils._pytree as pytree

    from rlx_tpu_torch.environments.env import EnvState

    out = {}
    for net, module, optimizer in (("policy", model.policy.module, model.policy_optimizer),
                                   ("critic", model.critic, model.critic_optimizer)):
        for name, p in module.named_parameters():
            out[f"{net}.{name}"] = p
            for key, value in optimizer.state[p].items():
                out[f"{net}.{name}.{key}"] = value
    out["optimizer_steps"] = model.optimizer_steps
    for i, t in enumerate(pytree.tree_leaves([getattr(state, f) for f in EnvState.TENSOR_FIELDS])):
        out[f"env.{i}"] = t
    for key, value in (metrics or {}).items():
        out[f"metric.{key}"] = value
    return out


def differences(a, b):
    """(tensors equal bit for bit, of how many, the largest |a - b| and where)."""
    equal, worst, where = 0, 0.0, None
    for k in a:
        if torch.equal(a[k], b[k]):
            equal += 1
            continue
        d = (a[k].double() - b[k].double()).abs().max().item()
        if not d <= worst:
            worst, where = d, k
    return equal, len(a), worst, where


class DebugGraph(torch.cuda.CUDAGraph):
    """A ``torch.cuda.CUDAGraph`` that keeps its ``cudaGraph_t`` for
    ``debug_dump`` (phase 48 swaps it in for the flagship's capture)."""

    def __init__(self, *args, **kwargs):
        super().__init__(keep_graph=True)
        self.enable_debug_mode()


def graph_nodes(graph, path, names):
    """(kernel nodes of each of ``names``, all kernel nodes) of a captured
    ``DebugGraph``, read from the kernel names of its DOT dump."""
    graph.debug_dump(path)
    with open(path) as f:
        dot = f.read()
    os.remove(path)
    return {k: dot.count(n) for k, n in names.items()}, dot.count('label="{KERNEL')


def capture_phase(launches_by_path, workdir):
    """Phase 48: the learning iteration captured as one CUDA graph
    (``training_program.CapturedIteration``) against the eager iteration, on
    the flagship PPO and the PPO family at their earlier phases' shapes."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from rlx_tpu_torch.algorithms.training_program import CapturedIteration, capture_choice
    from rlx_tpu_torch.benchmarks.curves import RUNS
    from rlx_tpu_torch.config import create_model, make_config

    nr_steps, batch = 64, 4096 * 64
    flagship = {"runner.device": "cuda", "environment.nr_envs": 4096, "algorithm.nr_steps": nr_steps,
                "algorithm.total_timesteps": 4 * batch, "algorithm.policy_hidden_sizes": (512, 256, 128),
                "algorithm.critic_hidden_sizes": (512, 256, 128), "algorithm.activation": "elu",
                "algorithm.layer_norm": True, "algorithm.evaluation_active": False}
    update = {"algorithm.minibatch_size": batch // 8, "algorithm.nr_epochs": 4}
    cases = {   # name: (algorithm, environment, overrides, bf16 trunk set on the nets)
        "ppo": ("ppo.cuda", "locomotion.ant.cuda",
                {**flagship, **update, "algorithm.compute_dtype": "bfloat16"}, False),
        "ppo_cartpole": ("ppo.cuda", "classic.cart_pole.cuda",
                         {"runner.device": "cuda", "environment.nr_envs": 4096, "algorithm.nr_steps": nr_steps,
                          "algorithm.total_timesteps": 4 * batch, "algorithm.evaluation_active": False, **update},
                         False),
        # the stop set to fire within the iteration: epoch 0's ratio is 1,
        # epoch 1's moves past 1e-4
        "espo": ("espo.cuda", "locomotion.ant.cuda", {**flagship, "algorithm.max_ratio_delta": 1e-4}, True),
        "ppo_dtrl": ("ppo_dtrl.cuda", "locomotion.ant.cuda", {**flagship, **update}, True),
        "ppo_history_window": ("ppo_history_window.cuda", "classic.pendulum.cuda",
                               {"runner.device": "cuda", **RUNS["pendulum_masked_history_window"]["overrides"],
                                "algorithm.total_timesteps": 8 * 256 * 4, "algorithm.evaluation_active": False},
                               False),
    }
    rows = {}
    for name, (algorithm, environment, overrides, bf16) in cases.items():
        model = create_model(make_config(algorithm, environment, **overrides))
        if bf16:
            model.policy.module.trunk.compute_dtype = model.critic.trunk.compute_dtype = torch.bfloat16
        capture, reason = capture_choice(model)
        if not capture:
            fail(f"phase 48 {name}: capture_choice says eager ({reason})")
        graph = CapturedIteration(model)
        state, _ = graph(model.train_env.reset(model.seed))     # the warm-up, eager
        if name == "ppo":
            torch.cuda.CUDAGraph = DebugGraph   # its kernel nodes are read back below
        torch.cuda.synchronize()
        live = iteration_tensors(model, state)
        # detached: a clone of a parameter would keep its gradient
        # accumulator, made on this stream, alive into the capture
        saved = {k: v.detach().clone() for k, v in live.items()}
        generators = (model.generator, state.generator)
        generator_states = [gen.get_state() for gen in generators]

        @torch.no_grad()
        def restore(noise=True):
            for k, v in saved.items():
                if not k.startswith("env."):
                    live[k].copy_(v)
            if noise:
                for gen, s in zip(generators, generator_states):
                    gen.set_state(s)

        eager_state, eager_metrics = model.learning_iteration(state)
        eager = {k: v.detach().clone() for k, v in iteration_tensors(model, eager_state, eager_metrics).items()}
        restore()
        torch.cuda.synchronize()
        try:
            graph_state, graph_metrics = graph(state)           # capture, then the first replay
        finally:
            torch.cuda.CUDAGraph = DebugGraph.__base__
        torch.cuda.synchronize()
        replayed = {k: v.detach().clone() for k, v in iteration_tensors(model, graph_state, graph_metrics).items()}
        equal, total, worst, where = differences(eager, replayed)
        if equal != total:
            fail(f"phase 48 {name}: the replay differs from the eager iteration in {total - equal} of {total} "
                 f"tensors, max |diff| {worst:.3g} at {where}")
        # the same nets and env state again, the generators as the replay
        # left them: fresh noise gives another rollout
        offsets = [gen.get_offset() for gen in generators]
        restore(noise=False)
        graph.state.copy_(state)
        graph.replay()
        torch.cuda.synchronize()
        again = iteration_tensors(model, graph.state)
        fresh = sum(not torch.equal(again[k], replayed[k]) for k in again if k.startswith("env."))
        advanced = [gen.get_offset() > offset for gen, offset in zip(generators, offsets)]
        if fresh == 0 or not advanced[0]:
            fail(f"phase 48 {name}: a second replay from the same state drew the same noise "
                 f"({fresh} env tensors changed, generators advanced {advanced})")
        row = {"equal_tensors": f"{equal} of {total}", "generators_advanced": advanced,
               "capture_s": graph.capture_seconds,
               "pool_mib": graph.pool_bytes / 2**20, "env_tensors_changed_by_fresh_noise": fresh,
               "launches_per_replay": dict(zip(("engine_substep", "gae", "categorical_projection"),
                                               graph.launches))}
        if name == "espo":
            active = float(replayed["metric.policy_ratio/nr_active_epochs"])
            if not 1.0 <= active < model.nr_epochs:
                fail(f"phase 48 espo: {active} active epochs, the stop did not fire within the iteration")
            row["active_epochs"] = active
        if name == "ppo":
            # launch counts of one replay: the graph's kernel nodes by name
            # (exact), and the profiler's kernel events by name over one
            # replay.  The tracer drops a record of the ~33k a replay makes
            # now and then, late in this script three windows running at
            # one B2 record: so up to three windows, each led by one more
            # small kernel than the last (the records shift), until one
            # sees every launch
            names = {"engine_substep": "engine_substep_kernel", "gae": "gae_kernel"}
            expected = {"engine_substep": nr_steps, "gae": 1}
            counted = dict(zip(("engine_substep", "gae"), graph.launches))
            nodes, kernel_nodes = graph_nodes(graph.graph, os.path.join(workdir, "graph.dot"), names)
            if nodes != expected or counted != expected:
                fail(f"phase 48: the graph holds {nodes} kernel nodes, the counters add {counted} a replay, "
                     f"expected {expected}")
            windows = []
            lead = torch.zeros(1, device="cuda")
            for window in range(3):
                before = counts()
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    for _ in range(window):
                        lead.add_(1.0)
                    graph.replay()
                    torch.cuda.synchronize()
                after = counts()
                if {k: after[k] - before[k] for k in expected} != expected:
                    fail(f"phase 48: the counters added {after} - {before} for one replay, expected {expected}")
                kernels = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA
                           and not e.name.startswith(("Memset", "Memcpy"))]
                seen = {k: sum(n in e for e in kernels) for k, n in names.items()}
                windows.append({"seen": seen, "kernel_events": len(kernels)})
                if seen == expected:
                    break
            else:
                fail(f"phase 48: the profiler saw {windows} in three windows of one replay, the graph and the "
                     f"counters {expected} ({kernel_nodes} kernel nodes)")
            launches_by_path["ppo_captured_replay"] = dict(counted, categorical_projection=0)
            row["graph_kernel_nodes"] = dict(nodes, all=kernel_nodes)
            row["profiled_replay_windows"] = windows
            # env-steps/s of 5 iterations each way, each read as train() reads it
            def iterations(step, state):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(5):
                    state, metrics = step(state)
                    {k: float(v) for k, v in metrics.items()}
                torch.cuda.synchronize()
                return 5 * batch / (time.perf_counter() - t0), state

            row["eager_env_steps_per_s"], state = iterations(model.learning_iteration, graph.state)
            graph.state.copy_(state)
            row["replay_env_steps_per_s"], _ = iterations(graph, graph.state)
            row["replay_speedup"] = row["replay_env_steps_per_s"] / row["eager_env_steps_per_s"]
            row["replay_profile"] = device_idle(graph.replay, "ppo/")
            row["eager_profile"] = device_idle(
                lambda: model.learning_iteration(graph.state), "ppo/")
        graph.close()
        rows[name] = row
        print(f"captured {name}: " + json.dumps(row))
        del model, graph
        torch.cuda.empty_cache()
    return rows


def held_tensors(model, state, carry=(), metrics=None):
    """name -> tensor of everything a learning iteration of any family
    reads or changes: what the model holds (``training_program.model_tensors``:
    the nets, the optimizers' state, the device step count, REPPO's
    normalizer and old-policy snapshot), the env state, the carry and
    (given) the metrics."""
    import torch.utils._pytree as pytree

    from rlx_tpu_torch.algorithms.training_program import model_tensors
    from rlx_tpu_torch.environments.env import EnvState

    out = model_tensors(model)
    for i, t in enumerate(pytree.tree_leaves([getattr(state, f) for f in EnvState.TENSOR_FIELDS])):
        out[f"env.{i}"] = t
    for i, t in enumerate(pytree.tree_leaves(tuple(carry))):
        out[f"carry.{i}"] = t
    for key, value in (metrics or {}).items():
        out[f"metric.{key}"] = value
    return out


def graph_node_count(graph):
    """All nodes of a captured ``DebugGraph``, as the CUDA runtime counts them
    (``cuGraphGetNodes`` on its ``cudaGraph_t``); None where this torch
    does not hand the graph out."""
    import ctypes

    if not hasattr(graph, "raw_cuda_graph"):
        return None
    n = ctypes.c_size_t(0)
    rc = ctypes.CDLL("libcuda.so.1").cuGraphGetNodes(ctypes.c_void_p(graph.raw_cuda_graph()), None,
                                                     ctypes.byref(n))
    if rc != 0:
        fail(f"cuGraphGetNodes returned {rc}")
    return n.value


def replay_against_eager(phase, name, model, carry, expected, workdir, node_names=False):
    """The checks of one captured learning iteration (phases 49-51):
    ``capture_choice`` says capture; after an eager warm-up on the capture
    stream, an eager iteration and the first replay of the captured one from
    the same state are equal bit for bit in every tensor (``held_tensors``:
    the nets, their targets, the optimizers' state, the device step counts,
    the normalizers, REPPO's old-policy snapshot, the off-policy replay
    buffer's storage, head and fill and metric sums, the env state, the
    carry, every metric) and in both generators' states; a second replay
    from the same state draws fresh noise; one replay launches ``expected``
    (B2, B1) or (B2, B1, B3), B3 none unless given.  The graph is a
    ``DebugGraph``: its nodes are counted, and with ``node_names`` its
    kernel nodes of the three by name, which must be ``expected``.  -> (the
    ``CapturedIteration``, its row)."""
    from rlx_tpu_torch.algorithms.training_program import CapturedIteration, capture_choice, copy_carry_

    capture, reason = capture_choice(model)
    if not capture:
        fail(f"phase {phase} {name}: capture_choice says eager ({reason})")
    graph = CapturedIteration(model)
    state, *carry, _ = graph(model.train_env.reset(model.seed), *carry)   # the warm-up, eager
    torch.cuda.synchronize()
    live = held_tensors(model, state, carry)
    # detached: a clone of a parameter would keep its gradient
    # accumulator, made on this stream, alive into the capture
    saved = {k: v.detach().clone() for k, v in live.items()}
    generators = (model.generator, state.generator)
    generator_states = [gen.get_state() for gen in generators]

    @torch.no_grad()
    def restore(noise=True):
        for k, v in saved.items():
            if not k.startswith(("env.", "carry.")):
                live[k].copy_(v)
        if noise:
            for gen, s in zip(generators, generator_states):
                gen.set_state(s)

    def snapshot(state, carry, metrics):
        out = {k: v.detach().clone() for k, v in held_tensors(model, state, carry, metrics).items()}
        out.update({f"generator.{i}": gen.get_state() for i, gen in enumerate(generators)})
        return out

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eager_state, *eager_carry, eager_metrics = model.learning_iteration(state, *carry)
    torch.cuda.synchronize()
    eager_s = time.perf_counter() - t0
    eager = snapshot(eager_state, eager_carry, eager_metrics)
    del eager_state, eager_carry, eager_metrics
    restore()
    torch.cuda.synchronize()
    before = counts()
    torch.cuda.CUDAGraph = DebugGraph   # its nodes are read back below
    try:
        graph_state, *graph_carry, graph_metrics = graph(state, *carry)   # capture, then the first replay
    finally:
        torch.cuda.CUDAGraph = DebugGraph.__base__
    torch.cuda.synchronize()
    after = counts()
    replayed = snapshot(graph_state, graph_carry, graph_metrics)
    equal, total, worst, where = differences(eager, replayed)
    if equal != total:
        fail(f"phase {phase} {name}: the replay differs from the eager iteration in {total - equal} of {total} "
             f"tensors, max |diff| {worst:.3g} at {where}")
    kernels = ("engine_substep", "gae", "categorical_projection")
    counted = {k: after[k] - before[k] for k in kernels}
    expected = dict(zip(kernels, (*expected, 0)[:3]))
    recorded = dict(zip(kernels, graph.launches))
    if counted != expected or recorded != expected:
        fail(f"phase {phase} {name}: a replay launched {counted} (the capture recorded {graph.launches}), "
             f"expected {expected}")
    # the same nets, env state and carry again, the generators as the
    # replay left them: fresh noise gives another rollout
    offsets = [gen.get_offset() for gen in generators]
    restore(noise=False)
    graph.state.copy_(state)
    copy_carry_(graph.carry, tuple(carry))
    graph.replay()
    torch.cuda.synchronize()
    again = held_tensors(model, graph.state)
    fresh = sum(not torch.equal(again[k], replayed[k]) for k in again if k.startswith("env."))
    advanced = [gen.get_offset() > offset for gen, offset in zip(generators, offsets)]
    if fresh == 0 or not advanced[0]:
        fail(f"phase {phase} {name}: a second replay from the same state drew the same noise "
             f"({fresh} env tensors changed, generators advanced {advanced})")
    row = {"equal_tensors": f"{equal} of {total}", "generators_advanced": advanced,
           "capture_s": graph.capture_seconds, "pool_mib": graph.pool_bytes / 2**20,
           "graph_nodes": graph_node_count(graph.graph), "env_tensors_changed_by_fresh_noise": fresh,
           "launches_per_replay": counted, "eager_reference_s": eager_s}
    if node_names:
        names = {"engine_substep": "engine_substep_kernel", "gae": "gae_kernel",
                 "categorical_projection": "projection_kernel"}
        nodes, kernel_nodes = graph_nodes(graph.graph, os.path.join(workdir, "graph.dot"), names)
        if nodes != expected:
            fail(f"phase {phase} {name}: the graph holds {nodes} kernel nodes, expected {expected}")
        row["graph_kernel_nodes"] = dict(nodes, all=kernel_nodes)
    return graph, row


def timed_iterations(model, graph, row, eager_n, replay_n, prefix=None):
    """Into ``row``: env-steps/s of ``eager_n`` eager (none: ``row`` has the
    eager rate already) and ``replay_n`` replayed learning iterations from
    the graph's static state (each read as ``train()`` reads it: its
    metrics as floats), their ratio, and with a ``prefix`` the idle share
    of one replay and of one eager iteration from the device's events
    (``device_idle``)."""
    from rlx_tpu_torch.algorithms.training_program import copy_carry_

    batch = model.nr_envs * model.nr_steps

    def iterations(step, n, state, carry):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            state, *carry, metrics = step(state, *carry)
            {k: float(v) for k, v in metrics.items()}
        torch.cuda.synchronize()
        return n * batch / (time.perf_counter() - t0), state, carry

    if eager_n:
        row["eager_env_steps_per_s"], state, carry = iterations(model.learning_iteration, eager_n, graph.state,
                                                                graph.carry)
        graph.state.copy_(state)
        copy_carry_(graph.carry, tuple(carry))
    row["replay_env_steps_per_s"], _, _ = iterations(graph, replay_n, graph.state, graph.carry)
    row["replay_speedup"] = row["replay_env_steps_per_s"] / row["eager_env_steps_per_s"]
    if prefix is not None:
        row["replay_profile"] = device_idle(graph.replay, prefix)
        row["eager_profile"] = device_idle(lambda: model.learning_iteration(graph.state, *graph.carry), prefix)


def capture_families_phase(launches_by_path, workdir):
    """Phase 49: the captured learning iteration of the recurrent PPOs,
    REPPO and PQN against the eager iteration, at phases 27, 26 and 17's
    shapes."""
    from rlx_tpu_torch.benchmarks.curves import RUNS
    from rlx_tpu_torch.config import create_model, make_config

    rec_steps = 32
    recurrent = {"runner.device": "cuda", "environment.nr_envs": 4096, "algorithm.nr_steps": rec_steps,
                 "algorithm.nr_minibatches": 4, "algorithm.nr_epochs": 4, "environment.horizon": 20,
                 "algorithm.total_timesteps": 4 * 4096 * rec_steps, "algorithm.evaluation_active": False}
    width = {"algorithm.rnn_hidden_dim": 128}
    cases = {   # name: (algorithm, environment, overrides, launches a replay (B2, B1), timed)
        "ppo_lstm": ("ppo_lstm.cuda", "locomotion.ant.cuda", {**recurrent, **width}, (rec_steps, 1), True),
        "ppo_gru": ("ppo_gru.cuda", "locomotion.ant.cuda", {**recurrent, **width}, (rec_steps, 1), False),
        "ppo_mamba2": ("ppo_mamba2.cuda", "locomotion.ant.cuda", recurrent, (rec_steps, 1), False),
        "ppo_transformer": ("ppo_transformer.cuda", "locomotion.ant.cuda", recurrent, (rec_steps, 1), True),
        "reppo": ("reppo.cuda", "locomotion.ant.cuda",
                  {"runner.device": "cuda", "environment.nr_envs": 4096, "algorithm.total_timesteps": 4 * 4096 * 128,
                   "algorithm.evaluation_active": False}, (128, 0), True),
        "pqn": ("pqn.cuda", "classic.cart_pole.cuda",
                {"runner.device": "cuda", **RUNS["cartpole_spot_pqn"]["overrides"],
                 "algorithm.total_timesteps": RUNS["cartpole_spot_pqn"]["budget"],
                 "algorithm.evaluation_active": False}, (0, 0), False),
    }
    rows = {}
    for name, (algorithm, environment, overrides, expected, timed) in cases.items():
        model = create_model(make_config(algorithm, environment, **overrides))
        # the carry a train() call starts from: the recurrent policy's zero
        # carry, PQN's update step 0, nothing for REPPO
        carry = ()
        if hasattr(model, "policy_carry"):
            carry = (model.policy.initialize_carry(model.nr_envs),)
        elif name == "pqn":
            carry = (torch.zeros((), dtype=torch.int64, device="cuda"),)
        graph, row = replay_against_eager(49, name, model, carry, expected, workdir, node_names=name == "ppo_lstm")
        launches_by_path[f"{name}_captured_replay"] = row["launches_per_replay"]
        if timed:
            timed_iterations(model, graph, row, 3, 3, "reppo/" if name == "reppo" else "recurrent_ppo/")
        graph.close()
        rows[name] = row
        print(f"captured {name}: " + json.dumps(row))
        del model, graph, carry
        torch.cuda.empty_cache()
    return rows


def capture_robot_phase(launches_by_path, workdir):
    """Phase 50: the captured learning iteration on the robot and soccer
    envs against the eager iteration: PPO-LSTM on the robot's plane and on
    soccer at phases 28 and 31's shape (B2 and B1 inside the graph),
    feedforward PPO on the heightfield at phase 30's and PPO-LSTM on the
    heightfield at 4096 envs with its 32 steps cut to 8 (the eager engine
    inside the graph, no B2).  Each path's eager rate is its reference
    iteration's; the idle shares come from the device's events, except for
    feedforward PPO on the heightfield (the wall clock only).  Then
    ``locomotion_lstm`` at its own 32 steps through ``train()``
    (``heightfield_recipes``).  -> the rows."""
    from rlx_tpu_torch.config import create_model, make_config
    from rlx_tpu_torch.physics import engine

    lstm = {"runner.device": "cuda", "environment.nr_envs": 4096, "algorithm.nr_steps": 32,
            "algorithm.nr_minibatches": 4, "algorithm.nr_epochs": 4, "algorithm.rnn_hidden_dim": 128,
            "algorithm.learning_rate": 3e-4, "algorithm.evaluation_active": False}
    heightfield_steps = 8   # the locomotion_lstm shape's 32 cut to 8: an eager iteration at 32 takes ~17 s
    ppo_steps = 8           # phase 30's cut of locomotion_ppo's 32
    plane = {"environment.terrain.type": "plane"}
    cases = {   # name: (algorithm, environment, overrides, launches a replay (B2, B1), idle shares)
        "robot_lstm_plane": ("ppo_lstm.cuda", "locomotion.robot.cuda", {**lstm, **plane}, (32, 1), True),
        "soccer_lstm": ("ppo_lstm.cuda", "locomotion.soccer.cuda", lstm, (32, 1), True),
        "robot_ppo_heightfield": ("ppo.cuda", "locomotion.robot.cuda",
                                  {"runner.device": "cuda", "environment.nr_envs": 4096,
                                   "algorithm.nr_steps": ppo_steps, "algorithm.minibatch_size": 32768,
                                   "algorithm.nr_epochs": 4, "algorithm.learning_rate": 3e-4,
                                   "algorithm.evaluation_active": False}, (0, 1), False),
        # at 8 steps its ~1.7 x 10^5 device events trace in a few seconds
        "robot_lstm_heightfield": ("ppo_lstm.cuda", "locomotion.robot.cuda",
                                   {**lstm, "algorithm.nr_steps": heightfield_steps}, (0, 1), True),
    }
    rows = {}
    for name, (algorithm, environment, overrides, expected, idle) in cases.items():
        t0 = time.perf_counter()
        model = create_model(make_config(algorithm, environment, **overrides,
                                         **{"algorithm.total_timesteps": 4 * 4096 * overrides["algorithm.nr_steps"]}))
        carry = (model.policy.initialize_carry(model.nr_envs),) if hasattr(model, "policy_carry") else ()
        graph, row = replay_against_eager(50, name, model, carry, expected, workdir)
        launches_by_path[f"{name}_captured_replay"] = row["launches_per_replay"]
        row["eager_env_steps_per_s"] = model.nr_envs * model.nr_steps / row["eager_reference_s"]
        timed_iterations(model, graph, row, 0, 3, ("recurrent_ppo/" if carry else "ppo/") if idle else None)
        if name == "robot_lstm_heightfield":
            # the eager physics alone a control step, from the static state
            env, physics = model.train_env, graph.state.physics
            internal = physics["internal"]
            targets = env.control_function.process_action(
                torch.zeros(env.nr_substeps, env.nr_envs, env.nr_actuator_joints, device="cuda"), internal)
            terrain_step = lambda: engine.step(
                env.model, physics["qpos"], physics["qvel"], targets[0], nr_substeps=env.nr_substeps,
                dr=env._domain_params(internal), terrain=env.terrain_function.engine_terrain(internal),
                ctrl_sequence=targets, contact_state=physics["contact_anchor"])
            before = counts()["engine_substep"]
            row["eager_physics_ms_a_control_step"] = time_ms(terrain_step, 3)
            if counts()["engine_substep"] != before:
                fail("a heightfield step launched the substep kernel")
        graph.close()
        row["phase_s"] = time.perf_counter() - t0
        rows[name] = row
        print(f"captured {name}: " + json.dumps(row))
        del model, graph, carry
        torch.cuda.empty_cache()
    # locomotion_lstm alone: the ppo recipes add ~65 s to a script near its
    # limit (run them alone: heightfield_recipes({}))
    rows.update(heightfield_recipes(launches_by_path, ("locomotion_lstm",)))
    return rows


class LogLines(logging.Handler):
    """The messages of the records it is handed, from INFO up."""

    def __init__(self):
        super().__init__(logging.INFO)
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


def heightfield_recipes(launches_by_path, names=("locomotion_lstm", "locomotion_ppo", "locomotion_ppo_bf16"),
                        iterations=3):
    """The heightfield recipes ``names`` of ``benchmarks/curves.py`` at their
    own shape, 4096 envs x 32 steps, through ``model.train()``:
    ``iterations`` learning iterations, the first eager, the second
    captured and replayed, the rest replayed.  Each must log the captured
    path, launch B1 once an iteration and B2 never, and log finite values;
    its capture's seconds, pool MiB and graph nodes are read as ``train()``
    closes the graph, and the rate of its last (replayed) and first (eager)
    iteration gives the recipe's budget in hours a seed.  -> the rows."""
    from rlx_tpu_torch.algorithms.training_program import CapturedIteration, capture_choice
    from rlx_tpu_torch.benchmarks.curves import RUNS
    from rlx_tpu_torch.config import create_model, make_config
    from rlx_tpu_torch.utils.logging import rlx_logger

    closed = []
    close = CapturedIteration.close

    def recording_close(graph):
        if graph.graph is not None:
            closed.append({"capture_s": graph.capture_seconds, "pool_mib": graph.pool_bytes / 2**20,
                           "graph_nodes": graph_node_count(graph.graph),
                           "launches_per_replay": dict(zip(("engine_substep", "gae"), graph.launches))})
        close(graph)

    rows = {}
    for name in names:
        run = RUNS[name]
        t0 = time.perf_counter()
        model = create_model(make_config(run["algorithm"], run["environment"], **{
            "runner.device": "cuda", **run["overrides"], "algorithm.logging_active": True,
            "algorithm.evaluation_active": False,
            "algorithm.total_timesteps": iterations * run["overrides"]["environment.nr_envs"]
            * run["overrides"]["algorithm.nr_steps"]}))
        capture, reason = capture_choice(model)
        if not capture:
            fail(f"{name}: capture_choice says eager ({reason})")
        lines, closed[:], level = LogLines(), [], rlx_logger.level
        rlx_logger.addHandler(lines)
        rlx_logger.setLevel(logging.INFO)   # as the runner sets it
        CapturedIteration.close = recording_close
        torch.cuda.CUDAGraph = DebugGraph   # its nodes are counted as train() closes it
        zero_counts()
        try:
            model.train()
            torch.cuda.synchronize()
        finally:
            torch.cuda.CUDAGraph = DebugGraph.__base__
            CapturedIteration.close = close
            rlx_logger.removeHandler(lines)
            rlx_logger.setLevel(level)
        launches = counts()
        if model.train_env.terrain_function.engine_terrain(model.env_state.physics["internal"]) is None:
            fail(f"{name}: the recipe's terrain is no heightfield")
        expected = {"engine_substep": 0, "gae": iterations, "categorical_projection": 0}
        if launches != expected:
            fail(f"{name}: launch counts {launches} != {expected}")
        if not any(line.startswith("Learning iterations: one captured CUDA graph, replayed") for line in lines.lines):
            fail(f"{name}: train() did not log the captured path: {lines.lines}")
        if len(closed) != 1 or closed[0]["launches_per_replay"] != {"engine_substep": 0, "gae": 1}:
            fail(f"{name}: train() closed {closed}, expected one graph of B2 0 and B1 1 launches a replay")
        check_logged(name, model.metrics_history, [16 * (i + 1) for i in range(iterations)])
        launches_by_path[f"{name}_train"] = launches
        sps = [m["time/sps"] for m in model.metrics_history]
        hours = {way: run["budget"] / rate / 3600 for way, rate in (("eager", sps[0]), ("replay", sps[-1]))}
        row = {**closed[0], "env_steps_per_s_an_iteration": sps, "phase_s": time.perf_counter() - t0,
               "budget_hours_a_seed": hours}
        rows[f"{name}_train"] = row
        print(f"captured {name} through train(): " + json.dumps(row))
        print(f"learning check projection: one {run['budget'] / 1e6:.0f}M-step {name} seed at its own shape "
              f"(4096 x 32 on the heightfield) takes {hours['replay']:.2f} h alone at the replayed rate of "
              f"train()'s last iteration ({sps[-1]} env-steps/s), {hours['eager']:.2f} h at the eager first "
              f"iteration's ({sps[0]}); evaluation and saving not included")
        del model
        torch.cuda.empty_cache()
    return rows


def capture_offpolicy_phase(launches_by_path, workdir):
    """Phase 51: the captured learning step of the off-policy core against
    the eager step: FastTD3 at phase 8's shape (1024 envs, batch 8192,
    n_step 3, 101 atoms), FastSAC at phase 21's (1024 envs, batch 8192) and
    SAC, TD3 and DDPG at ``OFFPOLICY_SHAPE`` (1024 envs), each on the Ant
    after its prefill.  Each: ``replay_against_eager`` (the replay equal to
    the eager step bit for bit, the replay buffer's storage, head and fill
    and both generators included; fresh noise a second replay; B2 1, B3 1
    for FastTD3 and FastSAC, B1 0 a replay, the graph's kernel nodes by
    name), then 32 learning steps each way through ``_logging_iteration``
    as ``train()`` runs them (2 logging iterations of 16 after one untimed,
    the eager from the replay's static state), and the idle share of one
    logging iteration of each from the device's events.  Then one FastTD3
    ``train()`` through ``create_model``: the captured path logged, 48
    learning steps, B2 and B3 once a step.  -> the rows."""
    from rlx_tpu_torch.algorithms.training_program import copy_carry_
    from rlx_tpu_torch.config import create_model, make_config
    from rlx_tpu_torch.utils.logging import rlx_logger

    nr_envs, log_steps = 1024, 16
    logged = {"runner.device": "cuda", "environment.nr_envs": nr_envs, "algorithm.evaluation_active": False,
              "algorithm.logging_active": True, "algorithm.logging_frequency": log_steps * nr_envs}
    fasttd3 = {**logged, "algorithm.batch_size": 8192, "algorithm.n_step": 3, "algorithm.nr_atoms": 101,
               "algorithm.v_min": -10.0, "algorithm.v_max": 10.0, "algorithm.learning_starts": 5000}
    cases = {   # name: (algorithm, overrides, launches a replay (B2, B1, B3))
        "fasttd3": ("fasttd3.cuda", fasttd3, (1, 0, 1)),
        "fastsac": ("fastsac.cuda", {**logged, "algorithm.batch_size": 8192, "algorithm.learning_starts": nr_envs},
                    (1, 0, 1)),
        **{name: (f"{name}.cuda", {**logged, **OFFPOLICY_SHAPE}, (1, 0, 0)) for name in ("sac", "td3", "ddpg")},
    }
    rows = {}
    for name, (algorithm, overrides, expected) in cases.items():
        t0 = time.perf_counter()
        model = create_model(make_config(algorithm, "locomotion.ant.cuda", **overrides, **{
            "algorithm.total_timesteps": overrides["algorithm.learning_starts"] + 64 * nr_envs}))
        model._init_train_carry()   # the buffer and the prefill, eager
        # from step 1: the compared step, 2, is one where FastTD3's and TD3's
        # delayed policy steps too
        graph, row = replay_against_eager(51, name, model, (model.initial_step(1),), expected, workdir,
                                          node_names=True)
        launches_by_path[f"{name}_captured_replay"] = row["launches_per_replay"]

        def logging_iterations(n):
            state, step = graph.state, graph.carry[0]
            for _ in range(n):
                state, step = model._logging_iteration(state, step, 0)
            return state, step

        # eager from the replay's static state, then replayed from where it
        # left off, 2 logging iterations each, as train() runs them, each
        # after one untimed logging iteration (the eager loop's first steps
        # after a capture grow the allocator's cache)
        model._last_log_time = time.time()
        for way in ("eager", "replay"):
            model.captured_iteration = graph if way == "replay" else None
            logging_iterations(1)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            state, step = logging_iterations(2)
            torch.cuda.synchronize()
            row[f"{way}_env_steps_per_s"] = 2 * log_steps * nr_envs / (time.perf_counter() - t1)
            if way == "eager":
                graph.state.copy_(state)
                copy_carry_(graph.carry, (step,))
            row[f"{way}_profile"] = device_idle(lambda: logging_iterations(1), f"{model.name}/")
        model.captured_iteration = None
        row["replay_speedup"] = row["replay_env_steps_per_s"] / row["eager_env_steps_per_s"]
        check_logged(name, model.metrics_history)
        graph.close()
        row["phase_s"] = time.perf_counter() - t0
        rows[name] = row
        print(f"captured {name}: " + json.dumps(row))
        del model, graph
        torch.cuda.empty_cache()

    learning_steps = 3 * log_steps
    model = create_model(make_config("fasttd3.cuda", "locomotion.ant.cuda", **fasttd3, **{
        "algorithm.total_timesteps": fasttd3["algorithm.learning_starts"] + learning_steps * nr_envs}))
    lines, level = LogLines(), rlx_logger.level
    rlx_logger.addHandler(lines)
    rlx_logger.setLevel(logging.INFO)   # as the runner sets it
    zero_counts()
    try:
        t0 = time.perf_counter()
        model.train()
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
    finally:
        rlx_logger.removeHandler(lines)
        rlx_logger.setLevel(level)
    launches = counts()
    expected = {"engine_substep": model.prefill_iterations + learning_steps, "gae": 0,
                "categorical_projection": learning_steps}
    if launches != expected:
        fail(f"phase 51 fasttd3 train(): launch counts {launches} != {expected}")
    if not any(line.startswith("Learning iterations: one captured CUDA graph, replayed") for line in lines.lines):
        fail(f"phase 51 fasttd3 train() did not log the captured path: {lines.lines}")
    check_logged("phase 51 fasttd3 train()", model.metrics_history, [log_steps, 2 * log_steps, learning_steps])
    launches_by_path["fasttd3_captured_train"] = launches
    row = {"train_s": train_s, "env_steps_per_s_a_log_line": [m["time/sps"] for m in model.metrics_history],
           "launches": launches, "prefill": model.prefill_iterations}
    rows["fasttd3_train"] = row
    print("captured fasttd3 through train(): " + json.dumps(row)
          + " (the first log line holds the prefill, the eager warm-up step and the capture)")
    del model
    torch.cuda.empty_cache()
    return rows


def main():
    if not torch.cuda.is_available():
        fail("no CUDA device: chip_smoke runs the CUDA kernels and has no CPU fallback")
    workdir = tempfile.TemporaryDirectory()
    dev = torch.device("cuda")
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)

    # 1. card
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi)

    from rlx_tpu_torch.ops import _build
    from rlx_tpu_torch.ops.engine_substep_cuda import step_cuda, substep_bytes, substep_flops
    from rlx_tpu_torch.ops.gae import gae_advantages_reference
    from rlx_tpu_torch.ops.gae_cuda import gae_advantages_cuda, gae_bytes, gae_geometry
    from rlx_tpu_torch.ops.projection_cuda import projection_geometry
    from rlx_tpu_torch.physics import engine, load_model
    from rlx_tpu_torch.environments.locomotion.ant.cuda.environment import ANT_MODEL

    # 2. build
    t0 = time.perf_counter()
    report = _build.build_all()
    resources = {
        name: [line.replace("ptxas info    :", "").strip() for line in out.splitlines()
               if "registers" in line or "stack frame" in line]
        for name, (_, out) in report.items()
    }
    shared = {"gae": gae_geometry(64, 4096).shared_bytes,
              "projection": projection_geometry(8192, 101, 101).shared_bytes}
    print(f"build: {time.perf_counter() - t0:.1f} s for {sorted(report)} {json.dumps(resources)}; "
          f"dynamic shared memory a block at the path's shape {json.dumps(shared)}")

    # f32 products and convolutions (PyTorch lets cuDNN use TF32 by default)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    g = torch.Generator(device=dev).manual_seed(0)
    kernels = []

    # 3. B1: GAE
    def gae_inputs(T, B, float_terminations=False):
        r, v, nv = (torch.randn(T, B, device=dev, generator=g) for _ in range(3))
        d = torch.rand(T, B, device=dev, generator=g) < 0.05
        return r, v, nv, d.float() if float_terminations else d

    gae_cases = {
        "[64, 4096]": gae_inputs(64, 4096), "[64, 4097]": gae_inputs(64, 4097),
        "[64, 4096] float terminations": gae_inputs(64, 4096, True),
        **{f"[{T}, 1000]": gae_inputs(T, 1000) for T in (1, 17, 65, 200)},
        "[17, 1000] float terminations": gae_inputs(17, 1000, True),
    }
    gae_err = 0.0
    for label, args in gae_cases.items():
        out = gae_advantages_cuda(*args, 0.99, 0.95)
        ref = gae_advantages_reference(*args, 0.99, 0.95)
        torch.cuda.synchronize()
        gae_err = max(gae_err, max_err(out, ref, 1e-5, 1e-5, f"GAE {label}"))
    args = gae_cases["[64, 4096]"]
    gae = lambda: gae_advantages_cuda(*args, 0.99, 0.95)
    if not all(torch.equal(a, b) for a, b in zip(gae(), gae())):
        fail("GAE: two launches on the same input differ")
    gae_t = kernel_times(gae, lambda: gae_advantages_reference(*args, 0.99, 0.95), "gae_kernel")
    gae_bound = gae_bytes(64, 4096) / H100_BYTES_PER_S * 1e3
    launch = gae_geometry(64, 4096)
    print(f"B1 gae: {len(gae_cases)} cases ({', '.join(gae_cases)}), max|err| {gae_err:.3g} "
          f"(rtol=atol=1e-5, f32), the same bits over two launches; kernel {gae_t['ms']:.4f} ms "
          f"(device {gae_t['device_ms']:.4f} ms, host {gae_t['host_us']:.1f} us a call) plain "
          f"{gae_t['plain_ms']:.3f} ms bound {gae_bound:.4f} ms at [64, 4096] ({launch.blocks} "
          f"blocks of {launch.threads} threads, {launch.shared_bytes} bytes of shared memory each)")
    kernels.append(dict(
        name="gae", route="cuda", source="rlx_tpu_torch/csrc/gae.cu",
        replaces="rlx_tpu/ops/gae_pallas.py:53", **gae_t, bound_ms=gae_bound, bound_by="bytes",
        library_ms=None, max_abs_err=gae_err,
    ))

    # 4. B2: physics substep, at the PPO (4096) and FastTD3 (1024) batch
    # sizes, a ragged batch, and the Ant without contacts / without actuators
    # (the ncon == 0 and nu == 0 branches; the card has no mujoco to compile
    # another model)
    from rlx_tpu_torch.ops.engine_substep_cuda import lanes_per_env, resident_warps_per_sm

    S = 4
    ant = load_model(ANT_MODEL)
    dropped = {
        "no contacts": ("con_body", "con_pos", "con_radius", "con_friction", "con_meff",
                        "con_m_app", "con_m_app_t"),
        "no actuators": ("act_dof", "act_joint_body", "act_kp", "act_kv", "act_gear",
                         "act_is_position", "act_forcerange"),
    }
    variants = {"Ant": ant, **{name: ant._replace(**{f: getattr(ant, f)[:0] for f in fields})
                               for name, fields in dropped.items()}}

    def ant_batch(model, B):
        qpos0 = torch.as_tensor(model.qpos0, device=dev)
        qpos = qpos0.repeat(B, 1) + 0.1 * torch.randn(B, model.nq, device=dev, generator=g)
        qpos[:, 2] = 0.55 + 0.2 * torch.rand(B, device=dev, generator=g)
        qpos[:, 3:7] /= qpos[:, 3:7].norm(dim=1, keepdim=True)
        qvel = 0.5 * torch.randn(B, model.nv, device=dev, generator=g)
        nu = len(model.act_dof)
        ctrl = qpos0[7:7 + nu] + 0.3 * (2.0 * torch.rand(B, nu, device=dev, generator=g) - 1.0)
        return qpos, qvel, ctrl

    def domain_params(model, B):
        u = lambda *shape: 0.8 + 0.4 * torch.rand(*shape, device=dev, generator=g)
        nu = len(model.act_dof)
        return engine.DomainParams(
            mass_scale=u(model.nbody, B), damping_scale=u(B), frictionloss_scale=u(B),
            armature_scale=u(B), friction_scale=u(B), contact_stiffness_scale=u(B),
            kp_scale=u(nu, B), kv_scale=u(nu, B), forcerange_scale=u(nu, B),
            ctrl_offset=0.1 * (u(nu, B) - 1.0),
            gravity=torch.tensor([0.0, 0.0, -9.81], device=dev)[:, None] * u(B),
        )

    cases = (
        ("Ant", 4096, "entry-pose anchors"), ("Ant", 4096, "given anchors"),
        ("Ant", 4096, "all DomainParams"), ("Ant", 1024, "entry-pose anchors"),
        ("Ant", 1024, "all DomainParams"), ("Ant", 1000, "given anchors"),
        ("Ant", 1000, "ctrl_sequence"), ("no contacts", 1000, "all DomainParams"),
        ("no contacts", 1024, "given anchors"), ("no actuators", 1000, "all DomainParams"),
        ("no actuators", 4096, "entry-pose anchors"),
    )
    # f32 on both sides, but the kernel sums in another order and contracts
    # multiply-adds, and the stiff contact penalties amplify those roundings
    # over 4 substeps: 1e-4 relative + absolute.
    rtol = atol = 1e-4
    step_err = 0.0
    for name, B, label in cases:
        model = variants[name]
        qpos, qvel, ctrl = ant_batch(model, B)
        kw = {}
        if label != "entry-pose anchors":
            kw["contact_state"] = engine.contact_anchor_init(model, qpos)
        if label == "all DomainParams":
            kw["dr"] = domain_params(model, B)
        if label == "ctrl_sequence":
            kw["ctrl_sequence"] = ctrl[None] + 0.1 * torch.randn(3, *ctrl.shape, device=dev, generator=g)
        out = step_cuda(model, qpos, qvel, ctrl, nr_substeps=S, **kw)
        ref = engine.step_reference(model, qpos, qvel, ctrl, nr_substeps=S, **kw)
        torch.cuda.synchronize()
        step_err = max(step_err, max_err(out, ref, rtol, atol, f"substep ({name}, B={B}, {label})"))
    print(f"B2 engine_substep: {len(cases)} cases against engine.step_reference, max|err| "
          f"{step_err:.3g} (rtol=atol=1e-4): " + "; ".join(f"{n} B={B} {lab}" for n, B, lab in cases))
    by_batch = {}
    for B in (4096, 1024):
        qpos, qvel, ctrl = ant_batch(ant, B)
        substep = lambda: step_cuda(ant, qpos, qvel, ctrl, nr_substeps=S)
        flops = substep_flops(ant) * B * S
        nbytes = substep_bytes(ant, B, with_anchors=False)
        lanes = lanes_per_env(B)
        bound_ms, bound_by = roofline(nbytes, flops)
        t = by_batch[B] = dict(
            ms=time_ms(substep, 100), device_ms=kernel_device_ms(substep, 100, "engine_substep_kernel"),
            host_us=host_us(substep),
            plain_ms=time_ms(lambda: engine.step_reference(ant, qpos, qvel, ctrl, nr_substeps=S), 3),
            bound_ms=bound_ms, bound_by=bound_by,
            lanes_per_env=lanes, resident_warps_per_sm=resident_warps_per_sm(ant, lanes),
        )
        print(f"B2 engine_substep at B={B}, {S} substeps: kernel {t['ms']:.4f} ms (device "
              f"{t['device_ms']:.4f} ms, host {t['host_us']:.1f} us a call) plain {t['plain_ms']:.2f} ms "
              f"bound {t['bound_ms']:.5f} ms ({t['bound_by']}: {flops} flops, {nbytes} bytes), "
              f"{100 * t['bound_ms'] / t['device_ms']:.2f} % of the bound; {lanes} lanes per env, "
              f"{t['resident_warps_per_sm']} resident warps per SM")
    main = by_batch[4096]
    kernels.append(dict(
        name="engine_substep", route="cuda", source="rlx_tpu_torch/csrc/engine_substep.cu",
        replaces="rlx_tpu/ops/engine_substep_pallas.py:82", ms=main["ms"], device_ms=main["device_ms"],
        host_us=main["host_us"],
        plain_ms=main["plain_ms"], bound_ms=main["bound_ms"], bound_by=main["bound_by"],
        library_ms=None, max_abs_err=step_err, by_batch={str(B): t for B, t in by_batch.items()},
    ))

    # 5. train: the main path through the runner's entry points
    from rlx_tpu_torch.config import create_model, make_config
    from rlx_tpu_torch.utils.logging import setup_logger

    setup_logger()
    nr_envs, nr_steps = 4096, 64
    batch = nr_envs * nr_steps
    config = make_config("ppo.cuda", "locomotion.ant.cuda", **{
        "runner.device": "cuda",
        "environment.nr_envs": nr_envs,
        "algorithm.nr_steps": nr_steps,
        "algorithm.total_timesteps": ITERATIONS * batch,
        "algorithm.minibatch_size": batch // 8,
        "algorithm.nr_epochs": 4,
        "algorithm.policy_hidden_sizes": (512, 256, 128),
        "algorithm.critic_hidden_sizes": (512, 256, 128),
        "algorithm.activation": "elu",
        "algorithm.layer_norm": True,
        "algorithm.compute_dtype": "bfloat16",
        "algorithm.evaluation_active": False,
    })
    model = create_model(config)
    from rlx_tpu_torch.algorithms.training_program import capture_choice

    captured, reason = capture_choice(model)
    if not captured:
        fail(f"PPO at the flagship shape does not replay a captured iteration: {reason}")
    step_cuda.launches = 0
    gae_advantages_cuda.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model.train()
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = {"engine_substep": step_cuda.launches, "gae": gae_advantages_cuda.launches}
    if launches != {"engine_substep": nr_steps * ITERATIONS, "gae": ITERATIONS}:
        fail(f"launch counts {launches} != {nr_steps * ITERATIONS} substep and {ITERATIONS} GAE")
    history = model.metrics_history
    if len(history) != ITERATIONS:
        fail(f"{len(history)} iterations logged, expected {ITERATIONS}")
    for it, metrics in enumerate(history):
        for k, v in metrics.items():
            if k.startswith("loss/") and not math.isfinite(v):
                fail(f"iteration {it}: {k} = {v}")
    for p in list(model.policy.module.parameters()) + list(model.critic.parameters()):
        if not torch.isfinite(p).all():
            fail("non-finite parameters after training")
    ppo_env_steps_per_s = ITERATIONS * batch / elapsed   # phase 42 compares 4 seeds with it
    print(f"train: {ITERATIONS} PPO iterations at {nr_envs}x{nr_steps} (the first eager, then replays), "
          f"{ITERATIONS * batch / elapsed:.0f} env-steps/s overall, "
          f"{history[-1]['time/sps']} env-steps/s in the last iteration, launches {launches}, "
          f"last losses " + json.dumps({k: v for k, v in history[-1].items() if k.startswith('loss/')}))

    # 6. where the time goes: one more iteration under the profiler (after
    # the counts above were read)
    def one_iteration():
        model.env_state, _ = model.learning_iteration(model.env_state)

    print("profile: " + json.dumps(profile_spans(one_iteration, "ppo/")))
    launches_by_path = {"ppo": launches}
    del model

    # 48. the learning iteration captured as one CUDA graph, against eager:
    # run here, after phase 6, while the profiler's tracer keeps every
    # record of a replay (late in the script it dropped one B2 record)
    phase_t0 = time.perf_counter()
    capture_phase(launches_by_path, workdir.name)
    print(f"phase 48 took {time.perf_counter() - phase_t0:.1f} s")

    # 49. the captured iteration of the recurrent PPOs, REPPO and PQN against
    # eager, also while the tracer is reliable
    phase_t0 = time.perf_counter()
    capture_families_phase(launches_by_path, workdir.name)
    print(f"phase 49 took {time.perf_counter() - phase_t0:.1f} s")

    # 50. the captured iteration on the robot and soccer envs against eager:
    # B2 and B1 inside the graph on the plane and soccer, the eager engine
    # over the heightfield
    phase_t0 = time.perf_counter()
    capture_robot_phase(launches_by_path, workdir.name)
    print(f"phase 50 took {time.perf_counter() - phase_t0:.1f} s")

    # 51. the captured learning step of FastTD3, FastSAC, SAC, TD3 and DDPG
    # against eager: B2 and B3 inside the graph
    phase_t0 = time.perf_counter()
    capture_offpolicy_phase(launches_by_path, workdir.name)
    print(f"phase 51 took {time.perf_counter() - phase_t0:.1f} s")

    # 7. B3: C51 projection
    from rlx_tpu_torch.ops.distributional import categorical_projection_reference
    from rlx_tpu_torch.ops.projection_cuda import (
        categorical_projection_cuda, projection_bytes, projection_flops,
    )

    v_min, v_max, nr_atoms = -10.0, 10.0, 101
    atoms = torch.linspace(v_min, v_max, nr_atoms, device=dev)

    def softmax_probs(n, a):
        return torch.softmax(2.0 * torch.randn(n, a, device=dev, generator=g), dim=-1)

    def fasttd3_targets(n):
        # r + gamma_n (1 - d) atoms, as the FastTD3 update builds them
        r = 3.0 * torch.randn(n, 1, device=dev, generator=g)
        d = (torch.rand(n, 1, device=dev, generator=g) < 0.1).float()
        gamma_n = 0.97 ** torch.randint(1, 4, (n, 1), device=dev, generator=g).float()
        return r + gamma_n * (1.0 - d) * atoms[None]

    def uniform(n, a):
        return 28.0 * torch.rand(n, a, device=dev, generator=g) - 14.0

    on_atoms = atoms[None].repeat(8192, 1)   # every position an atom (b integral or 1 ulp off)
    on_atoms[4096:] = torch.where(torch.rand(4096, nr_atoms, device=dev, generator=g) < 0.5,
                                  v_min - 2.0, v_max + 2.0)
    clipped = torch.full((64, nr_atoms), v_max + 3.0, device=dev)   # runs of 32 lanes on one atom
    clipped[32:] = v_min - 3.0
    cases = {   # label: (positions, masses, output atoms)
        "[8192, 101] FastTD3 targets": (fasttd3_targets(8192), softmax_probs(8192, 101), nr_atoms),
        "[8193, 101] ragged": (uniform(8193, 101), softmax_probs(8193, 101), nr_atoms),
        "[4096, 51] -> 101": (uniform(4096, 51), softmax_probs(4096, 51), nr_atoms),
        "[8192, 101] on atoms and beyond the support": (on_atoms, softmax_probs(8192, 101), nr_atoms),
        "[64, 101] at v_max (b = A_out - 1)": (torch.full((64, nr_atoms), v_max, device=dev),
                                               softmax_probs(64, 101), nr_atoms),
        "[64, 101] every position clipped to one end": (clipped, softmax_probs(64, 101), nr_atoms),
        "[1000, 101] -> 2": (uniform(1000, 101), softmax_probs(1000, 101), 2),
        "[64, 8192] -> 101": (uniform(64, 8192), softmax_probs(64, 8192), nr_atoms),
        "[1027, 101] -> 11": (uniform(1027, 101), softmax_probs(1027, 101), 11),
    }
    # f32 on both sides with the same true division and the same hat
    # weights; the kernel sums each atom's terms in its own fixed order, the
    # plain einsum in another
    rtol = atol = 1e-6
    proj_err = 0.0
    for label, (z, p, a_out) in cases.items():
        out = categorical_projection_cuda(z, p, v_min, v_max, a_out)
        ref = categorical_projection_reference(z, p, v_min, v_max, a_out)
        torch.cuda.synchronize()
        proj_err = max(proj_err, max_err([out], [ref], rtol, atol, f"projection {label}"))
    z, p, _ = cases["[8192, 101] FastTD3 targets"]
    project = lambda: categorical_projection_cuda(z, p, v_min, v_max, nr_atoms)
    if not torch.equal(project(), project()):
        fail("projection: two launches on the same input differ")
    plain = lambda: categorical_projection_reference(z, p, v_min, v_max, nr_atoms)
    proj_t = kernel_times(project, plain, "projection_kernel")
    nbytes, flops = projection_bytes(8192, 101, 101), projection_flops(8192, 101)
    proj_bound, bound_by = roofline(nbytes, flops)
    launch = projection_geometry(8192, 101, 101)
    print(f"B3 projection: {len(cases)} cases ({', '.join(cases)}), max|err| {proj_err:.3g} "
          f"(rtol=atol=1e-6, f32), the same bits over two launches; kernel {proj_t['ms']:.4f} ms "
          f"(device {proj_t['device_ms']:.4f} ms, host {proj_t['host_us']:.1f} us a call) plain "
          f"{proj_t['plain_ms']:.3f} ms bound {proj_bound:.5f} ms ({bound_by}: {nbytes} bytes, {flops} "
          f"flops) at [8192, 101] -> 101 ({launch.blocks} blocks of {launch.threads} threads, "
          f"{launch.shared_bytes} bytes of shared memory each)")
    kernels.append(dict(
        name="categorical_projection", route="cuda", source="rlx_tpu_torch/csrc/projection.cu",
        replaces="rlx_tpu/ops/projection_pallas.py:47", **proj_t,
        bound_ms=proj_bound, bound_by=bound_by, library_ms=None, max_abs_err=proj_err,
    ))

    # 8. FastTD3 through the entry points
    nr_envs, learning_steps, log_steps = 1024, 64, 16
    learning_starts = 5000
    config = make_config("fasttd3.cuda", "locomotion.ant.cuda", **{
        "runner.device": "cuda",
        "environment.nr_envs": nr_envs,
        "algorithm.batch_size": 8192,
        "algorithm.n_step": 3,
        "algorithm.nr_atoms": nr_atoms,
        "algorithm.v_min": v_min,
        "algorithm.v_max": v_max,
        "algorithm.learning_starts": learning_starts,
        "algorithm.total_timesteps": learning_starts + learning_steps * nr_envs,
        "algorithm.logging_frequency": log_steps * nr_envs,
        "algorithm.evaluation_active": False,
        "runner.save_optimizer_state": True,   # for phase 11's save
    })
    td3_run_path = os.path.join(workdir.name, "fasttd3")
    td3 = create_model(config, run_path=td3_run_path)
    step_cuda.launches = 0
    categorical_projection_cuda.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    td3.train()
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    td3_launches = {"engine_substep": step_cuda.launches,
                    "categorical_projection": categorical_projection_cuda.launches}
    expected = {"engine_substep": td3.prefill_iterations + learning_steps,
                "categorical_projection": learning_steps}
    if td3.prefill_iterations != 5 or td3_launches != expected:
        fail(f"FastTD3 launch counts {td3_launches} != {expected} (prefill {td3.prefill_iterations})")
    history = td3.metrics_history
    if [m["steps/nr_updates"] for m in history] != [16, 32, 48, 64]:
        fail(f"FastTD3 logged {[m['steps/nr_updates'] for m in history]}, expected [16, 32, 48, 64]")
    for it, metrics in enumerate(history):
        for k, v in metrics.items():
            if not math.isfinite(v):
                fail(f"FastTD3 log line {it}: {k} = {v}")
    for state in (td3.policy, td3.critic):
        for module in (state.module, state.target):
            if not all(torch.isfinite(p).all() for p in module.parameters()):
                fail("FastTD3: non-finite parameters after training")
    count = float(td3.obs_normalizer["count"])
    finite = all(torch.isfinite(v).all() for v in td3.obs_normalizer.values())
    if count < learning_steps * nr_envs or not finite:
        fail(f"FastTD3 observation normalizer count {count} < {learning_steps * nr_envs} or not finite")
    env_steps = (td3.prefill_iterations + learning_steps) * nr_envs
    print(f"train: FastTD3 {td3.prefill_iterations} prefill + {learning_steps} learning steps at "
          f"{nr_envs} envs, batch 8192, in {elapsed:.2f} s ({env_steps / elapsed:.0f} env-steps/s, "
          f"buffer allocation and prefill included); env-steps/s of the 4 log lines (the first "
          f"includes the prefill) {[m['time/sps'] for m in history]}, launches {td3_launches}, "
          f"normalizer count {count}, "
          f"buffer {td3.buffer.storage.numel() * 4 / 2**20:.0f} MiB, last log line "
          + json.dumps({k: v for k, v in history[-1].items() if k.startswith(("loss/", "q_value/"))}))
    launches_by_path["fasttd3"] = td3_launches

    # 9. where the time goes: 16 more learning steps under the profiler
    def one_logging_iteration():
        td3.env_state, _ = td3._logging_iteration(td3.env_state, td3.initial_step(learning_steps), learning_steps)

    print("profile fasttd3: " + json.dumps(profile_spans(one_logging_iteration, "fasttd3/")))

    # 10. PPO through the Runner: eval/save iterations, then test mode
    from rlx_tpu_torch.runner.runner import Runner
    from rlx_tpu_torch.utils import checkpoint as ckpt

    nr_envs, horizon = 4096, 200   # the horizon cut from the Ant's 1000; the widths stay full
    flagship = [
        "--environment.name=locomotion.ant.cuda", "--runner.device=cuda", f"--environment.nr_envs={nr_envs}",
        f"--environment.horizon={horizon}",
        f"--algorithm.nr_steps={nr_steps}", f"--algorithm.minibatch_size={batch // 8}",
        "--algorithm.nr_epochs=4", "--algorithm.policy_hidden_sizes=(512, 256, 128)",
        "--algorithm.critic_hidden_sizes=(512, 256, 128)", "--algorithm.activation=elu",
        "--algorithm.layer_norm=True", "--algorithm.compute_dtype=bfloat16",
    ]
    os.chdir(workdir.name)   # the runner makes its run directory under the working directory
    runner = Runner([*flagship, f"--algorithm.total_timesteps={2 * batch}",
                     f"--algorithm.evaluation_and_save_frequency={batch}", "--runner.save_model=True",
                     "--runner.run_name=ppo"])
    step_cuda.launches = 0
    gae_advantages_cuda.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trained = runner.run()
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    launches = {"engine_substep": step_cuda.launches, "gae": gae_advantages_cuda.launches}
    expected = {"engine_substep": 2 * nr_steps + 2 * horizon, "gae": 2}
    if launches != expected:
        fail(f"PPO runner launch counts {launches} != {expected}")
    history = trained.eval_history
    if history is None or [int(x) for x in history["steps"]] != [batch, 2 * batch]:
        fail(f"PPO eval history steps {None if history is None else history['steps']} != [{batch}, {2 * batch}]")
    eval_returns = [float(r) for r in history["eval/episode_return"]]
    if not all(math.isfinite(r) for r in eval_returns):
        fail(f"PPO eval returns {eval_returns}")
    models_dir = os.path.join(workdir.name, "runs", "rlx_tpu_torch", "default", "ppo", "models")
    latest, best = os.path.join(models_dir, "latest.model"), os.path.join(models_dir, "best.model")
    # the first evaluation always beats -inf, so best.model must exist
    if not os.path.isfile(latest) or not os.path.isfile(best) or os.path.exists(os.path.join(models_dir, "tmp")):
        fail(f"PPO models {sorted(os.listdir(models_dir))}: expected latest.model and best.model, no tmp")
    if eval_returns[1] > eval_returns[0]:
        same_tree(ckpt.load_model_file(latest)[0], ckpt.load_model_file(best)[0])
    # the times of one more evaluation and one more save, after the counts were read
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trained._eval_iteration(2)
    torch.cuda.synchronize()
    eval_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    trained.save()
    save_ms = (time.perf_counter() - t0) * 1e3
    checkpoint_mib = os.path.getsize(latest) / 2**20

    tester = Runner([*flagship, "--runner.mode=test", f"--runner.load_model={latest}",
                     "--runner.nr_test_episodes=10", "--runner.run_name=ppo_test"])
    step_cuda.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    test_returns = tester.run()
    torch.cuda.synchronize()
    test_s = time.perf_counter() - t0
    test_launches = step_cuda.launches
    if len(test_returns) != 10 or not all(math.isfinite(r) for r in test_returns):
        fail(f"PPO test mode returned {test_returns}, expected 10 finite returns")
    if not 0 < test_launches <= horizon:
        fail(f"PPO test mode launched B2 {test_launches} times, expected 1 to {horizon}")
    compared = same_tree(trained.checkpoint_tree(), tester.model.checkpoint_tree())
    t0 = time.perf_counter()
    tester.model.restore_from_tree(ckpt.load_model_file(latest)[0])
    torch.cuda.synchronize()
    load_ms = (time.perf_counter() - t0) * 1e3
    os.chdir(root)
    print(f"runner ppo: 2 eval/save iterations of 1 learning iteration at {nr_envs}x{nr_steps}, horizon "
          f"{horizon}: train {train_s:.2f} s (2 iterations, 2 evaluations, 3 saves), one evaluation "
          f"({horizon} steps) {eval_s:.2f} s, save {save_ms:.1f} ms, load {load_ms:.1f} ms, checkpoint "
          f"{checkpoint_mib:.2f} MiB; launches {launches}; eval returns {eval_returns}; test mode "
          f"{test_s:.2f} s (load included), {test_launches} B2 launches, {compared} tensors restored bit "
          f"for bit, returns {[round(r, 2) for r in test_returns]}")
    launches_by_path["ppo_runner"] = launches
    launches_by_path["ppo_test"] = {"engine_substep": test_launches}

    # 11. FastTD3: full-state save of phase 8's model, load and test mode through the runner
    t0 = time.perf_counter()
    td3.save()
    td3_save_ms = (time.perf_counter() - t0) * 1e3
    td3_latest = os.path.join(td3_run_path, "models", "latest.model")
    os.chdir(workdir.name)
    tester = Runner(["--algorithm.name=fasttd3.cuda", "--environment.name=locomotion.ant.cuda",
                     "--runner.device=cuda", "--runner.mode=test", f"--runner.load_model={td3_latest}",
                     "--runner.save_optimizer_state=True",
                     "--environment.nr_envs=1024", f"--environment.horizon={horizon}",
                     "--runner.nr_test_episodes=4", "--runner.run_name=fasttd3_test"])
    step_cuda.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    test_returns = tester.run()
    torch.cuda.synchronize()
    test_s = time.perf_counter() - t0
    test_launches = step_cuda.launches
    os.chdir(root)
    if len(test_returns) != 4 or not all(math.isfinite(r) for r in test_returns):
        fail(f"FastTD3 test mode returned {test_returns}, expected 4 finite returns")
    if not 0 < test_launches <= horizon:
        fail(f"FastTD3 test mode launched B2 {test_launches} times, expected 1 to {horizon}")
    tree = td3.checkpoint_tree()
    if set(tree) != {"full"} or tree["full"]["nr_updates"] != td3.nr_updates:
        fail(f"FastTD3 checkpoint tree {sorted(tree)} without the full state")
    compared = same_tree(tree, tester.model.checkpoint_tree())
    t0 = time.perf_counter()
    tester.model.restore_from_tree(ckpt.load_model_file(td3_latest)[0])
    torch.cuda.synchronize()
    td3_load_ms = (time.perf_counter() - t0) * 1e3
    print(f"runner fasttd3: full-state save {td3_save_ms:.1f} ms, load {td3_load_ms:.1f} ms, checkpoint "
          f"{os.path.getsize(td3_latest) / 2**20:.2f} MiB, {compared} tensors (parameters, targets, "
          f"normalizer, AdamW moments and steps) and the update count {td3.nr_updates} restored bit for "
          f"bit; test mode at 1024 envs, horizon {horizon}: {test_s:.2f} s (load included), "
          f"{test_launches} B2 launches, returns {[round(r, 2) for r in test_returns]}")
    launches_by_path["fasttd3_test"] = {"engine_substep": test_launches}

    # 12-13. SAC, TD3 and DDPG on the Ant at bench_offpolicy's shape
    def offpolicy_path(algorithm, learning_steps):
        """Train ``algorithm`` through the entry points: 1 prefill step and
        ``learning_steps`` learning steps in log lines of 16; fails unless
        B2 launched once a step and every logged value is finite."""
        nr_envs, log_steps = 1024, 16
        config = make_config(algorithm, "locomotion.ant.cuda", **{
            "runner.device": "cuda", "environment.nr_envs": nr_envs, **OFFPOLICY_SHAPE,
            "algorithm.total_timesteps": nr_envs + learning_steps * nr_envs,
            "algorithm.logging_frequency": log_steps * nr_envs,
        })
        model = create_model(config)
        step_cuda.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model.train()
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
        launches = {"engine_substep": step_cuda.launches}
        if model.prefill_iterations != 1 or launches["engine_substep"] != 1 + learning_steps:
            fail(f"{algorithm} launch counts {launches} != {1 + learning_steps} "
                 f"(prefill {model.prefill_iterations})")
        history = model.metrics_history
        logged = [m["steps/nr_updates"] for m in history]
        if logged != list(range(log_steps, learning_steps + 1, log_steps)):
            fail(f"{algorithm} logged updates {logged}")
        for it, metrics in enumerate(history):
            for k, v in metrics.items():
                if not math.isfinite(v):
                    fail(f"{algorithm} log line {it}: {k} = {v}")
        for name in model.state_names:
            state = getattr(model, name)
            for module in (state.module, state.target):
                if module is not None and not all(torch.isfinite(p).all() for p in module.parameters()):
                    fail(f"{algorithm}: non-finite {name} parameters after training")
        env_steps = (1 + learning_steps) * nr_envs
        print(f"train: {algorithm} 1 prefill + {learning_steps} learning steps at {nr_envs} envs, batch "
              f"8192, 512/256/128, in {elapsed:.2f} s ({env_steps / elapsed:.0f} env-steps/s with the buffer "
              f"allocation and the prefill); env-steps/s of the {len(history)} log lines (the first "
              f"includes the prefill) {[m['time/sps'] for m in history]}, launches {launches}, last log line "
              + json.dumps({k: v for k, v in history[-1].items() if k.startswith(("loss/", "q_value/", "entropy/"))}))
        return model, launches

    sac, launches_by_path["sac"] = offpolicy_path("sac.cuda", 64)

    def sac_logging_iteration():
        sac.env_state, _ = sac._logging_iteration(sac.env_state, sac.initial_step(64), 64)

    print("profile sac: " + json.dumps(profile_spans(sac_logging_iteration, "sac/")))
    _, launches_by_path["td3"] = offpolicy_path("td3.cuda", 32)
    _, launches_by_path["ddpg"] = offpolicy_path("ddpg.cuda", 32)

    # 14. SAC through the Runner with its optimizer state, then test mode
    os.chdir(workdir.name)
    shape = [f"--{k}={v}" for k, v in OFFPOLICY_SHAPE.items()]
    sac_args = ["--algorithm.name=sac.cuda", "--environment.name=locomotion.ant.cuda", "--runner.device=cuda",
                "--environment.nr_envs=1024", *shape, "--runner.save_optimizer_state=True"]
    runner = Runner([*sac_args, f"--algorithm.total_timesteps={1024 + 16 * 1024}",
                     f"--algorithm.logging_frequency={16 * 1024}", "--runner.save_model=True",
                     "--runner.run_name=sac"])
    step_cuda.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trained = runner.run()
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    runner_launches = {"engine_substep": step_cuda.launches}
    if runner_launches["engine_substep"] != 17 or trained.nr_updates != 16:
        fail(f"SAC runner launch counts {runner_launches} != 17 or {trained.nr_updates} updates != 16")
    sac_latest = os.path.join(workdir.name, "runs", "rlx_tpu_torch", "default", "sac", "models", "latest.model")
    tester = Runner([*sac_args, f"--environment.horizon={horizon}", "--runner.mode=test",
                     f"--runner.load_model={sac_latest}", "--runner.nr_test_episodes=4",
                     "--runner.run_name=sac_test"])
    step_cuda.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    test_returns = tester.run()
    torch.cuda.synchronize()
    test_s = time.perf_counter() - t0
    test_launches = step_cuda.launches
    os.chdir(root)
    if len(test_returns) != 4 or not all(math.isfinite(r) for r in test_returns):
        fail(f"SAC test mode returned {test_returns}, expected 4 finite returns")
    if not 0 < test_launches <= horizon:
        fail(f"SAC test mode launched B2 {test_launches} times, expected 1 to {horizon}")
    tree = trained.checkpoint_tree()
    if set(tree) != {"full"} or set(tree["full"]) != {"policy", "critic", "alpha", "nr_updates"}:
        fail(f"SAC checkpoint tree {sorted(tree)} without the full state")
    compared = same_tree(tree, tester.model.checkpoint_tree())
    print(f"runner sac: train {train_s:.2f} s (1 prefill + 16 learning steps at 1024 envs, 1 full-state "
          f"save), launches {runner_launches}; {compared} tensors (parameters, critic target, log_alpha, "
          f"Adam moments and steps) and the update count {trained.nr_updates} restored bit for bit, "
          f"checkpoint {os.path.getsize(sac_latest) / 2**20:.2f} MiB; test mode at 1024 envs, horizon "
          f"{horizon}: {test_s:.2f} s (load included), {test_launches} B2 launches, returns "
          f"{[round(r, 2) for r in test_returns]}")
    launches_by_path["sac_runner"] = runner_launches
    launches_by_path["sac_test"] = {"engine_substep": test_launches}

    # 15. C51 on CartPole through the Runner at the cartpole_spot_c51 recipe
    # (8 envs, batch 128, (512,) relu, 51 atoms over 0..500, lr 1e-3): the
    # 10k-step random prefill, then 256 learning steps, each through B3
    from rlx_tpu_torch.benchmarks.curves import RUNS

    recipe = lambda name: [f"--{k}={v}" for k, v in RUNS[name]["overrides"].items()]
    cartpole = ["--environment.name=classic.cart_pole.cuda", "--runner.device=cuda"]
    c51_steps, c51_starts = 256, 10_000
    os.chdir(workdir.name)
    c51_args = ["--algorithm.name=c51.cuda", *cartpole, *recipe("cartpole_spot_c51"),
                "--runner.save_optimizer_state=True"]
    runner = Runner([*c51_args, f"--algorithm.learning_starts={c51_starts}",
                     f"--algorithm.total_timesteps={c51_starts + c51_steps * 8}",
                     f"--algorithm.logging_frequency={64 * 8}", "--algorithm.evaluation_active=False",
                     "--runner.save_model=True", "--runner.run_name=c51"])
    zero_counts()
    t0 = time.perf_counter()
    trained = runner.run()
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    c51_launches = counts()
    expected = {"engine_substep": 0, "gae": 0, "categorical_projection": c51_steps}
    if c51_launches != expected or trained.prefill_iterations != c51_starts // 8:
        fail(f"C51 launch counts {c51_launches} != {expected} (prefill {trained.prefill_iterations})")
    if trained.nr_updates != c51_steps or trained.critic.step_count() != c51_steps:
        fail(f"C51 took {trained.nr_updates} learning steps and {trained.critic.step_count()} Adam steps")
    check_logged("C51", trained.metrics_history, [64, 128, 192, 256])
    c51_sps = [m["time/sps"] for m in trained.metrics_history]
    c51_latest = os.path.join(workdir.name, "runs", "rlx_tpu_torch", "default", "c51", "models", "latest.model")
    tester = Runner([*c51_args, "--runner.mode=test", f"--runner.load_model={c51_latest}",
                     "--runner.nr_test_episodes=8", "--runner.run_name=c51_test"])
    zero_counts()
    t0 = time.perf_counter()
    test_returns = tester.run()
    torch.cuda.synchronize()
    test_s = time.perf_counter() - t0
    c51_test_launches = counts()
    os.chdir(root)
    if len(test_returns) != 8 or not all(math.isfinite(r) for r in test_returns):
        fail(f"C51 test mode returned {test_returns}, expected 8 finite returns")
    tree = trained.checkpoint_tree()
    if set(tree) != {"full"} or set(tree["full"]) != {"critic", "nr_updates"}:
        fail(f"C51 checkpoint tree {sorted(tree)} without the full state")
    compared = same_tree(tree, tester.model.checkpoint_tree())
    print(f"train: C51 on CartPole, {trained.prefill_iterations} prefill + {c51_steps} learning steps at 8 envs, "
          f"batch 128, (512,), 51 atoms over 0..500, through the Runner in {train_s:.2f} s; env-steps/s of the 4 "
          f"log lines (the first includes the prefill) {c51_sps}, launches {c51_launches}, last log line "
          + json.dumps({k: v for k, v in trained.metrics_history[-1].items()
                        if k.startswith(("loss/", "q_value/", "epsilon/"))})
          + f"; {compared} tensors (parameters, target, Adam moments and steps) and the update count restored "
          f"bit for bit, test mode {test_s:.2f} s, launches {c51_test_launches}, returns {test_returns}")
    launches_by_path["c51"] = c51_launches
    launches_by_path["c51_test"] = c51_test_launches

    # B3 at C51's shapes: the recipe's [128, 51] -> 51 over 0..500 and the
    # defaults' [32, 51] -> 51 over -10..10, with rows whose every position
    # is an atom (reward 0, terminated) or clips to one end of the support
    def c51_targets(n, v_lo, v_hi, reward):
        support = torch.linspace(v_lo, v_hi, 51, device=dev)
        r = reward(n)
        d = (torch.rand(n, 1, device=dev, generator=g) < 0.1).float()
        quarter = n // 4
        r[:quarter], d[:quarter] = 0.0, 1.0                      # every position on the atom at 0
        r[quarter:2 * quarter], d[quarter:2 * quarter] = 10 * v_hi + 1.0, 0.0   # clipped to v_max
        r[2 * quarter:3 * quarter], d[2 * quarter:3 * quarter] = -10 * v_hi - 1.0, 0.0   # to v_min
        return r + 0.99 * (1.0 - d) * support[None], softmax_probs(n, 51)

    c51_shapes = {
        "[128, 51] -> 51": (128, 0.0, 500.0, lambda n: torch.ones(n, 1, device=dev)),
        "[32, 51] -> 51": (32, -10.0, 10.0, lambda n: 3.0 * torch.randn(n, 1, device=dev, generator=g)),
    }
    b3_by_shape = {}
    for label, (n, v_lo, v_hi, reward) in c51_shapes.items():
        z, p = c51_targets(n, v_lo, v_hi, reward)
        out = categorical_projection_cuda(z, p, v_lo, v_hi, 51)
        ref = categorical_projection_reference(z, p, v_lo, v_hi, 51)
        torch.cuda.synchronize()
        err = max_err([out], [ref], 1e-6, 1e-6, f"projection {label}")
        if not torch.allclose(out[:n // 4], torch.nn.functional.one_hot(
                torch.full((n // 4,), round(-v_lo / (v_hi - v_lo) * 50), device=dev), 51).float(), atol=1e-6):
            fail(f"projection {label}: the on-atom rows do not put all their mass on the atom at 0")
        t = kernel_times(lambda: categorical_projection_cuda(z, p, v_lo, v_hi, 51),
                         lambda: categorical_projection_reference(z, p, v_lo, v_hi, 51), "projection_kernel")
        t["bound_ms"], t["bound_by"] = roofline(projection_bytes(n, 51, 51), projection_flops(n, 51))
        b3_by_shape[label] = {**t, "max_abs_err": err}
        print(f"B3 projection at {label} (C51, v {v_lo:g}..{v_hi:g}): max|err| {err:.3g} (rtol=atol=1e-6), "
              f"kernel {t['ms']:.4f} ms (device {t['device_ms']:.4f} ms, host {t['host_us']:.1f} us a call) "
              f"plain {t['plain_ms']:.3f} ms bound {t['bound_ms']:.6f} ms ({t['bound_by']}: "
              f"{projection_bytes(n, 51, 51)} bytes)")
    kernels[2]["by_shape"] = b3_by_shape

    # 16. DQN, DDQN and DQN-HL-Gauss on CartPole at their recipes (batch 128,
    # (512,) relu, lr 1e-3; HL-Gauss 101 bins over 0..500): the 10k-step
    # prefill, then 64 learning steps in 4 log lines; no kernel on these paths
    for name in ("dqn", "ddqn", "dqn_hl_gauss"):
        overrides = {**RUNS[f"cartpole_spot_{name}"]["overrides"], "runner.device": "cuda",
                     "algorithm.learning_starts": c51_starts,
                     "algorithm.total_timesteps": c51_starts + 64 * 8, "algorithm.logging_frequency": 16 * 8,
                     "algorithm.evaluation_active": False}
        model = create_model(make_config(f"{name}.cuda", "classic.cart_pole.cuda", **overrides))
        zero_counts()
        t0 = time.perf_counter()
        model.train()
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
        path_launches = counts()
        if any(path_launches.values()) or model.nr_updates != 64:
            fail(f"{name}: launches {path_launches}, {model.nr_updates} learning steps")
        check_logged(name, model.metrics_history, [16, 32, 48, 64])
        print(f"train: {name} on CartPole, {model.prefill_iterations} prefill + 64 learning steps at 8 envs, batch "
              f"128, in {elapsed:.2f} s; env-steps/s of the 4 log lines (the first includes the prefill) "
              f"{[m['time/sps'] for m in model.metrics_history]}, launches {path_launches}, last losses "
              + json.dumps({k: v for k, v in model.metrics_history[-1].items() if k.startswith("loss/")}))
        launches_by_path[name] = path_launches

    # 17. PQN on CartPole through the Runner at its recipe (8 envs x 32
    # steps, 2 epochs of 4 minibatches, (512,) relu + LayerNorm): 2 learning
    # iterations with an evaluation and a save after each, then test mode
    os.chdir(workdir.name)
    pqn_args = ["--algorithm.name=pqn.cuda", *cartpole, *recipe("cartpole_spot_pqn")]
    runner = Runner([*pqn_args, "--algorithm.total_timesteps=512", "--algorithm.evaluation_and_save_frequency=256",
                     "--runner.save_model=True", "--runner.run_name=pqn"])
    zero_counts()
    t0 = time.perf_counter()
    trained = runner.run()
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    pqn_launches = counts()
    if any(pqn_launches.values()) or trained.nr_optimizer_steps != 16:
        fail(f"PQN launches {pqn_launches}, {trained.nr_optimizer_steps} optimizer steps (expected 16)")
    check_logged("PQN", trained.metrics_history, [8, 16])
    if [int(s) for s in trained.eval_history["steps"]] != [256, 512]:
        fail(f"PQN eval history steps {trained.eval_history['steps']}")
    pqn_latest = os.path.join(workdir.name, "runs", "rlx_tpu_torch", "default", "pqn", "models", "latest.model")
    tester = Runner([*pqn_args, "--runner.mode=test", f"--runner.load_model={pqn_latest}",
                     "--runner.nr_test_episodes=8", "--runner.run_name=pqn_test"])
    test_returns = tester.run()
    os.chdir(root)
    if len(test_returns) != 8 or not all(math.isfinite(r) for r in test_returns):
        fail(f"PQN test mode returned {test_returns}, expected 8 finite returns")
    compared = same_tree(trained.checkpoint_tree(), tester.model.checkpoint_tree())
    print(f"runner pqn: 2 learning iterations at 8x32 on CartPole, 2 evaluations and saves, in {train_s:.2f} s; "
          f"env-steps/s {[m['time/sps'] for m in trained.metrics_history]}, launches {pqn_launches}, eval returns "
          f"{[float(r) for r in trained.eval_history['eval/episode_return']]}; test mode: {compared} tensors "
          f"restored bit for bit, returns {test_returns}")
    launches_by_path["pqn"] = pqn_launches

    # 18. discrete PPO on CartPole at the flagship rollout and update shape
    # (4096 envs x 64 steps, minibatch 32768, 4 epochs) with the PPO
    # defaults' network ((64, 64) tanh, f32): 2 iterations through B1
    config = make_config("ppo.cuda", "classic.cart_pole.cuda", **{
        "runner.device": "cuda", "environment.nr_envs": 4096, "algorithm.nr_steps": nr_steps,
        "algorithm.total_timesteps": 2 * batch, "algorithm.minibatch_size": batch // 8,
        "algorithm.nr_epochs": 4, "algorithm.evaluation_active": False,
    })
    model = create_model(config)
    zero_counts()
    t0 = time.perf_counter()
    model.train()
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    ppo_cartpole_launches = counts()
    if ppo_cartpole_launches != {"engine_substep": 0, "gae": 2, "categorical_projection": 0}:
        fail(f"discrete PPO launch counts {ppo_cartpole_launches}, expected 2 GAE")
    check_logged("discrete PPO", model.metrics_history)
    # B1 on CartPole-like inputs at this path's shape: rewards of 1, values
    # near the return, 2 % terminations
    r = torch.ones(nr_steps, 4096, device=dev)
    v, nv = (20.0 + 5.0 * torch.randn(nr_steps, 4096, device=dev, generator=g) for _ in range(2))
    d = torch.rand(nr_steps, 4096, device=dev, generator=g) < 0.02
    cartpole_gae_err = max_err(gae_advantages_cuda(r, v, nv, d, 0.99, 0.95),
                               gae_advantages_reference(r, v, nv, d, 0.99, 0.95), 1e-5, 1e-5,
                               "GAE [64, 4096] CartPole rewards")
    print(f"train: discrete PPO on CartPole, 2 iterations at 4096x{nr_steps} in {elapsed:.2f} s "
          f"({2 * batch / elapsed:.0f} env-steps/s overall, {model.metrics_history[-1]['time/sps']} in the last "
          f"iteration), launches {ppo_cartpole_launches}; B1 on CartPole rewards at [64, 4096] max|err| "
          f"{cartpole_gae_err:.3g} (rtol=atol=1e-5); last losses "
          + json.dumps({k: v for k, v in model.metrics_history[-1].items() if k.startswith("loss/")}))
    launches_by_path["ppo_cartpole"] = ppo_cartpole_launches

    # 19. masked Pendulum through the Runner at the pendulum_masked_* recipes
    # (8 envs x 256 steps, minibatch 512, 10 epochs, lr 5e-4, gamma 0.9):
    # PPO, then PPO over the observation window and over memory actions, 2
    # eval/save iterations of 1 learning iteration each
    os.chdir(workdir.name)
    for name, algorithm in (("pendulum_masked_ppo", "ppo.cuda"),
                            ("pendulum_masked_history_window", "ppo_history_window.cuda"),
                            ("pendulum_masked_memory_actions", "ppo_memory_actions.cuda")):
        runner = Runner([f"--algorithm.name={algorithm}", "--environment.name=classic.pendulum.cuda",
                         "--runner.device=cuda", *recipe(name), "--algorithm.total_timesteps=4096",
                         "--algorithm.evaluation_and_save_frequency=2048", f"--runner.run_name={name}"])
        zero_counts()
        t0 = time.perf_counter()
        model = runner.run()
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
        path_launches = counts()
        if path_launches != {"engine_substep": 0, "gae": 2, "categorical_projection": 0}:
            fail(f"{algorithm} on the masked Pendulum: launch counts {path_launches}, expected 2 GAE")
        check_logged(algorithm, model.metrics_history)
        eval_returns = [float(x) for x in model.eval_history["eval/episode_return"]]
        if len(eval_returns) != 2 or not all(math.isfinite(x) for x in eval_returns):
            fail(f"{algorithm} on the masked Pendulum: eval returns {eval_returns}")
        print(f"runner {algorithm} on the masked Pendulum (observation {model.train_env.single_observation_space.shape}, "
              f"action {model.train_env.single_action_space.shape}): 2 iterations of 8x256 and 2 evaluations in "
              f"{elapsed:.2f} s, env-steps/s {[m['time/sps'] for m in model.metrics_history]}, launches "
              f"{path_launches}, eval returns {eval_returns}")
        launches_by_path[name.replace("pendulum_masked_", "masked_pendulum_")] = path_launches
    os.chdir(root)
    # B1 at the masked-Pendulum path's shape [256, 8]: costs as rewards, no
    # terminations (Pendulum only truncates)
    r = -16.0 * torch.rand(256, 8, device=dev, generator=g)
    v, nv = (-80.0 + 10.0 * torch.randn(256, 8, device=dev, generator=g) for _ in range(2))
    d = torch.zeros(256, 8, dtype=torch.bool, device=dev)
    small_gae_err = max_err(gae_advantages_cuda(r, v, nv, d, 0.9, 0.95), gae_advantages_reference(r, v, nv, d, 0.9, 0.95),
                            1e-5, 1e-5, "GAE [256, 8]")
    t = kernel_times(lambda: gae_advantages_cuda(r, v, nv, d, 0.9, 0.95),
                     lambda: gae_advantages_reference(r, v, nv, d, 0.9, 0.95), "gae_kernel")
    t["bound_ms"], t["bound_by"] = roofline(gae_bytes(256, 8), 0)
    launch = gae_geometry(256, 8)
    print(f"B1 gae at [256, 8] (masked Pendulum): max|err| {small_gae_err:.3g} (rtol=atol=1e-5), kernel "
          f"{t['ms']:.4f} ms (device {t['device_ms']:.4f} ms, host {t['host_us']:.1f} us a call) plain "
          f"{t['plain_ms']:.3f} ms bound {t['bound_ms']:.6f} ms ({t['bound_by']}: {gae_bytes(256, 8)} bytes; "
          f"{launch.blocks} blocks of {launch.threads} threads)")
    kernels[0]["by_shape"] = {"[256, 8]": {**t, "max_abs_err": small_gae_err},
                              "[64, 4096] CartPole rewards": {"max_abs_err": cartpole_gae_err}}
    kernels[0]["max_abs_err"] = max(kernels[0]["max_abs_err"], small_gae_err, cartpole_gae_err)

    # 20. B3 at the SAC family's shapes: FlashSAC's [512, 101] over -5..5,
    # and the Pendulum recipes' [128, 101] over -800..100 (FastSAC) and
    # -300..0 (FlashSAC); the entropy term sends whole rows past v_max
    # (alpha log pi very negative) or below v_min
    def entropy_shifted_targets(n, v_lo, v_hi, gamma):
        support = torch.linspace(v_lo, v_hi, 101, device=dev)
        span = v_hi - v_lo
        r = 0.05 * span * torch.randn(n, 1, device=dev, generator=g)
        d = (torch.rand(n, 1, device=dev, generator=g) < 0.05).float()
        alpha_log_pi = 0.1 * span * torch.randn(n, 1, device=dev, generator=g)
        quarter = n // 4
        d[:2 * quarter] = 0.0
        alpha_log_pi[:quarter] = -3.0 * span                 # every position beyond v_max
        alpha_log_pi[quarter:2 * quarter] = 3.0 * span       # every position below v_min
        r[:2 * quarter] = 0.0
        return r + gamma * (1.0 - d) * (support[None] - alpha_log_pi), softmax_probs(n, 101)

    sac_shapes = {
        "[512, 101] -> 101 (FlashSAC, -5..5)": (512, -5.0, 5.0, 0.99),
        "[128, 101] -> 101 (FastSAC Pendulum, -800..100)": (128, -800.0, 100.0, 0.97),
        "[128, 101] -> 101 (FlashSAC Pendulum, -300..0)": (128, -300.0, 0.0, 0.9),
    }
    for label, (n, v_lo, v_hi, gamma) in sac_shapes.items():
        z, p = entropy_shifted_targets(n, v_lo, v_hi, gamma)
        project = lambda: categorical_projection_cuda(z, p, v_lo, v_hi, 101)
        out = project()
        ref = categorical_projection_reference(z, p, v_lo, v_hi, 101)
        torch.cuda.synchronize()
        err = max_err([out], [ref], 1e-6, 1e-6, f"projection {label}")
        if not torch.equal(out, project()):
            fail(f"projection {label}: two launches on the same input differ")
        quarter = n // 4
        if not (torch.allclose(out[:quarter, -1], torch.ones(quarter, device=dev), atol=1e-6)
                and torch.allclose(out[quarter:2 * quarter, 0], torch.ones(quarter, device=dev), atol=1e-6)):
            fail(f"projection {label}: rows beyond v_max / below v_min do not land on the end atoms")
        t = kernel_times(project, lambda: categorical_projection_reference(z, p, v_lo, v_hi, 101), "projection_kernel")
        t["bound_ms"], t["bound_by"] = roofline(projection_bytes(n, 101, 101), projection_flops(n, 101))
        b3_by_shape[label] = {**t, "max_abs_err": err}
        print(f"B3 projection at {label}: max|err| {err:.3g} (rtol=atol=1e-6), the same bits over two launches, "
              f"rows past either end on the end atoms; kernel {t['ms']:.4f} ms (device {t['device_ms']:.4f} ms, host "
              f"{t['host_us']:.1f} us a call) plain {t['plain_ms']:.3f} ms bound {t['bound_ms']:.6f} ms "
              f"({t['bound_by']}: {projection_bytes(n, 101, 101)} bytes)")
    kernels[2]["max_abs_err"] = max(kernels[2]["max_abs_err"], *(t["max_abs_err"] for t in b3_by_shape.values()))

    # 21. FastSAC on the Ant through the Runner at 1024 envs, batch 8192, its
    # default widths, learning_starts = nr_envs: 1 prefill + 32 learning
    # steps, B3 once an update and B2 once an env step; then test mode from
    # its latest.model with every tensor equal bit for bit
    def sac_family_runner(name, extra, learning_steps, log_steps, expected):
        """Train ``name`` on the Ant through ``Runner(argv).run()`` with its
        optimizer state and ``save_model``, fail unless the launch counts are
        ``expected`` and every logged value is finite, then load its
        ``latest.model`` in test mode and fail unless every tensor of the
        full state is equal bit for bit.  Returns the trained model."""
        args = [f"--algorithm.name={name}.cuda", "--environment.name=locomotion.ant.cuda", "--runner.device=cuda",
                "--environment.nr_envs=1024", "--algorithm.learning_starts=1024",
                "--algorithm.evaluation_active=False", "--runner.save_optimizer_state=True", *extra]
        os.chdir(workdir.name)
        runner = Runner([*args, f"--algorithm.total_timesteps={1024 + learning_steps * 1024}",
                         f"--algorithm.logging_frequency={log_steps * 1024}", "--runner.save_model=True",
                         f"--runner.run_name={name}"])
        zero_counts()
        t0 = time.perf_counter()
        trained = runner.run()
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        path_launches = counts()
        if path_launches != expected or trained.nr_updates != learning_steps:
            fail(f"{name}: launches {path_launches} != {expected}, {trained.nr_updates} learning steps")
        check_logged(name, trained.metrics_history, list(range(log_steps, learning_steps + 1, log_steps)))
        latest = os.path.join(workdir.name, "runs", "rlx_tpu_torch", "default", name, "models", "latest.model")
        tester = Runner([*args, f"--environment.horizon={horizon}", "--runner.mode=test",
                         f"--runner.load_model={latest}", "--runner.nr_test_episodes=4",
                         f"--runner.run_name={name}_test"])
        zero_counts()
        t0 = time.perf_counter()
        test_returns = tester.run()
        torch.cuda.synchronize()
        test_s = time.perf_counter() - t0
        test_launches = counts()
        os.chdir(root)
        if len(test_returns) != 4 or not all(math.isfinite(r) for r in test_returns):
            fail(f"{name} test mode returned {test_returns}, expected 4 finite returns")
        if not 0 < test_launches["engine_substep"] <= horizon or test_launches["categorical_projection"]:
            fail(f"{name} test mode launches {test_launches}, expected 1 to {horizon} B2 and no B3")
        tree = trained.checkpoint_tree()
        if set(tree) != {"full"} or tree["full"]["nr_updates"] != learning_steps:
            fail(f"{name} checkpoint tree {sorted(tree)} without the full state")
        compared = same_tree(tree, tester.model.checkpoint_tree())
        print(f"runner {name}: 1 prefill + {learning_steps} learning steps at 1024 envs in {train_s:.2f} s; env-steps/s "
              f"of the log lines (the first includes the prefill) {[m['time/sps'] for m in trained.metrics_history]}, "
              f"launches {path_launches}, last log line "
              + json.dumps({k: v for k, v in trained.metrics_history[-1].items()
                            if k.startswith(("loss/", "q_value/", "entropy/"))})
              + f"; {compared} tensors of the full state and the update count restored bit for bit, checkpoint "
              f"{os.path.getsize(latest) / 2**20:.2f} MiB; test mode at horizon {horizon}: {test_s:.2f} s, launches "
              f"{test_launches}, returns {[round(r, 2) for r in test_returns]}")
        launches_by_path[name] = path_launches
        launches_by_path[f"{name}_test"] = test_launches
        return trained

    sac_family_runner("fastsac", ["--algorithm.batch_size=8192"], 32, 16,
                      {"engine_substep": 33, "gae": 0, "categorical_projection": 32})

    # 22. FlashSAC on the Ant at its defaults (policy 128 x 2 blocks, critic
    # 256 x 2 blocks, expansion 4, batch 512, reward normalization on): 32
    # learning steps, the policy stepping on every second one, the projection
    # holding after the last; test mode from latest.model; then 16 more steps
    # under the profiler
    from rlx_tpu_torch.algorithms.flashsac.cuda.layers import BatchNorm, RMSNorm

    flash = sac_family_runner("flashsac", [], 32, 16, {"engine_substep": 33, "gae": 0, "categorical_projection": 32})
    if flash.policy.step_count() != 16 or flash.critic.step_count() != 32:
        fail(f"FlashSAC: policy Adam count {flash.policy.step_count()} (expected 16), critic "
             f"{flash.critic.step_count()} (expected 32)")
    worst = 0.0
    for module in (flash.policy.module, flash.critic.module):
        for name, param in module.named_parameters():
            if name.endswith(("linear1.weight", "linear2.weight", "linear.weight", "head.weight",
                              "mean_weight", "std_weight")):
                worst = max(worst, (torch.linalg.vector_norm(param, dim=-1) - 1.0).abs().max().item())
        for m in module.modules():
            if isinstance(m, (BatchNorm, RMSNorm)):
                d = m.weight.shape[-1]
                sq = (m.weight ** 2).sum(-1) + ((m.bias ** 2).sum(-1) if isinstance(m, BatchNorm) else 0.0)
                worst = max(worst, (torch.sqrt(sq) / math.sqrt(d) - 1.0).abs().max().item())
    if worst > 1e-5:
        fail(f"FlashSAC: a projected norm is off by {worst:.3g} relative after the last step")
    stats_moved = all(not torch.equal(m.var, torch.ones_like(m.var)) for net in (flash.policy.module, flash.critic.module,
                      flash.critic.target) for m in net.modules() if isinstance(m, BatchNorm))
    if not stats_moved:
        fail("FlashSAC: a BatchNorm's running variance never moved")
    print(f"flashsac projection after 32 steps: unit kernels and sqrt(d) norm scales within {worst:.3g} (limit 1e-5); "
          f"policy Adam count {flash.policy.step_count()}, critic {flash.critic.step_count()}; the three BatchNorm "
          f"streams moved")

    def flash_logging_iteration():
        flash.env_state, _ = flash._logging_iteration(flash.env_state, flash.initial_step(32), 32)

    print("profile flashsac: " + json.dumps(profile_spans(flash_logging_iteration, "flashsac/")))
    del flash

    # 23. REDQ, DroQ, AQE, TQC, SimBa, XQC, SimbaV2 and CrossQ on the Ant at
    # their defaults, learning_starts = nr_envs: 16 learning steps each, B2
    # once an env step, no B3; REDQ's 16 steps profiled (20 critic updates
    # each)
    for name in ("redq", "droq", "aqe", "tqc", "simba", "xqc", "simbav2", "crossq"):
        config = make_config(f"{name}.cuda", "locomotion.ant.cuda", **{
            "runner.device": "cuda", "environment.nr_envs": 1024, "algorithm.learning_starts": 1024,
            "algorithm.total_timesteps": 1024 + 16 * 1024, "algorithm.logging_frequency": 8 * 1024,
            "algorithm.evaluation_active": False,
        })
        model = create_model(config)
        zero_counts()
        t0 = time.perf_counter()
        model.train()
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
        path_launches = counts()
        if path_launches != {"engine_substep": 17, "gae": 0, "categorical_projection": 0} or model.nr_updates != 16:
            fail(f"{name}: launches {path_launches}, {model.nr_updates} learning steps")
        check_logged(name, model.metrics_history, [8, 16])
        a = config.algorithm
        print(f"train: {name} 1 prefill + 16 learning steps at 1024 envs, batch {a.batch_size}, "
              f"{a.get('q_update_steps', 1)} critic updates a step, in {elapsed:.2f} s; env-steps/s of the 2 log lines "
              f"(the first includes the prefill) {[m['time/sps'] for m in model.metrics_history]}, launches "
              f"{path_launches}, last log line "
              + json.dumps({k: v for k, v in model.metrics_history[-1].items() if k.startswith(("loss/", "q_value/"))}))
        launches_by_path[name] = path_launches
        if name == "redq":
            def redq_logging_iteration():
                model.env_state, _ = model._logging_iteration(model.env_state, model.initial_step(16), 16)

            print("profile redq: " + json.dumps(profile_spans(redq_logging_iteration, "redq/")))
        del model

    # 24. ESPO and PPO-DTRL on the Ant at the flagship shape (4096 envs x 64
    # steps, 512/256/128 ELU+LayerNorm, bf16 trunk): 2 iterations each, one
    # GAE launch an iteration and one substep launch an env step.  Their
    # configs have no compute_dtype key, so the trunks are set to bf16 on
    # the nets, as the key does for PPO.  ESPO takes its full-batch epochs
    # at its default nr_epochs (10); PPO-DTRL minibatch batch / 8, 4 epochs
    variants = {"espo": {}, "ppo_dtrl": {"algorithm.minibatch_size": batch // 8, "algorithm.nr_epochs": 4}}
    for name, extra in variants.items():
        config = make_config(f"{name}.cuda", "locomotion.ant.cuda", **{
            "runner.device": "cuda", "environment.nr_envs": 4096, "algorithm.nr_steps": nr_steps,
            "algorithm.total_timesteps": 2 * batch, "algorithm.policy_hidden_sizes": (512, 256, 128),
            "algorithm.critic_hidden_sizes": (512, 256, 128), "algorithm.activation": "elu",
            "algorithm.layer_norm": True, "algorithm.evaluation_active": False, **extra,
        })
        model = create_model(config)
        model.policy.module.trunk.compute_dtype = model.critic.trunk.compute_dtype = torch.bfloat16
        zero_counts()
        t0 = time.perf_counter()
        model.train()
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
        path_launches = counts()
        expected = {"engine_substep": 2 * nr_steps, "gae": 2, "categorical_projection": 0}
        if path_launches != expected:
            fail(f"{name}: launch counts {path_launches} != {expected}")
        check_logged(name, model.metrics_history)
        last = model.metrics_history[-1]
        if name == "espo":
            active = [m["policy_ratio/nr_active_epochs"] for m in model.metrics_history]
            if not all(1.0 <= a <= config.algorithm.nr_epochs for a in active):
                fail(f"ESPO active epochs {active} outside [1, {config.algorithm.nr_epochs}]")
            detail = f"active epochs {active} of {config.algorithm.nr_epochs}"
        else:
            # the projection puts every state on its bound or inside it; the
            # Newton solve for eta stops at 15 steps: 1e-3 relative
            a = config.algorithm
            for m in model.metrics_history:
                if (m["projection/projected_kl_mean"] > a.mean_bound * (1 + 1e-3)
                        or m["projection/projected_kl_cov"] > a.cov_bound * (1 + 1e-3)):
                    fail(f"PPO-DTRL projected KL {m['projection/projected_kl_mean']}, "
                         f"{m['projection/projected_kl_cov']} beyond the bounds {a.mean_bound}, {a.cov_bound}")
            detail = ("projected KL mean/cov " + json.dumps({k.split("/")[1]: v for k, v in last.items()
                                                            if k.startswith("projection/")}))
        print(f"train: {name} on the Ant, 2 iterations at 4096x{nr_steps} (bf16 trunk) in {elapsed:.2f} s "
              f"({2 * batch / elapsed:.0f} env-steps/s overall, {last['time/sps']} in the last iteration), launches "
              f"{path_launches}, {detail}, last losses "
              + json.dumps({k: v for k, v in last.items() if k.startswith("loss/")}))
        launches_by_path[name] = path_launches
        if name == "ppo_dtrl":
            def dtrl_iteration():
                model.env_state, _ = model.learning_iteration(model.env_state)

            # the device's events alone: the host spans of its 15 Newton
            # steps a minibatch took ~40 s of parsing
            print("profile ppo_dtrl: " + json.dumps(device_idle(dtrl_iteration, "ppo/")))
        del model

    # 25. BRO, MPO and FastMPO on the Ant at 1024 envs at their defaults,
    # evaluation off, 16 learning steps each.  BRO (learning_starts =
    # nr_envs: 1 prefill step) through the Runner with its optimizer state
    # and init_copy, reloaded bit for bit in test mode; its reset falls on
    # learning step 15000 // 1024 = 14.  MPO with learning_starts = nr_envs
    # (1 prefill step); FastMPO's prefill is learning_starts_per_env = 10
    # steps.  B2 once an env step: 17, 17, 26; no B1, no B3
    bro = sac_family_runner("bro", [], 16, 8,
                            {"engine_substep": 17, "gae": 0, "categorical_projection": 0})
    if [m["bro/reset"] for m in bro.metrics_history] != [0.0, 1.0 / 8]:
        fail(f"BRO resets {[m['bro/reset'] for m in bro.metrics_history]}: expected one, at learning step 14")

    def bro_logging_iteration():
        bro.env_state, _ = bro._logging_iteration(bro.env_state, bro.initial_step(16), 16)

    print("profile bro: " + json.dumps(profile_spans(bro_logging_iteration, "bro/")))
    del bro
    for name, overrides, prefill in (("mpo", {"algorithm.learning_starts": 1024}, 1), ("fastmpo", {}, 10)):
        config = make_config(f"{name}.cuda", "locomotion.ant.cuda", **{
            "runner.device": "cuda", "environment.nr_envs": 1024, "algorithm.total_timesteps": (prefill + 16) * 1024,
            "algorithm.logging_frequency": 8 * 1024, "algorithm.evaluation_active": False, **overrides,
        })
        model = create_model(config)
        zero_counts()
        t0 = time.perf_counter()
        model.train()
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
        path_launches = counts()
        expected = {"engine_substep": prefill + 16, "gae": 0, "categorical_projection": 0}
        if path_launches != expected or model.nr_updates != 16 or model.prefill_iterations != prefill:
            fail(f"{name}: launches {path_launches} != {expected}, {model.nr_updates} learning steps, "
                 f"{model.prefill_iterations} prefill steps")
        check_logged(name, model.metrics_history, [8, 16])
        print(f"train: {name} {prefill} prefill + 16 learning steps at 1024 envs, batch {config.algorithm.batch_size}, "
              f"in {elapsed:.2f} s; env-steps/s of the 2 log lines (the first includes the prefill) "
              f"{[m['time/sps'] for m in model.metrics_history]}, launches {path_launches}, last log line "
              + json.dumps({k: v for k, v in model.metrics_history[-1].items()
                            if k.startswith(("loss/", "q_value/", "dual/"))}))
        launches_by_path[name] = path_launches
        del model

    # 26. REPPO on the Ant at its defaults (4096 envs x 128 steps, 512-wide
    # nets, 4 epochs of 8 minibatches): 2 iterations, one substep launch an
    # env step and no GAE (its TD(lambda) loop is plain torch); then through
    # the Runner: 1 iteration, an evaluation and a save at horizon 200, and
    # test mode from latest.model with every tensor equal bit for bit
    reppo_steps = 128
    config = make_config("reppo.cuda", "locomotion.ant.cuda", **{
        "runner.device": "cuda", "environment.nr_envs": 4096, "algorithm.total_timesteps": 2 * 4096 * reppo_steps,
        "algorithm.evaluation_active": False,
    })
    model = create_model(config)
    zero_counts()
    t0 = time.perf_counter()
    model.train()
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    reppo_launches = counts()
    if reppo_launches != {"engine_substep": 2 * reppo_steps, "gae": 0, "categorical_projection": 0}:
        fail(f"REPPO launch counts {reppo_launches}, expected {2 * reppo_steps} substep launches only")
    check_logged("reppo", model.metrics_history)
    print(f"train: reppo on the Ant, 2 iterations at 4096x{reppo_steps} in {elapsed:.2f} s "
          f"({2 * 4096 * reppo_steps / elapsed:.0f} env-steps/s overall, {model.metrics_history[-1]['time/sps']} in "
          f"the last iteration), launches {reppo_launches}, last log line "
          + json.dumps({k: v for k, v in model.metrics_history[-1].items()
                        if k.startswith(("loss/", "kl/", "q_value/"))}))
    launches_by_path["reppo"] = reppo_launches

    del model
    reppo_args = ["--algorithm.name=reppo.cuda", "--environment.name=locomotion.ant.cuda", "--runner.device=cuda",
                  f"--environment.horizon={horizon}"]
    os.chdir(workdir.name)
    runner = Runner([*reppo_args, f"--algorithm.total_timesteps={4096 * reppo_steps}", "--runner.save_model=True",
                     "--runner.run_name=reppo"])
    zero_counts()
    t0 = time.perf_counter()
    trained = runner.run()
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    runner_launches = counts()
    expected = {"engine_substep": reppo_steps + horizon, "gae": 0, "categorical_projection": 0}
    if runner_launches != expected:
        fail(f"REPPO runner launch counts {runner_launches} != {expected}")
    eval_returns = [float(r) for r in trained.eval_history["eval/episode_return"]]
    if len(eval_returns) != 1 or not math.isfinite(eval_returns[0]):
        fail(f"REPPO eval returns {eval_returns}")
    reppo_latest = os.path.join(workdir.name, "runs", "rlx_tpu_torch", "default", "reppo", "models", "latest.model")
    tester = Runner([*reppo_args, "--runner.mode=test", f"--runner.load_model={reppo_latest}",
                     "--runner.nr_test_episodes=10", "--runner.run_name=reppo_test"])
    zero_counts()
    t0 = time.perf_counter()
    test_returns = tester.run()
    torch.cuda.synchronize()
    test_s = time.perf_counter() - t0
    test_launches = counts()
    os.chdir(root)
    if len(test_returns) != 10 or not all(math.isfinite(r) for r in test_returns):
        fail(f"REPPO test mode returned {test_returns}, expected 10 finite returns")
    if not 0 < test_launches["engine_substep"] <= horizon or test_launches["gae"]:
        fail(f"REPPO test mode launches {test_launches}, expected 1 to {horizon} B2 and no B1")
    compared = same_tree(trained.checkpoint_tree(), tester.model.checkpoint_tree())
    print(f"runner reppo: 1 learning iteration at 4096x{reppo_steps}, an evaluation at horizon {horizon} and a save "
          f"in {train_s:.2f} s, launches {runner_launches}, eval return {eval_returns[0]:.2f}, checkpoint "
          f"{os.path.getsize(reppo_latest) / 2**20:.2f} MiB; test mode {test_s:.2f} s (load included), launches "
          f"{test_launches}, {compared} tensors (both nets and the normalizer) restored bit for bit, returns "
          f"{[round(r, 2) for r in test_returns]}")
    launches_by_path["reppo_runner"] = runner_launches
    launches_by_path["reppo_test"] = test_launches
    del trained, tester

    # 27. the recurrent PPO family on the Ant at the JAX package's recurrent
    # shape (benchmarks/curves.py locomotion_lstm: 4096 envs x 32 steps, 4
    # minibatches of 1024 envs with the time axis intact, 4 epochs; LSTM
    # and GRU 128 wide, obs encoding 128, Mamba-2 state 16 and conv 4, the
    # transformer 16 tokens, 4 heads, 2 blocks; critic 512/256/128
    # ELU+LayerNorm, f32): 1 iteration each (eager: phase 49 holds the
    # replayed one against it), one GAE launch and one substep launch an env
    # step.  The horizon is cut to 20 so that
    # every env resets inside each 32-step window; then the policy's
    # sequence re-run over a fresh window (1024 envs, the resets inside)
    # from its start carry must give the rollout's own log-probabilities
    from rlx_tpu_torch.models import distributions as D
    from rlx_tpu_torch.models.recurrent import map_carry

    rec_steps = 32
    rec_batch = 4096 * rec_steps
    recurrent_shape = {"environment.nr_envs": 4096, "algorithm.nr_steps": rec_steps, "algorithm.nr_minibatches": 4,
                       "algorithm.nr_epochs": 4}
    for name in ("ppo_lstm", "ppo_gru", "ppo_mamba2", "ppo_transformer"):
        width = {"algorithm.rnn_hidden_dim": 128} if name in ("ppo_lstm", "ppo_gru") else {}
        config = make_config(f"{name}.cuda", "locomotion.ant.cuda", **{
            "runner.device": "cuda", **recurrent_shape, **width, "environment.horizon": 20,
            "algorithm.total_timesteps": rec_batch, "algorithm.evaluation_active": False,
        })
        model = create_model(config)
        zero_counts()
        t0 = time.perf_counter()
        model.train()
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
        path_launches = counts()
        expected = {"engine_substep": rec_steps, "gae": 1, "categorical_projection": 0}
        if path_launches != expected:
            fail(f"{name}: launch counts {path_launches} != {expected}")
        check_logged(name, model.metrics_history, [16])
        launches_by_path[name] = path_launches
        # the carry check, after the counts were read
        with torch.no_grad():
            init_carry = model.policy_carry
            model.env_state, model.policy_carry, batch, _ = model._rollout(model.env_state, init_carry)
            observations, _, actions, _, _, dones, log_probs = batch
            mb = slice(0, 1024)
            mean_seq, logstd_seq = model.policy.sequence(observations[:, mb], dones[:, mb],
                                                         map_carry(lambda c: c[mb], init_carry))
            rerun = D.gaussian_log_prob(mean_seq, logstd_seq, actions[:, mb])
        carry_err = max_err([rerun], [log_probs[:, mb]], 1e-4, 1e-4, f"{name}: sequence re-run log-probs")
        nr_dones = int(dones[:, mb].sum())
        if nr_dones < 1024:
            fail(f"{name}: {nr_dones} dones in the checked window, expected every env to reset")
        print(f"train: {name} on the Ant, 1 iteration at 4096x{rec_steps} in {elapsed:.2f} s "
              f"({rec_batch / elapsed:.0f} env-steps/s overall), env-steps/s a iteration "
              f"{[m['time/sps'] for m in model.metrics_history]}, launches {path_launches}, sequence re-run of "
              f"{rec_steps}x1024 with {nr_dones} resets inside: log-prob max|err| {carry_err:.3g} (rtol=atol=1e-4), "
              "last losses " + json.dumps({k: v for k, v in model.metrics_history[-1].items()
                                           if k.startswith("loss/")}))
        del model, batch, init_carry

    # PPO-LSTM through the Runner: 1 iteration, an evaluation and a save at
    # horizon 200, then test mode from latest.model, every tensor equal bit
    # for bit
    lstm_args = ["--algorithm.name=ppo_lstm.cuda", "--environment.name=locomotion.ant.cuda", "--runner.device=cuda",
                 f"--environment.horizon={horizon}", "--environment.nr_envs=4096", f"--algorithm.nr_steps={rec_steps}",
                 "--algorithm.nr_minibatches=4", "--algorithm.nr_epochs=4", "--algorithm.rnn_hidden_dim=128"]
    os.chdir(workdir.name)
    runner = Runner([*lstm_args, f"--algorithm.total_timesteps={rec_batch}", "--runner.save_model=True",
                     "--runner.run_name=ppo_lstm"])
    zero_counts()
    t0 = time.perf_counter()
    trained = runner.run()
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    runner_launches = counts()
    expected = {"engine_substep": rec_steps + horizon, "gae": 1, "categorical_projection": 0}
    if runner_launches != expected:
        fail(f"PPO-LSTM runner launch counts {runner_launches} != {expected}")
    eval_returns = [float(r) for r in trained.eval_history["eval/episode_return"]]
    if len(eval_returns) != 1 or not math.isfinite(eval_returns[0]):
        fail(f"PPO-LSTM eval returns {eval_returns}")
    lstm_latest = os.path.join(workdir.name, "runs", "rlx_tpu_torch", "default", "ppo_lstm", "models", "latest.model")
    tester = Runner([*lstm_args, "--runner.mode=test", f"--runner.load_model={lstm_latest}",
                     "--runner.nr_test_episodes=10", "--runner.run_name=ppo_lstm_test"])
    zero_counts()
    t0 = time.perf_counter()
    test_returns = tester.run()
    torch.cuda.synchronize()
    test_s = time.perf_counter() - t0
    test_launches = counts()
    os.chdir(root)
    if len(test_returns) != 10 or not all(math.isfinite(r) for r in test_returns):
        fail(f"PPO-LSTM test mode returned {test_returns}, expected 10 finite returns")
    if not 0 < test_launches["engine_substep"] <= horizon or test_launches["gae"]:
        fail(f"PPO-LSTM test mode launches {test_launches}, expected 1 to {horizon} B2 and no B1")
    compared = same_tree(trained.checkpoint_tree(), tester.model.checkpoint_tree())
    print(f"runner ppo_lstm: 1 learning iteration at 4096x{rec_steps}, an evaluation at horizon {horizon} and a save "
          f"in {train_s:.2f} s, launches {runner_launches}, eval return {eval_returns[0]:.3g}, checkpoint "
          f"{os.path.getsize(lstm_latest) / 2**20:.2f} MiB; test mode {test_s:.2f} s (load included), launches "
          f"{test_launches}, {compared} tensors restored bit for bit, returns {[f'{r:.3g}' for r in test_returns]}")
    launches_by_path["ppo_lstm_runner"] = runner_launches
    launches_by_path["ppo_lstm_test"] = test_launches
    del trained, tester

    # B1 at the recurrent path's shape [32, 4096] and a ragged [32, 4097]:
    # Ant-like rewards in [0, 1], values near their return, 2 % terminations
    rec_gae = {}
    for B in (4096, 4097):
        r = torch.rand(rec_steps, B, device=dev, generator=g)
        v, nv = (10.0 + 2.0 * torch.randn(rec_steps, B, device=dev, generator=g) for _ in range(2))
        d = torch.rand(rec_steps, B, device=dev, generator=g) < 0.02
        rec_gae[B] = (r, v, nv, d)
    rec_gae_err = max(max_err(gae_advantages_cuda(*a, 0.99, 0.95), gae_advantages_reference(*a, 0.99, 0.95),
                              1e-5, 1e-5, f"GAE [{rec_steps}, {B}]") for B, a in rec_gae.items())
    a = rec_gae[4096]
    t = kernel_times(lambda: gae_advantages_cuda(*a, 0.99, 0.95), lambda: gae_advantages_reference(*a, 0.99, 0.95),
                     "gae_kernel")
    t["bound_ms"], t["bound_by"] = roofline(gae_bytes(rec_steps, 4096), 0)
    print(f"B1 gae at [{rec_steps}, 4096] and [{rec_steps}, 4097] (recurrent PPO): max|err| {rec_gae_err:.3g} "
          f"(rtol=atol=1e-5), kernel {t['ms']:.4f} ms (device {t['device_ms']:.4f} ms, host {t['host_us']:.1f} us a "
          f"call) plain {t['plain_ms']:.3f} ms bound {t['bound_ms']:.6f} ms ({t['bound_by']}: "
          f"{gae_bytes(rec_steps, 4096)} bytes)")
    kernels[0]["by_shape"][f"[{rec_steps}, 4096]"] = {**t, "max_abs_err": rec_gae_err}
    kernels[0]["max_abs_err"] = max(kernels[0]["max_abs_err"], rec_gae_err)

    # 28. robot locomotion (locomotion.robot.cuda, the quadruped) at the
    # JAX package's locomotion_lstm shape (4096 envs x 32 steps, 4
    # minibatches, 4 epochs, LSTM 128; its default randomization and
    # curriculum): 2 PPO-LSTM iterations on the plane, B2 once an env step
    # (the second iteration a replay of the captured one: the counters count
    # a replay's launches, so the expectations are the eager loop's).  The
    # default heightfield, its eager physics a control step and the 50M-step
    # locomotion_lstm projection are phase 50's
    from rlx_tpu_torch.environments.locomotion.robot.cuda.environment import LocomotionEnv
    from rlx_tpu_torch.environments.locomotion.soccer.cuda.environment import SoccerEnv

    robot_phases_t0 = time.perf_counter()
    loco_shape = {"environment.nr_envs": 4096, "algorithm.nr_steps": rec_steps, "algorithm.nr_minibatches": 4,
                  "algorithm.nr_epochs": 4, "algorithm.rnn_hidden_dim": 128, "algorithm.learning_rate": 3e-4,
                  "algorithm.evaluation_active": False}

    def recurrent_path(path, env_name, expected, overrides=(), iterations=2):
        config = make_config("ppo_lstm.cuda", env_name, **{
            "runner.device": "cuda", **loco_shape, **dict(overrides),
            "algorithm.total_timesteps": iterations * rec_batch,
        })
        model = create_model(config)
        captured, reason = capture_choice(model)
        if not captured:
            fail(f"{path}: train() does not replay a captured iteration: {reason}")
        zero_counts()
        t0 = time.perf_counter()
        model.train()
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
        path_launches = counts()
        if path_launches != expected:
            fail(f"{path}: launch counts {path_launches} != {expected}")
        check_logged(path, model.metrics_history, [16, 32][:iterations])
        launches_by_path[path] = path_launches
        sps = [m["time/sps"] for m in model.metrics_history]
        tracking = model.env_state.info["rollout/episode_tracking"]
        print(f"train: {path}, {iterations} PPO-LSTM iterations at 4096x{rec_steps} in {elapsed:.2f} s, env-steps/s a "
              f"iteration {sps}, launches {path_launches}, observation {tuple(model.env_state.observation.shape)} "
              f"(policy reads {len(model.train_env.policy_observation_indices)}, critic "
              f"{len(model.train_env.critic_observation_indices)}), rollout/episode_tracking mean "
              f"{float(tracking.mean()):.4f}, last losses "
              + json.dumps({k: v for k, v in model.metrics_history[-1].items() if k.startswith("loss/")}))
        return model

    recurrent_path("robot_lstm_plane", "locomotion.robot.cuda",
                   {"engine_substep": 2 * rec_steps, "gae": 2, "categorical_projection": 0},
                   {"environment.terrain.type": "plane"})

    # 29. B2 against engine.step_reference at the robots' shapes: the
    # quadruped (plane) and the Booster T1 (soccer) at B=4096, with the env's
    # own DomainParams and delayed targets (robot_substep_check)
    robot_substep_check(kernels, "quadruped", LocomotionEnv, "locomotion.robot.cuda",
                        {"environment.terrain.type": "plane"}, g)
    robot_substep_check(kernels, "booster_t1", SoccerEnv, "locomotion.soccer.cuda", {}, g)

    # 30. feedforward PPO at the JAX package's locomotion_ppo widths (4096
    # envs, minibatch 32768, 4 epochs, lr 3e-4; its 32 steps cut to 8, one
    # minibatch an epoch) on the default heightfield: 1 iteration (a train()
    # call's first, eager on the capture stream; phase 50 replays this
    # shape), B1 once, B2 never
    ppo_steps = 8
    config = make_config("ppo.cuda", "locomotion.robot.cuda", **{
        "runner.device": "cuda", "environment.nr_envs": 4096, "algorithm.nr_steps": ppo_steps,
        "algorithm.minibatch_size": 32768, "algorithm.nr_epochs": 4, "algorithm.learning_rate": 3e-4,
        "algorithm.total_timesteps": 4096 * ppo_steps, "algorithm.evaluation_active": False,
    })
    model = create_model(config)
    zero_counts()
    t0 = time.perf_counter()
    model.train()
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    path_launches = counts()
    if path_launches != {"engine_substep": 0, "gae": 1, "categorical_projection": 0}:
        fail(f"robot_ppo: launch counts {path_launches}")
    check_logged("robot_ppo", model.metrics_history)
    launches_by_path["robot_ppo"] = path_launches
    print(f"train: robot_ppo, 1 PPO iteration at 4096x{ppo_steps} on the heightfield in {elapsed:.2f} s, "
          f"env-steps/s {[m['time/sps'] for m in model.metrics_history]}, launches {path_launches}")
    del model

    # 31. soccer (locomotion.soccer.cuda: the Booster T1 on the plane) at the
    # JAX package's soccer_lstm shape: 1 PPO-LSTM iteration (cut from 2:
    # phase 50 replays soccer at this shape against eager, phase 44 replays
    # it through train() at 1024 envs), B2 once an env step; then through
    # the Runner: 1 iteration, an
    # evaluation and a save with the episode cut to 1 s (50 steps), then
    # test mode from latest.model, every tensor equal bit for bit
    recurrent_path("soccer_lstm", "locomotion.soccer.cuda",
                   {"engine_substep": rec_steps, "gae": 1, "categorical_projection": 0}, iterations=1)
    soccer_horizon = 50
    soccer_args = ["--algorithm.name=ppo_lstm.cuda", "--environment.name=locomotion.soccer.cuda",
                   "--runner.device=cuda", "--environment.episode_length_in_seconds=1", "--environment.nr_envs=4096",
                   f"--algorithm.nr_steps={rec_steps}", "--algorithm.nr_minibatches=4", "--algorithm.nr_epochs=4",
                   "--algorithm.rnn_hidden_dim=128"]
    os.chdir(workdir.name)
    runner = Runner([*soccer_args, f"--algorithm.total_timesteps={rec_batch}", "--runner.save_model=True",
                     "--runner.run_name=soccer_lstm"])
    zero_counts()
    t0 = time.perf_counter()
    trained = runner.run()
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    runner_launches = counts()
    expected = {"engine_substep": rec_steps + soccer_horizon, "gae": 1, "categorical_projection": 0}
    if runner_launches != expected:
        fail(f"soccer runner launch counts {runner_launches} != {expected}")
    tracking = [float(r) for r in trained.eval_history["eval/episode_tracking"]]
    if len(tracking) != 1 or not 0.0 <= tracking[0] <= 1.0:
        fail(f"soccer eval tracking {tracking}")
    soccer_latest = os.path.join(workdir.name, "runs", "rlx_tpu_torch", "default", "soccer_lstm", "models",
                                 "latest.model")
    tester = Runner([*soccer_args, "--runner.mode=test", f"--runner.load_model={soccer_latest}",
                     "--runner.nr_test_episodes=10", "--runner.run_name=soccer_lstm_test"])
    zero_counts()
    t0 = time.perf_counter()
    test_returns = tester.run()
    torch.cuda.synchronize()
    test_s = time.perf_counter() - t0
    test_launches = counts()
    os.chdir(root)
    if len(test_returns) != 10 or not all(math.isfinite(r) for r in test_returns):
        fail(f"soccer test mode returned {test_returns}, expected 10 finite returns")
    if not 0 < test_launches["engine_substep"] <= soccer_horizon or test_launches["gae"]:
        fail(f"soccer test mode launches {test_launches}, expected 1 to {soccer_horizon} B2 and no B1")
    compared = same_tree(trained.checkpoint_tree(), tester.model.checkpoint_tree())
    print(f"runner soccer_lstm: 1 learning iteration at 4096x{rec_steps}, an evaluation at horizon {soccer_horizon} "
          f"and a save in {train_s:.2f} s, launches {runner_launches}, eval episode tracking {tracking[0]:.4f}; "
          f"test mode {test_s:.2f} s (load included), launches {test_launches}, {compared} tensors restored bit for "
          f"bit, returns {[f'{r:.3g}' for r in test_returns]}")
    launches_by_path["soccer_runner"] = runner_launches
    launches_by_path["soccer_test"] = test_launches
    del trained, tester
    print(f"phases 28-31 took {time.perf_counter() - robot_phases_t0:.1f} s")

    # 32. the pixel envs on the card against the CPU: 128 envs, 64 steps of
    # the same actions from the same draws (the card's initial states handed
    # to the CPU env), equal exactly; no kernel on these envs
    from rlx_tpu_torch.environments.classic.pixel_chase.cuda.environment import PixelChase
    from rlx_tpu_torch.environments.classic.pixel_grid.cuda.environment import PixelGrid

    pixel_envs, pixel_steps = 128, 64
    pixel_phases_t0 = time.perf_counter()
    for env_cls in (PixelGrid, PixelChase):
        draws = []

        class Recording(env_cls):
            def initial_physics(self, generator, eval_mode):
                draws.append(super().initial_physics(generator, eval_mode))
                return draws[-1]

        class Replaying(env_cls):
            def initial_physics(self, generator, eval_mode):
                return type(draws[0])(*(t.cpu() for t in draws.pop(0)))

        card_env, cpu_env = Recording(pixel_envs, 16, device=dev), Replaying(pixel_envs, 16, device="cpu")
        zero_counts()
        t0 = time.perf_counter()
        state, ref = card_env.reset(0), cpu_env.reset(0)
        actions = torch.randint(0, 4, (pixel_steps, pixel_envs), generator=torch.Generator().manual_seed(5),
                                dtype=torch.int32)
        dones = 0
        for t in range(pixel_steps):
            state, ref = card_env.step(state, actions[t].to(dev)), cpu_env.step(ref, actions[t])
            for field in ("observation", "final_observation", "reward", "terminated", "truncated"):
                if not torch.equal(getattr(state, field).cpu(), getattr(ref, field)):
                    fail(f"{env_cls.__name__} step {t}: {field} on the card differs from the CPU")
            if not all(torch.equal(a.cpu(), b) for a, b in zip(state.physics, ref.physics)):
                fail(f"{env_cls.__name__} step {t}: physics (frame stack) on the card differs from the CPU")
            dones += int((ref.terminated | ref.truncated).sum())
        torch.cuda.synchronize()
        path_launches = counts()
        if any(path_launches.values()) or draws:
            fail(f"{env_cls.__name__}: launches {path_launches}, {len(draws)} draws left")
        launches_by_path[env_cls.__name__] = path_launches
        physics = {name: str(t.dtype).replace("torch.", "") for name, t in zip(state.physics._fields, state.physics)}
        print(f"env {env_cls.__name__}: {pixel_steps} steps of {pixel_envs} envs on the card equal to the CPU "
              f"exactly (observations {tuple(state.observation.shape)} {state.observation.dtype}, physics "
              f"{physics}, {dones} episode ends) in {time.perf_counter() - t0:.2f} s, launches {path_launches}")

    # 33. NatureCNN on the card against the CPU: the four image nets at batch
    # 256 on 84x84x4 uint8 frames, the same parameters (seeded), outputs and
    # every parameter's gradient; cuDNN and the products in f32 (TF32 off):
    # rtol 1e-4, atol 1e-5 (f32 sums in another order)
    from rlx_tpu_torch.models.mlp import CategoricalPolicy, DiscreteQNet, GaussianPolicy, VCritic

    image = (84, 84, 4)
    torch.manual_seed(0)
    image_nets = {
        "DiscreteQNet (C51, 51 atoms)": DiscreteQNet(None, 4, (512,), output_dim_per_action=51, image_shape=image),
        "GaussianPolicy": GaussianPolicy(None, 3, (64,), image_shape=image),
        "CategoricalPolicy": CategoricalPolicy(None, 4, (64,), image_shape=image),
        "VCritic": VCritic(None, (64,), image_shape=image),
    }
    frames = torch.randint(0, 256, (256,) + image, dtype=torch.uint8, generator=torch.Generator().manual_seed(6))
    cnn_err = {}
    for name, net in image_nets.items():
        outs = {}
        for device in ("cpu", dev):
            net.zero_grad(set_to_none=True)
            net.to(device)
            out = net(frames.to(device))
            if isinstance(out, tuple):    # the Gaussian policy's (mean, logstd)
                out = torch.cat([o.reshape(-1) for o in out])
            out.square().mean().backward()
            outs[str(device)] = [t.detach().cpu() for t in (out, *(p.grad for p in net.parameters()))]
        cnn_err[name] = max_err(outs[str(dev)], outs["cpu"], 1e-4, 1e-5, f"{name} on the card")
    conv = image_nets["VCritic"].trunk.to(dev)
    x = frames.to(dev)
    cnn_ms = time_ms(lambda: conv(x), 20)
    print(f"NatureCNN on the card against the CPU at batch 256 (outputs and every gradient, rtol=1e-4 "
          f"atol=1e-5): max|err| {json.dumps(cnn_err)}; the trunk's forward {cnn_ms:.3f} ms at batch 256")
    del image_nets, outs, conv, x

    # 34. DQN at bench_conv's shape (bench.py:252): 128 envs on pixel_chase
    # (84x84x4), batch 256, a 8192-transition uint8 replay, one update a
    # vector step; a warm-up train() of 1 prefill + 256 learning steps, then a
    # timed one, then 64 steps profiled
    conv_envs, conv_steps = 128, 256
    config = make_config("dqn.cuda", "classic.pixel_chase.cuda", **{
        "runner.device": "cuda", "environment.nr_envs": conv_envs,
        "algorithm.total_timesteps": conv_envs + conv_steps * conv_envs, "algorithm.learning_starts": conv_envs,
        "algorithm.buffer_size": conv_envs * 64, "algorithm.batch_size": 256, "algorithm.update_frequency": 1,
        "algorithm.logging_frequency": 64 * conv_envs, "algorithm.evaluation_active": False,
    })
    dqn = create_model(config)
    dqn.train()
    zero_counts()
    t0 = time.perf_counter()
    dqn.train()
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    path_launches = counts()
    if any(path_launches.values()) or dqn.nr_updates != 2 * conv_steps:
        fail(f"DQN on pixels: launches {path_launches}, {dqn.nr_updates} learning steps")
    check_logged("DQN on pixels", dqn.metrics_history)
    replay = dqn.buffer
    if replay.storage["observation"].dtype != torch.uint8 or replay.storage["next_observation"].dtype != torch.uint8:
        fail("DQN on pixels: the replay does not hold uint8 frames")
    launches_by_path["dqn_pixels"] = path_launches
    conv_rates = {"dqn_pixel_env_steps_per_s": conv_steps * conv_envs / elapsed,
                  "dqn_pixel_updates_per_s": conv_steps / elapsed}

    def dqn_logging_iteration():
        dqn.env_state, _ = dqn._logging_iteration(dqn.env_state, dqn.initial_step(conv_steps), conv_steps)

    dqn_profile = profile_spans(dqn_logging_iteration, "dqn/")
    print(f"train: DQN on pixel_chase at bench_conv's shape ({conv_envs} envs, batch 256, NatureCNN, one update a "
          f"vector step): 1 prefill + {conv_steps} learning steps in {elapsed:.2f} s after a warm-up train(), "
          + json.dumps(conv_rates) + f", replay {replay.nbytes} bytes ({replay.nbytes / 2**20:.1f} MiB; the "
          f"frames uint8, {replay.capacity} rows of {replay.nr_envs} envs), launches {path_launches}, last losses "
          + json.dumps({k: v for k, v in dqn.metrics_history[-1].items() if k.startswith(("loss/", "q_value/"))}))
    print("profile dqn_pixels (64 learning steps): " + json.dumps(dqn_profile))
    del dqn, replay

    # 35. C51 on pixel_chase at 128 envs, batch 256: 1 prefill + 64 learning
    # steps, each through B3 at [256, 51] -> 51; B3 against its plain version
    # there; then DDQN and DQN-HL-Gauss 16 steps each (no kernel)
    pixel_offpolicy = {"runner.device": "cuda", "environment.nr_envs": conv_envs,
                       "algorithm.learning_starts": conv_envs, "algorithm.buffer_size": conv_envs * 64,
                       "algorithm.batch_size": 256, "algorithm.update_frequency": 1,
                       "algorithm.evaluation_active": False}
    for name, steps, b3 in (("c51", 64, 64), ("ddqn", 16, 0), ("dqn_hl_gauss", 16, 0)):
        model = create_model(make_config(f"{name}.cuda", "classic.pixel_chase.cuda", **{
            **pixel_offpolicy, "algorithm.total_timesteps": conv_envs * (1 + steps),
            "algorithm.logging_frequency": 16 * conv_envs}))
        zero_counts()
        t0 = time.perf_counter()
        model.train()
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
        path_launches = counts()
        expected = {"engine_substep": 0, "gae": 0, "categorical_projection": b3}
        if path_launches != expected or model.nr_updates != steps:
            fail(f"{name} on pixels: launches {path_launches} != {expected}, {model.nr_updates} learning steps")
        check_logged(f"{name} on pixels", model.metrics_history)
        launches_by_path[f"{name}_pixels"] = path_launches
        print(f"train: {name} on pixel_chase, 1 prefill + {steps} learning steps at {conv_envs} envs, batch 256, in "
              f"{elapsed:.2f} s; env-steps/s of the log lines {[m['time/sps'] for m in model.metrics_history]}, "
              f"launches {path_launches}, last losses "
              + json.dumps({k: v for k, v in model.metrics_history[-1].items() if k.startswith("loss/")}))
        del model
    # B3 at C51's pixel shape: rewards of the chase (+1 a catch, -0.01 a step)
    chase_rewards = lambda n: torch.where(torch.rand(n, 1, device=dev, generator=g) < 0.05, 1.0, -0.01)
    z, p = c51_targets(256, -10.0, 10.0, chase_rewards)
    out = categorical_projection_cuda(z, p, -10.0, 10.0, 51)
    ref = categorical_projection_reference(z, p, -10.0, 10.0, 51)
    torch.cuda.synchronize()
    err = max_err([out], [ref], 1e-6, 1e-6, "projection [256, 51] -> 51 (C51 on pixels)")
    t = kernel_times(lambda: categorical_projection_cuda(z, p, -10.0, 10.0, 51),
                     lambda: categorical_projection_reference(z, p, -10.0, 10.0, 51), "projection_kernel")
    t["bound_ms"], t["bound_by"] = roofline(projection_bytes(256, 51, 51), projection_flops(256, 51))
    kernels[2]["by_shape"]["[256, 51] -> 51 (C51 on pixels)"] = {**t, "max_abs_err": err}
    kernels[2]["max_abs_err"] = max(kernels[2]["max_abs_err"], err)
    print(f"B3 projection at [256, 51] -> 51 (C51 on pixels, v -10..10): max|err| {err:.3g} (rtol=atol=1e-6), "
          f"kernel {t['ms']:.4f} ms (device {t['device_ms']:.4f} ms, host {t['host_us']:.1f} us a call) plain "
          f"{t['plain_ms']:.3f} ms bound {t['bound_ms']:.6f} ms ({t['bound_by']}: {projection_bytes(256, 51, 51)} "
          f"bytes)")

    # 36. discrete PPO with NatureCNN policy and critic on pixel_chase (128
    # envs x 64 steps, minibatch 2048, 4 epochs): 3 iterations through B1
    # (image minibatches gathered one by one), one more profiled; B1 against
    # its plain version at [64, 128]; then PQN on pixel_grid, 2 iterations
    ppo_envs, ppo_steps = 128, 64
    ppo_batch = ppo_envs * ppo_steps
    config = make_config("ppo.cuda", "classic.pixel_chase.cuda", **{
        "runner.device": "cuda", "environment.nr_envs": ppo_envs, "algorithm.nr_steps": ppo_steps,
        "algorithm.minibatch_size": 2048, "algorithm.nr_epochs": 4, "algorithm.total_timesteps": 3 * ppo_batch,
        "algorithm.evaluation_active": False,
    })
    model = create_model(config)
    zero_counts()
    t0 = time.perf_counter()
    model.train()
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    path_launches = counts()
    if path_launches != {"engine_substep": 0, "gae": 3, "categorical_projection": 0}:
        fail(f"PPO on pixels: launch counts {path_launches}, expected 3 GAE")
    check_logged("PPO on pixels", model.metrics_history)
    launches_by_path["ppo_pixels"] = path_launches
    ppo_profile = profile_spans(lambda: model.learning_iteration(model.env_state), "ppo/")
    print(f"train: PPO (discrete, NatureCNN policy and critic) on pixel_chase, 3 iterations at "
          f"{ppo_envs}x{ppo_steps}, minibatch 2048, 4 epochs, in {elapsed:.2f} s ({3 * ppo_batch / elapsed:.0f} "
          f"env-steps/s overall, {model.metrics_history[-1]['time/sps']} in the last iteration), launches "
          f"{path_launches}, last losses "
          + json.dumps({k: v for k, v in model.metrics_history[-1].items() if k.startswith("loss/")}))
    print("profile ppo_pixels (one iteration): " + json.dumps(ppo_profile))
    del model
    r = torch.where(torch.rand(ppo_steps, ppo_envs, device=dev, generator=g) < 0.05, 1.0, -0.01)
    v, nv = (0.3 * torch.randn(ppo_steps, ppo_envs, device=dev, generator=g) for _ in range(2))
    d = torch.rand(ppo_steps, ppo_envs, device=dev, generator=g) < 0.05
    pixel_gae_err = max_err(gae_advantages_cuda(r, v, nv, d, 0.99, 0.95),
                            gae_advantages_reference(r, v, nv, d, 0.99, 0.95), 1e-5, 1e-5, "GAE [64, 128]")
    t = kernel_times(lambda: gae_advantages_cuda(r, v, nv, d, 0.99, 0.95),
                     lambda: gae_advantages_reference(r, v, nv, d, 0.99, 0.95), "gae_kernel")
    t["bound_ms"], t["bound_by"] = roofline(gae_bytes(ppo_steps, ppo_envs), 0)
    kernels[0]["by_shape"]["[64, 128] (PPO on pixels)"] = {**t, "max_abs_err": pixel_gae_err}
    kernels[0]["max_abs_err"] = max(kernels[0]["max_abs_err"], pixel_gae_err)
    launch = gae_geometry(ppo_steps, ppo_envs)
    print(f"B1 gae at [64, 128] (PPO on pixels): max|err| {pixel_gae_err:.3g} (rtol=atol=1e-5), kernel "
          f"{t['ms']:.4f} ms (device {t['device_ms']:.4f} ms, host {t['host_us']:.1f} us a call) plain "
          f"{t['plain_ms']:.3f} ms bound {t['bound_ms']:.6f} ms ({t['bound_by']}: {gae_bytes(ppo_steps, ppo_envs)} "
          f"bytes; {launch.blocks} blocks of {launch.threads} threads)")
    model = create_model(make_config("pqn.cuda", "classic.pixel_grid.cuda", **{
        "runner.device": "cuda", "environment.nr_envs": ppo_envs, "algorithm.total_timesteps": 2 * ppo_envs * 32,
        "algorithm.evaluation_active": False}))
    zero_counts()
    t0 = time.perf_counter()
    model.train()
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    path_launches = counts()
    if any(path_launches.values()) or model.nr_optimizer_steps != 2 * 2 * 4:
        fail(f"PQN on pixels: launches {path_launches}, {model.nr_optimizer_steps} optimizer steps")
    check_logged("PQN on pixels", model.metrics_history)
    launches_by_path["pqn_pixels"] = path_launches
    print(f"train: PQN (NatureCNN) on pixel_grid, 2 iterations at {ppo_envs}x32 in {elapsed:.2f} s, env-steps/s "
          f"{[m['time/sps'] for m in model.metrics_history]}, launches {path_launches}")
    del model

    # 37. DQN on pixel_chase through the Runner: 1 prefill + 64 learning
    # steps with 2 evaluations and saves, then test mode from latest.model
    # (every tensor equal bit for bit)
    os.chdir(workdir.name)
    pixel_args = ["--algorithm.name=dqn.cuda", "--environment.name=classic.pixel_chase.cuda", "--runner.device=cuda",
                  f"--environment.nr_envs={conv_envs}", f"--algorithm.learning_starts={conv_envs}",
                  f"--algorithm.buffer_size={conv_envs * 64}", "--algorithm.batch_size=256",
                  "--algorithm.update_frequency=1"]
    runner = Runner([*pixel_args, f"--algorithm.total_timesteps={conv_envs * 65}",
                     f"--algorithm.logging_frequency={16 * conv_envs}",
                     f"--algorithm.evaluation_and_save_frequency={32 * conv_envs}", "--runner.save_model=True",
                     "--runner.run_name=dqn_pixels"])
    zero_counts()
    t0 = time.perf_counter()
    trained = runner.run()
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    runner_launches = counts()
    eval_returns = [float(x) for x in trained.eval_history["eval/episode_return"]]
    if any(runner_launches.values()) or len(eval_returns) != 2 or not all(map(math.isfinite, eval_returns)):
        fail(f"DQN pixel runner: launches {runner_launches}, eval returns {eval_returns}")
    pixel_latest = os.path.join(workdir.name, "runs", "rlx_tpu_torch", "default", "dqn_pixels", "models",
                                "latest.model")
    tester = Runner([*pixel_args, "--runner.mode=test", f"--runner.load_model={pixel_latest}",
                     "--runner.nr_test_episodes=16", "--runner.run_name=dqn_pixels_test"])
    t0 = time.perf_counter()
    test_returns = tester.run()
    torch.cuda.synchronize()
    test_s = time.perf_counter() - t0
    os.chdir(root)
    if len(test_returns) != 16 or not all(math.isfinite(r) for r in test_returns):
        fail(f"DQN pixel test mode returned {test_returns}, expected 16 finite returns")
    compared = same_tree(trained.checkpoint_tree(), tester.model.checkpoint_tree())
    launches_by_path["dqn_pixels_runner"] = runner_launches
    print(f"runner dqn on pixel_chase: 1 prefill + 64 learning steps at {conv_envs} envs with 2 evaluations and "
          f"saves in {train_s:.2f} s, eval returns {eval_returns}; checkpoint "
          f"{os.path.getsize(pixel_latest) / 2**20:.2f} MiB; test mode {test_s:.2f} s (load included), "
          f"{compared} tensors restored bit for bit, mean test return {sum(test_returns) / 16:.3f}")
    print(f"phases 32-37 (the pixel track) took {time.perf_counter() - pixel_phases_t0:.1f} s")
    del trained, tester

    # 38. the native C++ batcher (the host track's card path): envbatch.cpp
    # built by g++; native.cart_pole.host and native.pendulum.host with their
    # results on the card and on the CPU, from the same seed under the same
    # actions, over two horizons with auto-resets, at the registration's 8
    # envs and at 1,024: every output equal bit for bit, no kernel launched;
    # then the host time of a card step, split into the action's copy down,
    # the C++ step and the copy up
    import numpy as np

    from rlx_tpu_torch.environments.native import batcher as native

    host_phases_t0 = time.perf_counter()

    library = _build.host_library_path(os.path.join(native.NATIVE_DIR, "envbatch.cpp"), [], ["-lpthread"])
    built = not os.path.exists(library)
    t0 = time.perf_counter()
    native._library("envbatch")
    print(f"build: envbatch.cpp {'compiled by g++' if built else 'found already built'} in "
          f"{time.perf_counter() - t0:.1f} s ({os.path.basename(library)})")
    rng = np.random.default_rng(38)
    step_split = {}
    for env_id in ("cart_pole", "pendulum"):
        for nr_envs in (8, 1024):
            envs = {d: native.NativeEnvBatch(env_id, nr_envs, seed=1, device=d) for d in (dev, "cpu")}
            horizon = envs["cpu"].horizon
            discrete = env_id == "cart_pole"
            zero_counts()
            states = {d: env.reset(0) for d, env in envs.items()}
            compared = episodes = 0
            for t in range(2 * horizon):
                action = (torch.from_numpy(rng.integers(0, 2, size=nr_envs).astype(np.int32)) if discrete else
                          torch.from_numpy(rng.uniform(-2.5, 2.5, size=(nr_envs, 1)).astype(np.float32)))
                states = {d: env.step(states[d], action.to(d)) for d, env in envs.items()}
                for field in ("observation", "final_observation", "reward", "terminated", "truncated"):
                    if not torch.equal(getattr(states[dev], field).cpu(), getattr(states["cpu"], field)):
                        fail(f"native {env_id} at {nr_envs} envs, step {t}: {field} on the card differs from the CPU")
                    compared += 1
                for key in states["cpu"].info:
                    if not torch.equal(states[dev].info[key].cpu(), states["cpu"].info[key]):
                        fail(f"native {env_id} at {nr_envs} envs, step {t}: {key} on the card differs from the CPU")
                episodes += int((states["cpu"].terminated | states["cpu"].truncated).sum())
            if episodes < nr_envs or any(counts().values()):
                fail(f"native {env_id}: {episodes} episodes ended in 2 horizons, launches {counts()}")
            # the card's step alone, actions drawn on the card
            env = envs[dev]
            state = env.reset(0)
            gen = torch.Generator(device=dev).manual_seed(38)
            draw = ((lambda: torch.randint(0, 2, (nr_envs,), device=dev, generator=gen, dtype=torch.int32))
                    if discrete else (lambda: 4 * torch.rand(nr_envs, 1, device=dev, generator=gen) - 2))
            steps = 1000
            env.timings = {}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(steps):
                state = env.step(state, draw())
            torch.cuda.synchronize()
            total_us = (time.perf_counter() - t0) / steps * 1e6
            split = {k: v / steps * 1e6 for k, v in env.timings.items()}
            step_split[f"{env_id} B={nr_envs}"] = {"step_us": total_us, **{f"{k}_us": v for k, v in split.items()}}
            print(f"native {env_id} at {nr_envs} envs: card and CPU equal bit for bit over {2 * horizon} steps "
                  f"({compared} tensors, {episodes} episodes ended); a card step {total_us:.1f} us on the host: "
                  f"action down {split['action_down']:.1f}, C++ step {split['host_step']:.1f}, copy up "
                  f"{split['results_up']:.1f} us ({env.edge.staging.numel()} bytes pinned)")
            for e in envs.values():
                e.close()

    print(f"phase 38 took {time.perf_counter() - host_phases_t0:.1f} s")
    phase_t0 = time.perf_counter()

    # 39. PPO on native.pendulum.host and discrete PPO on native.cart_pole.host
    # at the hopper_ppo shape (8 envs x 256 steps, minibatch 64, 10 epochs,
    # (256, 256)): 1 iteration each through B1, one more for the idle
    # share; the same
    # on classic.pendulum.cuda in this call, so the bridge's cost reads
    # against the device env's; B1 against its plain version at [256, 8]
    # on each host path's inputs
    hopper_shape = {k: v for k, v in RUNS["hopper_ppo"]["overrides"].items()}
    host_batch = hopper_shape["algorithm.nr_steps"] * hopper_shape["environment.nr_envs"]
    host_ppo = {}
    for label, environment in (("native_pendulum", "native.pendulum.host"),
                               ("native_cart_pole", "native.cart_pole.host"),
                               ("classic_pendulum", "classic.pendulum.cuda")):
        model = create_model(make_config("ppo.cuda", environment, **{
            **hopper_shape, "runner.device": "cuda", "algorithm.total_timesteps": host_batch,
            "algorithm.evaluation_active": False}))
        zero_counts()
        t0 = time.perf_counter()
        model.train()
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
        path_launches = counts()
        if path_launches != {"engine_substep": 0, "gae": 1, "categorical_projection": 0}:
            fail(f"PPO on {environment}: launch counts {path_launches}, expected 1 GAE")
        check_logged(f"PPO on {environment}", model.metrics_history)
        if environment.endswith(".host"):
            launches_by_path[f"ppo_{label}"] = path_launches
        host_ppo[label] = {"env_steps_per_s": host_batch / elapsed,
                           "last_iteration_sps": model.metrics_history[-1]["time/sps"]}
        print(f"train: PPO on {environment} at the hopper_ppo shape (8x256, minibatch 64, 10 epochs, (256, 256)), "
              f"1 iteration in {elapsed:.2f} s ({host_batch / elapsed:.0f} env-steps/s, "
              f"{model.metrics_history[-1]['time/sps']} in the last), launches {path_launches}")
        if label != "native_cart_pole":
            # the bridge's cost: the rollout of each Pendulum timed alone, and
            # one iteration's device idle share; the host pendulum's
            # iteration also with its spans and top kernels
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            model.env_state = model._rollout(model.env_state)[0]
            torch.cuda.synchronize()
            host_ppo[label]["rollout_ms"] = (time.perf_counter() - t0) * 1e3
            # (the host pendulum's spans and top kernels, profile_spans of one
            # more iteration, ~50 s of event parsing, are left out since
            # phases 45-46 came in: the idle share stays)
            host_ppo[label].update(device_idle(lambda: model.learning_iteration(model.env_state), "ppo/"))
            print(f"ppo_{label}: rollout alone {host_ppo[label]['rollout_ms']:.1f} ms (256 steps of 8 envs), one "
                  f"iteration {host_ppo[label]['wall_ms']:.1f} ms, device busy {host_ppo[label]['device_busy_ms']:.1f} "
                  f"ms, idle share {host_ppo[label]['device_idle_share']:.3f}")
        model.train_env.close()
        model.eval_env.close()
        del model
    for label, (r, d, gamma) in {
        "[256, 8] (PPO on native.pendulum.host)": (-16.0 * torch.rand(256, 8, device=dev, generator=g),
                                                   torch.zeros(256, 8, dtype=torch.bool, device=dev), 0.99),
        "[256, 8] (PPO on native.cart_pole.host)": (torch.ones(256, 8, device=dev),
                                                    torch.rand(256, 8, device=dev, generator=g) < 0.05, 0.99),
    }.items():
        v, nv = (r.mean() * 20 + 5.0 * torch.randn(256, 8, device=dev, generator=g) for _ in range(2))
        err = max_err(gae_advantages_cuda(r, v, nv, d, gamma, 0.95), gae_advantages_reference(r, v, nv, d, gamma, 0.95),
                      1e-5, 1e-5, f"GAE {label}")
        t = kernel_times(lambda: gae_advantages_cuda(r, v, nv, d, gamma, 0.95),
                         lambda: gae_advantages_reference(r, v, nv, d, gamma, 0.95), "gae_kernel")
        t["bound_ms"], t["bound_by"] = roofline(gae_bytes(256, 8), 0)
        kernels[0]["by_shape"][label] = {**t, "max_abs_err": err}
        kernels[0]["max_abs_err"] = max(kernels[0]["max_abs_err"], err)
        print(f"B1 gae at {label}: max|err| {err:.3g} (rtol=atol=1e-5), kernel {t['ms']:.4f} ms (device "
              f"{t['device_ms']:.4f} ms, host {t['host_us']:.1f} us a call) plain {t['plain_ms']:.3f} ms bound "
              f"{t['bound_ms']:.6f} ms ({t['bound_by']}: {gae_bytes(256, 8)} bytes)")

    print(f"phase 39 took {time.perf_counter() - phase_t0:.1f} s")
    phase_t0 = time.perf_counter()

    # 40. C51 on native.cart_pole.host at the cartpole_spot_c51 recipe and
    # FastTD3 on native.pendulum.host at the pendulum_spot_fasttd3 recipe:
    # the recipe's prefill, then 256 learning steps, B3 exactly once a step;
    # B3 against its plain version at each path's shape
    host_offpolicy = {}
    for name, environment, recipe_name in (("c51", "native.cart_pole.host", "cartpole_spot_c51"),
                                           ("fasttd3", "native.pendulum.host", "pendulum_spot_fasttd3")):
        overrides = {**RUNS[recipe_name]["overrides"], "runner.device": "cuda"}
        starts = make_config(f"{name}.cuda", environment, **overrides).algorithm.learning_starts
        overrides.update({"algorithm.total_timesteps": starts + 256 * 8, "algorithm.logging_frequency": 64 * 8,
                          "algorithm.evaluation_active": False})
        model = create_model(make_config(f"{name}.cuda", environment, **overrides))
        zero_counts()
        t0 = time.perf_counter()
        model.train()
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
        path_launches = counts()
        expected = {"engine_substep": 0, "gae": 0, "categorical_projection": 256}
        if path_launches != expected or model.nr_updates != 256:
            fail(f"{name} on {environment}: launches {path_launches} != {expected}, {model.nr_updates} learning steps")
        check_logged(f"{name} on {environment}", model.metrics_history)
        launches_by_path[f"{name}_{environment.split('.')[1]}_host"] = path_launches
        sps = [m["time/sps"] for m in model.metrics_history]
        host_offpolicy[name] = {"env_steps_per_s_by_log_line": sps, "wall_s": elapsed}
        print(f"train: {name} on {environment} at the {recipe_name} recipe, {starts // 8} prefill + 256 learning "
              f"steps at 8 envs in {elapsed:.2f} s; env-steps/s of the log lines (the first includes the prefill) "
              f"{sps}, launches {path_launches}")
        model.train_env.close()
        model.eval_env.close()
        del model
    for label, (n, v_lo, v_hi, atoms, reward, gamma) in {
        "[128, 51] -> 51 (C51 on native.cart_pole.host, 0..500)": (128, 0.0, 500.0, 51,
                                                                    lambda n: torch.ones(n, 1, device=dev), 0.99),
        "[128, 101] -> 101 (FastTD3 on native.pendulum.host, -800..100)": (
            128, -800.0, 100.0, 101, lambda n: -16.0 * torch.rand(n, 1, device=dev, generator=g), 0.97),
    }.items():
        support = torch.linspace(v_lo, v_hi, atoms, device=dev)
        d = (torch.rand(n, 1, device=dev, generator=g) < 0.05).float()
        z, p = reward(n) + gamma * (1.0 - d) * support[None], softmax_probs(n, atoms)
        out = categorical_projection_cuda(z, p, v_lo, v_hi, atoms)
        ref = categorical_projection_reference(z, p, v_lo, v_hi, atoms)
        torch.cuda.synchronize()
        err = max_err([out], [ref], 1e-6, 1e-6, f"projection {label}")
        t = kernel_times(lambda: categorical_projection_cuda(z, p, v_lo, v_hi, atoms),
                         lambda: categorical_projection_reference(z, p, v_lo, v_hi, atoms), "projection_kernel")
        t["bound_ms"], t["bound_by"] = roofline(projection_bytes(n, atoms, atoms), projection_flops(n, atoms))
        kernels[2]["by_shape"][label] = {**t, "max_abs_err": err}
        kernels[2]["max_abs_err"] = max(kernels[2]["max_abs_err"], err)
        print(f"B3 projection at {label}: max|err| {err:.3g} (rtol=atol=1e-6), kernel {t['ms']:.4f} ms (device "
              f"{t['device_ms']:.4f} ms, host {t['host_us']:.1f} us a call) plain {t['plain_ms']:.3f} ms bound "
              f"{t['bound_ms']:.6f} ms ({t['bound_by']}: {projection_bytes(n, atoms, atoms)} bytes)")

    print(f"phase 40 took {time.perf_counter() - phase_t0:.1f} s")
    phase_t0 = time.perf_counter()

    # 41. keeping a policy on a host env: PPO on native.pendulum.host through
    # the Runner at the hopper_ppo shape, 2 iterations with an evaluation and
    # a save after each, then test mode from latest.model (every tensor
    # equal bit for bit)
    os.chdir(workdir.name)
    host_args = ["--algorithm.name=ppo.cuda", "--environment.name=native.pendulum.host", "--runner.device=cuda",
                 *[f"--{k}={v}" for k, v in hopper_shape.items()]]
    runner = Runner([*host_args, f"--algorithm.total_timesteps={2 * host_batch}",
                     f"--algorithm.evaluation_and_save_frequency={host_batch}", "--runner.save_model=True",
                     "--runner.run_name=ppo_native_pendulum"])
    zero_counts()
    t0 = time.perf_counter()
    trained = runner.run()
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    runner_launches = counts()
    eval_returns = [float(x) for x in trained.eval_history["eval/episode_return"]]
    if runner_launches != {"engine_substep": 0, "gae": 2, "categorical_projection": 0} or len(eval_returns) != 2 \
            or not all(map(math.isfinite, eval_returns)):
        fail(f"PPO native.pendulum.host runner: launches {runner_launches}, eval returns {eval_returns}")
    host_latest = os.path.join(workdir.name, "runs", "rlx_tpu_torch", "default", "ppo_native_pendulum", "models",
                               "latest.model")
    tester = Runner([*host_args, "--runner.mode=test", f"--runner.load_model={host_latest}",
                     "--runner.nr_test_episodes=8", "--runner.run_name=ppo_native_pendulum_test"])
    zero_counts()
    t0 = time.perf_counter()
    test_returns = tester.run()
    torch.cuda.synchronize()
    test_s = time.perf_counter() - t0
    test_launches = counts()
    os.chdir(root)
    if len(test_returns) != 8 or not all(math.isfinite(r) for r in test_returns) or any(test_launches.values()):
        fail(f"PPO native.pendulum.host test mode returned {test_returns}, launches {test_launches}")
    compared = same_tree(trained.checkpoint_tree(), tester.model.checkpoint_tree())
    launches_by_path["ppo_native_pendulum_runner"] = runner_launches
    launches_by_path["ppo_native_pendulum_test"] = test_launches
    print(f"runner ppo on native.pendulum.host: 2 iterations at 8x256 with 2 evaluations and saves in "
          f"{train_s:.2f} s, eval returns {eval_returns}; checkpoint {os.path.getsize(host_latest) / 2**20:.2f} MiB; "
          f"test mode {test_s:.2f} s (load included), {compared} tensors restored bit for bit, mean test return "
          f"{sum(test_returns) / 8:.2f}")
    print("host track: " + json.dumps({"native_step_split": step_split, "ppo": {
        k: {key: v[key] for key in ("env_steps_per_s", "rollout_ms", "wall_ms", "device_idle_share", "host_spans_ms")
            if key in v}
        for k, v in host_ppo.items()}, "offpolicy": host_offpolicy}))
    print(f"phase 41 took {time.perf_counter() - phase_t0:.1f} s; phases 38-41 (the host track) took "
          f"{time.perf_counter() - host_phases_t0:.1f} s")
    del trained, tester
    workdir.cleanup()

    # 42. parallel seeds: every launch carries all seeds
    phase_t0 = time.perf_counter()
    from rlx_tpu_torch.algorithms import parallel_seeds
    from rlx_tpu_torch.algorithms.c51.cuda import c51 as c51_module
    from rlx_tpu_torch.algorithms.training_program import run_training_program

    seeds = 4
    seeded = {"algorithm.nr_parallel_seeds": seeds, "algorithm.logging_active": False}
    # phase 5's flagship shape (later phases reuse its names)
    nr_envs, nr_steps = 4096, 64
    batch = nr_envs * nr_steps
    ppo_overrides = {"runner.device": "cuda",
                     "environment.nr_envs": nr_envs, "algorithm.nr_steps": nr_steps,
                     "algorithm.total_timesteps": ITERATIONS * batch, "algorithm.minibatch_size": batch // 8,
                     "algorithm.nr_epochs": 4, "algorithm.policy_hidden_sizes": (512, 256, 128),
                     "algorithm.critic_hidden_sizes": (512, 256, 128), "algorithm.activation": "elu",
                     "algorithm.layer_norm": True, "algorithm.compute_dtype": "bfloat16",
                     "algorithm.evaluation_active": False}
    model = create_model(make_config("ppo.cuda", "locomotion.ant.cuda", **ppo_overrides, **seeded))
    if model.train_env.nr_envs != seeds * nr_envs:
        fail(f"4-seed PPO env holds {model.train_env.nr_envs} envs")
    zero_counts()
    t0 = time.perf_counter()
    model.train()
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    seeds_launches = counts()
    expected = {"engine_substep": nr_steps * ITERATIONS, "gae": ITERATIONS, "categorical_projection": 0}
    if seeds_launches != expected:
        fail(f"4-seed PPO launch counts {seeds_launches} != {expected} (phase 5's: the seeds ride in each launch)")
    for p in list(model.policy.module.parameters()) + list(model.critic.parameters()):
        if not torch.isfinite(p).all():
            fail("4-seed PPO: non-finite parameters after training")
    launches_by_path["ppo_4_seeds"] = seeds_launches
    seeds_env_steps_per_s = seeds * ITERATIONS * batch / elapsed
    profiled = create_model(make_config("ppo.cuda", "locomotion.ant.cuda", **ppo_overrides, **seeded))
    profiled.env_state = profiled._init_train_carry()[0]
    profiled.learning_iteration(profiled.env_state)   # warm-up of the 4-seed shapes

    def seeds_iteration():
        profiled.env_state, _ = profiled.learning_iteration(profiled.env_state)

    seeds_profile = profile_spans(seeds_iteration, "ppo/")
    del profiled
    print(f"parallel seeds PPO: {seeds} seeds x {nr_envs} envs x {nr_steps} steps, {ITERATIONS} iterations in "
          f"{elapsed:.2f} s, {seeds_env_steps_per_s:.0f} env-steps/s summed over seeds against "
          f"{ppo_env_steps_per_s:.0f} of one seed (phase 5), x{seeds_env_steps_per_s / ppo_env_steps_per_s:.2f}; "
          f"launches {seeds_launches}; one profiled 4-seed iteration: " + json.dumps(seeds_profile))

    # seed 1 of a 3-seed f32 run is its one-seed run (both through B1 and B2)
    small = {"runner.device": "cuda", "environment.nr_envs": 64, "algorithm.nr_steps": 16,
             "algorithm.total_timesteps": 64 * 16, "algorithm.minibatch_size": 256, "algorithm.nr_epochs": 2,
             "algorithm.policy_hidden_sizes": (64, 64), "algorithm.critic_hidden_sizes": (64, 64),
             "algorithm.evaluation_active": False, "algorithm.logging_active": False,
             "environment.initial_state_noise": 0.1}
    three = create_model(make_config("ppo.cuda", "locomotion.ant.cuda", **small, **{
        "algorithm.nr_parallel_seeds": 3, "environment.seed": 3}))
    run_training_program(three)
    one = create_model(make_config("ppo.cuda", "locomotion.ant.cuda", **small, **{
        "environment.seed": parallel_seeds.seed_for(3, 1)}))
    one.train()
    torch.cuda.synchronize()
    # f32 (TF32 off): the 3-seed products are batched, the one-seed ones
    # not, so they round apart: 1e-4 relative + absolute on the parameters
    seed_err = max_err(
        [p[1] for p in list(three.policy.module.parameters()) + list(three.critic.parameters())],
        list(one.policy.module.parameters()) + list(one.critic.parameters()), 1e-4, 1e-4,
        "seed 1 of 3 against its one-seed run")
    print(f"parallel seeds PPO: seed 1 of 3 after one iteration (64 envs x 16 steps, f32) equals its one-seed run "
          f"at seed_for(3, 1) = {parallel_seeds.seed_for(3, 1)}: max|err| {seed_err:.3g} over every parameter "
          f"(rtol=atol=1e-4)")
    del three, one

    # SAC at bench_offpolicy's shape with 4 seeds: B2 once a step
    learning_steps, sac_envs = 16, 1024
    sac_seeds = create_model(make_config("sac.cuda", "locomotion.ant.cuda", **{
        "runner.device": "cuda", "environment.nr_envs": sac_envs, **OFFPOLICY_SHAPE, **seeded,
        "algorithm.total_timesteps": sac_envs + learning_steps * sac_envs,
        "algorithm.logging_frequency": learning_steps * sac_envs}))
    zero_counts()
    t0 = time.perf_counter()
    sac_seeds.train()
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    sac_launches = counts()
    if sac_launches != {"engine_substep": 1 + learning_steps, "gae": 0, "categorical_projection": 0}:
        fail(f"4-seed SAC launch counts {sac_launches} != {1 + learning_steps} B2")
    for name in sac_seeds.state_names:
        if not all(torch.isfinite(p).all() for p in getattr(sac_seeds, name).module.parameters()):
            fail(f"4-seed SAC: non-finite {name} parameters")
    launches_by_path["sac_4_seeds"] = sac_launches
    print(f"parallel seeds SAC: {seeds} seeds x {sac_envs} envs, batch 8192 a seed, 1 prefill + {learning_steps} "
          f"learning steps in {elapsed:.2f} s ({seeds * (1 + learning_steps) * sac_envs / elapsed:.0f} env-steps/s "
          f"summed over seeds, buffer allocation and prefill included), launches {sac_launches}")
    del sac_seeds

    # C51 on CartPole with 4 seeds: B3 once an update, at [4 x 128, 51]
    c51_steps, c51_starts = 32, 1_000
    shapes = []
    projection = c51_module.categorical_projection_dense
    c51_module.categorical_projection_dense = lambda z, p, *a: shapes.append(tuple(z.shape)) or projection(z, p, *a)
    try:
        c51_seeds = create_model(make_config("c51.cuda", "classic.cart_pole.cuda", **{
            **RUNS["cartpole_spot_c51"]["overrides"], "runner.device": "cuda", **seeded,
            "algorithm.learning_starts": c51_starts, "algorithm.total_timesteps": c51_starts + c51_steps * 8,
            "algorithm.logging_frequency": c51_steps * 8, "algorithm.evaluation_active": True,
            "environment.horizon": 100}))
        zero_counts()
        t0 = time.perf_counter()
        c51_seeds.train()
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
    finally:
        c51_module.categorical_projection_dense = projection
    c51_seed_launches = counts()
    batch_rows = seeds * c51_seeds.batch_size
    if c51_seed_launches != {"engine_substep": 0, "gae": 0, "categorical_projection": c51_steps} \
            or set(shapes) != {(batch_rows, 51)}:
        fail(f"4-seed C51 launch counts {c51_seed_launches}, projection shapes {sorted(set(shapes))}")
    c51_returns = c51_seeds.eval_history["eval/episode_return"]
    if c51_returns.shape != (seeds, 1) or not all(map(math.isfinite, c51_returns.ravel())):
        fail(f"4-seed C51 eval history {c51_returns}")
    launches_by_path["c51_4_seeds"] = c51_seed_launches
    print(f"parallel seeds C51: {seeds} seeds x 8 envs, {c51_starts // 8} prefill + {c51_steps} learning steps in "
          f"{elapsed:.2f} s, launches {c51_seed_launches}, every projection at {shapes[0]}; eval returns per seed "
          f"{c51_returns.ravel().tolist()}")
    del c51_seeds

    # the kernels at the seed-folded shapes against their plain versions
    args = gae_inputs(64, seeds * 4096)
    out, ref = gae_advantages_cuda(*args, 0.99, 0.95), gae_advantages_reference(*args, 0.99, 0.95)
    torch.cuda.synchronize()
    err = max_err(out, ref, 1e-5, 1e-5, "GAE [64, 16384]")
    t = kernel_times(lambda: gae_advantages_cuda(*args, 0.99, 0.95),
                     lambda: gae_advantages_reference(*args, 0.99, 0.95), "gae_kernel")
    t["bound_ms"], t["bound_by"] = gae_bytes(64, seeds * 4096) / H100_BYTES_PER_S * 1e3, "bytes"
    kernels[0]["by_shape"][f"[64, {seeds * 4096}] (PPO, {seeds} seeds)"] = {**t, "max_abs_err": err}
    kernels[0]["max_abs_err"] = max(kernels[0]["max_abs_err"], err)
    print(f"B1 gae at [64, {seeds * 4096}] ({seeds} seeds): max|err| {err:.3g} (rtol=atol=1e-5), kernel "
          f"{t['ms']:.4f} ms (device {t['device_ms']:.4f} ms) plain {t['plain_ms']:.3f} ms bound {t['bound_ms']:.4f} ms")
    B = seeds * 4096
    qpos, qvel, ctrl = ant_batch(ant, B)
    out = step_cuda(ant, qpos, qvel, ctrl, nr_substeps=4)
    ref = engine.step_reference(ant, qpos, qvel, ctrl, nr_substeps=4)
    torch.cuda.synchronize()
    err = max_err(out, ref, 1e-4, 1e-4, f"substep (Ant, B={B})")
    t = kernel_times(lambda: step_cuda(ant, qpos, qvel, ctrl, nr_substeps=4),
                     lambda: engine.step_reference(ant, qpos, qvel, ctrl, nr_substeps=4), "engine_substep_kernel",
                     reps=100)
    t["bound_ms"], t["bound_by"] = roofline(substep_bytes(ant, B, with_anchors=False), substep_flops(ant) * B * 4)
    kernels[1]["by_shape"] = {**kernels[1].get("by_shape", {}), f"Ant B={B} (PPO, {seeds} seeds)": {
        **t, "max_abs_err": err}}
    kernels[1]["max_abs_err"] = max(kernels[1]["max_abs_err"], err)
    print(f"B2 engine_substep at B={B} ({seeds} seeds), 4 substeps: max|err| {err:.3g} (rtol=atol=1e-4), kernel "
          f"{t['ms']:.4f} ms (device {t['device_ms']:.4f} ms) plain {t['plain_ms']:.2f} ms bound "
          f"{t['bound_ms']:.5f} ms ({t['bound_by']})")
    n = batch_rows
    z, p = c51_targets(n, 0.0, 500.0, lambda n: torch.ones(n, 1, device=dev))
    out, ref = categorical_projection_cuda(z, p, 0.0, 500.0, 51), categorical_projection_reference(z, p, 0.0, 500.0, 51)
    torch.cuda.synchronize()
    err = max_err([out], [ref], 1e-6, 1e-6, f"projection [{n}, 51]")
    t = kernel_times(lambda: categorical_projection_cuda(z, p, 0.0, 500.0, 51),
                     lambda: categorical_projection_reference(z, p, 0.0, 500.0, 51), "projection_kernel")
    t["bound_ms"], t["bound_by"] = roofline(projection_bytes(n, 51, 51), projection_flops(n, 51))
    kernels[2]["by_shape"][f"[{n}, 51] -> 51 (C51, {seeds} seeds)"] = {**t, "max_abs_err": err}
    kernels[2]["max_abs_err"] = max(kernels[2]["max_abs_err"], err)
    print(f"B3 projection at [{n}, 51] -> 51 ({seeds} seeds): max|err| {err:.3g} (rtol=atol=1e-6), kernel "
          f"{t['ms']:.4f} ms (device {t['device_ms']:.4f} ms) plain {t['plain_ms']:.3f} ms bound "
          f"{t['bound_ms']:.6f} ms ({t['bound_by']})")
    print(f"phase 42 took {time.perf_counter() - phase_t0:.1f} s")

    # 43. parallel seeds for the last twelve off-policy families: each at 4
    # seeds x 1024 envs on the Ant at phases 21-23 and 25's shapes, 1 prefill
    # (FastMPO: 10) + 8 learning steps and one evaluation through
    # create_model / train(); B2 once an env step, B3 once an update for
    # FastSAC and FlashSAC at [4 x batch, 101]; seed 1 of 3 against its
    # one-seed run for REDQ and FlashSAC (c3_checks); B3 and B2 at the
    # folded shapes
    phase_t0 = time.perf_counter()
    from rlx_tpu_torch.algorithms.fastsac.cuda import fastsac as fastsac_module
    from rlx_tpu_torch.algorithms.flashsac.cuda import flashsac as flashsac_module

    eval_horizon = 32   # the Ant's episode cut from 1000 for the one evaluation; widths and batches stay
    steps43 = 8         # learning steps a run
    families = {   # name -> (overrides, prefill steps, B3 launches an update)
        "fastsac": ({"algorithm.batch_size": 8192, "algorithm.learning_starts": 1024}, 1, 1),
        "flashsac": ({"algorithm.learning_starts": 1024}, 1, 1),
        **{name: ({"algorithm.learning_starts": 1024}, 1, 0)
           for name in ("crossq", "redq", "droq", "aqe", "tqc", "xqc", "simbav2", "bro", "mpo")},
        "fastmpo": ({}, 10, 0),
    }
    projection_shapes = []
    projections = {m: m.categorical_projection_dense for m in (fastsac_module, flashsac_module)}
    for m, projection in projections.items():
        m.categorical_projection_dense = (lambda projection: lambda z, p, *a: projection_shapes.append(
            tuple(z.shape)) or projection(z, p, *a))(projection)

    def offpolicy_seeds_run(name, overrides, prefill, nr_seeds):
        """Train ``name`` at ``nr_seeds`` seeds x 1024 envs with one
        evaluation at the end: (model, train s without the evaluation,
        launches before the evaluation, launches of the evaluation)."""
        config = make_config(f"{name}.cuda", "locomotion.ant.cuda", **{
            "runner.device": "cuda", "environment.nr_envs": 1024, "environment.horizon": eval_horizon,
            "algorithm.total_timesteps": (prefill + steps43) * 1024, "algorithm.logging_frequency": steps43 * 1024,
            "algorithm.evaluation_active": True, "algorithm.logging_active": False,
            "algorithm.nr_parallel_seeds": nr_seeds, **overrides})
        model = create_model(config)
        marks = {}
        eval_iteration = model._eval_iteration

        def timed_eval(i):
            torch.cuda.synchronize()
            marks["t"], marks["launches"] = time.perf_counter(), counts()
            out = eval_iteration(i)
            torch.cuda.synchronize()
            marks["eval_s"] = time.perf_counter() - marks["t"]
            return out

        model._eval_iteration = timed_eval
        zero_counts()
        projection_shapes.clear()
        t0 = time.perf_counter()
        model.train()
        torch.cuda.synchronize()
        total = counts()
        train_launches = marks["launches"]
        eval_launches = {k: total[k] - train_launches[k] for k in total}
        return model, marks["t"] - t0, train_launches, eval_launches

    seeds43, rows43 = 4, {}
    for name, (overrides, prefill, b3_an_update) in families.items():
        # one seed first, the same program at the same shapes (its first run
        # in phases 21-25 paid the shapes' first-call costs)
        model, train_s, one_launches, _ = offpolicy_seeds_run(name, overrides, prefill, 1)
        one_seed_rate = (prefill + steps43) * 1024 / train_s
        del model
        model, train_s, train_launches, eval_launches = offpolicy_seeds_run(name, overrides, prefill, seeds43)
        batch_size = model.batch_size
        expected = {"engine_substep": prefill + steps43, "gae": 0, "categorical_projection": steps43 * b3_an_update}
        if train_launches != expected or one_launches != expected:
            fail(f"4-seed {name}: launches {train_launches}, one seed {one_launches}, expected {expected}")
        if eval_launches != {"engine_substep": eval_horizon, "gae": 0, "categorical_projection": 0}:
            fail(f"4-seed {name}: evaluation launches {eval_launches}, expected {eval_horizon} B2 only")
        if b3_an_update and set(projection_shapes) != {(seeds43 * batch_size, 101)}:
            fail(f"4-seed {name}: projection shapes {sorted(set(projection_shapes))}, expected "
                 f"[{seeds43} x {batch_size}, 101]")
        returns = model.eval_history["eval/episode_return"]
        if returns.shape != (seeds43, 1) or not all(map(math.isfinite, returns.ravel())):
            fail(f"4-seed {name}: eval history {returns}")
        rate = seeds43 * (prefill + steps43) * 1024 / train_s
        launches_by_path[f"{name}_4_seeds"] = train_launches
        rows43[name] = {"env_steps_per_s": rate, "one_seed_env_steps_per_s": one_seed_rate,
                        "ratio": rate / one_seed_rate, "train_s": train_s, "launches": train_launches,
                        "eval_returns": returns.ravel().tolist()}
        print(f"parallel seeds {name}: {seeds43} seeds x 1024 envs, batch {batch_size} a seed, {prefill} prefill + {steps43} "
              f"learning steps in {train_s:.2f} s (evaluation apart): {rate:.0f} env-steps/s summed over seeds "
              f"against {one_seed_rate:.0f} of one seed, x{rate / one_seed_rate:.2f}; launches "
              f"{train_launches}" + (f", every projection at [{seeds43 * batch_size}, 101]" if b3_an_update else "")
              + f"; eval returns per seed {[float(f'{r:.3g}') for r in returns.ravel().tolist()]}")
        del model
    for m, projection in projections.items():
        m.categorical_projection_dense = projection
    print("parallel seeds, twelve families: " + json.dumps(rows43))

    # seed 1 of a 3-seed run is its one-seed run (``c3_checks``): REDQ
    # (per-seed subsets) and FlashSAC (BatchNorm statistics) in float64 on
    # the Pendulum, where rounding leaves ~1e-12 on any draw stream; and
    # FlashSAC's first gradients in f32 on the Ant, B2 and B3 on the folded
    # rows, before Adam amplifies their rounding
    t0 = time.perf_counter()
    c3 = c3_checks("cuda")
    for name in ("redq", "flashsac"):
        if not c3[f"{name}_float64_max_abs_err"] <= 1e-9:
            fail(f"C3: {name}'s seed 1 of 3 in float64 is {c3[f'{name}_float64_max_abs_err']:.3g} from its one-seed run")
        if not c3[f"{name}_float64_seed2_mean_abs_err"] >= 1e-3:
            fail(f"C3: {name}'s seed 2 stands within {c3[f'{name}_float64_seed2_mean_abs_err']:.3g} (mean) of seed 1's "
                 f"one-seed run")
    for name in ("policy", "alpha"):
        if not c3[f"flashsac_first_{name}_grad_rel_err"] <= 1e-5:
            fail(f"C3: FlashSAC's first {name} gradients of seed 1 of 3 are "
                 f"{c3[f'flashsac_first_{name}_grad_rel_err']:.3g} (relative) from its one-seed run's")
        if not c3[f"flashsac_first_{name}_grad_seed2_rel_err"] >= 1e-3:
            fail(f"C3: FlashSAC's first {name} gradients of seed 2 stand near seed 1's one-seed run's")
    print(f"C3: seed 1 of 3 in float64 on the Pendulum after 4 learning steps (64 envs, batch 128) against its "
          f"one-seed run, max|err| over every parameter and running statistic: REDQ (10 critic updates a step) "
          f"{c3['redq_float64_max_abs_err']:.3g} over {c3['redq_float64_values']} values, FlashSAC (B3's plain "
          f"version: B3 takes f32 only) {c3['flashsac_float64_max_abs_err']:.3g} over {c3['flashsac_float64_values']} "
          f"values (limit 1e-9); seed 2 against the same runs: mean |err| {c3['redq_float64_seed2_mean_abs_err']:.3g} "
          f"and {c3['flashsac_float64_seed2_mean_abs_err']:.3g}; FlashSAC seed 1 of 3 on the Ant (f32), the first "
          f"update's gradients against the one-seed run's, max|err| / max|grad|: policy "
          f"{c3['flashsac_first_policy_grad_rel_err']:.3g}, alpha {c3['flashsac_first_alpha_grad_rel_err']:.3g} (before "
          f"any Adam step; limit 1e-5), critic {c3['flashsac_first_critic_grad_rel_err']:.3g} (after the policy's "
          f"first step); seed 2 against the same run: policy {c3['flashsac_first_policy_grad_seed2_rel_err']:.3g}; "
          f"{time.perf_counter() - t0:.1f} s")

    # B3 at FastSAC's and FlashSAC's 4-seed shapes, B2 at the 4 x 1024 envs
    for label, (n, v_lo, v_hi, gamma) in {
        f"[{seeds43 * 8192}, 101] -> 101 (FastSAC, {seeds43} seeds)": (seeds43 * 8192, -10.0, 10.0, 0.99),
        f"[{seeds43 * 512}, 101] -> 101 (FlashSAC, {seeds43} seeds)": (seeds43 * 512, -5.0, 5.0, 0.99),
    }.items():
        z, p = entropy_shifted_targets(n, v_lo, v_hi, gamma)
        project = lambda: categorical_projection_cuda(z, p, v_lo, v_hi, 101)
        out, ref = project(), categorical_projection_reference(z, p, v_lo, v_hi, 101)
        torch.cuda.synchronize()
        err = max_err([out], [ref], 1e-6, 1e-6, f"projection {label}")
        t = kernel_times(project, lambda: categorical_projection_reference(z, p, v_lo, v_hi, 101), "projection_kernel")
        t["bound_ms"], t["bound_by"] = roofline(projection_bytes(n, 101, 101), projection_flops(n, 101))
        kernels[2]["by_shape"][label] = {**t, "max_abs_err": err}
        kernels[2]["max_abs_err"] = max(kernels[2]["max_abs_err"], err)
        print(f"B3 projection at {label}: max|err| {err:.3g} (rtol=atol=1e-6), kernel {t['ms']:.4f} ms (device "
              f"{t['device_ms']:.4f} ms, host {t['host_us']:.1f} us a call) plain {t['plain_ms']:.3f} ms bound "
              f"{t['bound_ms']:.6f} ms ({t['bound_by']})")
    B = seeds43 * 1024
    qpos, qvel, ctrl = ant_batch(ant, B)
    out = step_cuda(ant, qpos, qvel, ctrl, nr_substeps=4)
    ref = engine.step_reference(ant, qpos, qvel, ctrl, nr_substeps=4)
    torch.cuda.synchronize()
    err = max_err(out, ref, 1e-4, 1e-4, f"substep (Ant, B={B})")
    t = kernel_times(lambda: step_cuda(ant, qpos, qvel, ctrl, nr_substeps=4),
                     lambda: engine.step_reference(ant, qpos, qvel, ctrl, nr_substeps=4), "engine_substep_kernel",
                     reps=100)
    t["bound_ms"], t["bound_by"] = roofline(substep_bytes(ant, B, with_anchors=False), substep_flops(ant) * B * 4)
    kernels[1]["by_shape"][f"Ant B={B} (off-policy, {seeds43} seeds x 1024)"] = {**t, "max_abs_err": err}
    kernels[1]["max_abs_err"] = max(kernels[1]["max_abs_err"], err)
    print(f"B2 engine_substep at B={B} ({seeds43} seeds x 1024), 4 substeps: max|err| {err:.3g} (rtol=atol=1e-4), "
          f"kernel {t['ms']:.4f} ms (device {t['device_ms']:.4f} ms, host {t['host_us']:.1f} us a call) plain "
          f"{t['plain_ms']:.2f} ms bound {t['bound_ms']:.5f} ms ({t['bound_by']})")
    print(f"phase 43 took {time.perf_counter() - phase_t0:.1f} s")

    # 44. parallel seeds on the robot and soccer envs: 4-seed PPO-LSTM on the
    # plane quadruped and on soccer at 4 x 1024 envs x 32 steps
    phase_t0 = time.perf_counter()
    rows44 = robot_parallel_seeds(kernels, launches_by_path)
    print("parallel seeds, robot and soccer: " + json.dumps(rows44))
    print(f"phase 44 took {time.perf_counter() - phase_t0:.1f} s")

    # 45. rendering's device half: rollout_qpos through B2 against the CPU
    phase_t0 = time.perf_counter()
    render_device_half(launches_by_path, workdir.name)
    print(f"phase 45 took {time.perf_counter() - phase_t0:.1f} s")

    # 46. the dp mesh: 2 gloo ranks on the one card, and a one-rank NCCL group
    phase_t0 = time.perf_counter()
    mesh_phase(launches_by_path, workdir.name)
    print(f"phase 46 took {time.perf_counter() - phase_t0:.1f} s")

    # 47. deployment: the Go2 runner and the soccer export from checkpoints
    # trained on the card, and the playground adapter over a stub
    phase_t0 = time.perf_counter()
    rows47 = deployment_phase(kernels, launches_by_path, workdir.name)
    print("deployment: " + json.dumps(rows47))
    print(f"phase 47 took {time.perf_counter() - phase_t0:.1f} s")

    for k in kernels:
        by_path = {path: counts[k["name"]]
                   for path, counts in launches_by_path.items() if k["name"] in counts}
        k["launches"] = sum(by_path.values())
        k["launches_by_path"] = by_path
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
