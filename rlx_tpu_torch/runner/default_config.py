"""Runner config namespace (the JAX package's keys that the port runs;
wandb and the JAX set-up keys are left out, so setting one raises
``KeyError``).  ``track_tb`` writes TensorBoard scalars under
``<run path>/tb`` (``tensorboardX``, imported only then);
``matmul_precision`` is the counterpart of the JAX package's
``jax_default_matmul_precision`` (``config.MATMUL_PRECISIONS``).
``render_video`` / ``render_interactive`` are test mode's viewers
(``render/``); ``mesh_dp`` / ``mesh_tp`` / ``coordinator_address`` the
``torch.distributed`` mesh (``parallel/mesh.py``: one process per device,
launched by ``torchrun``; at one process nothing changes).

One default differs from the JAX package's on purpose: ``device`` is
``"cuda"``, where JAX's ``""`` means "the default backend".  The port runs
on the card unless the caller asks for the CPU with ``device="cpu"``, and
never falls back to it: without a card a run with the default device fails
instead of training on the CPU unnoticed.
"""

from rlx_tpu_torch.utils.config_dict import ConfigDict


def get_config():
    return ConfigDict(
        mode="train",
        track_console=False,
        track_tb=False,
        project_name="rlx_tpu_torch",
        exp_name="default",
        run_name="",
        save_model=False,
        load_model="",
        # include optimizer state and step counters in the checkpoint, so an
        # interrupted run restores exactly
        save_optimizer_state=False,
        nr_test_episodes=10,
        render_video="",  # test mode: offscreen rollout video (.mp4 or PNG dir)
        render_interactive=False,  # test mode: GLFW window (needs GL + display)
        # accepted for the JAX package's command lines: the eager port always
        # runs one host call per eval/save iteration (training_program.py)
        chunked_train=False,
        # write a torch.profiler Chrome trace of train() into this directory
        profile_dir="",
        # "cuda" (default; no fallback, see above) or "cpu"; a CUDA device
        # runs the hand-written kernels
        device="cuda",
        # float32 matrix products: "float32" (the port's default, exact f32
        # products, the precision the parity tests hold), "tensorfloat32" or
        # "bfloat16" (the JAX package's default); see config.MATMUL_PRECISIONS
        matmul_precision="float32",
        # device mesh ("dp", "tp"); dp = -1 means every rank of the group
        mesh_dp=-1,
        mesh_tp=1,
        # the process group's rendezvous (host:port or a tcp:// / file:// URL);
        # "" reads torchrun's MASTER_ADDR / MASTER_PORT
        coordinator_address="",
    )
