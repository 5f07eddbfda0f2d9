"""Runner config namespace."""

from rlx_tpu_torch.utils.config_dict import ConfigDict


def get_config():
    return ConfigDict(
        mode="train",
        track_console=False,
        project_name="rlx_tpu_torch",
        exp_name="default",
        run_name="",
        # "cuda" (default) or "cpu"; a CUDA device runs the hand-written kernels
        device="cuda",
    )
