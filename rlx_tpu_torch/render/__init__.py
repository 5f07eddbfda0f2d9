from rlx_tpu_torch.render.offscreen import OffscreenRenderer, VideoWriter, render_rollout

__all__ = ["OffscreenRenderer", "VideoWriter", "render_rollout"]
