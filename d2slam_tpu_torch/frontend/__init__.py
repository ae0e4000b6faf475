from d2slam_tpu_torch.frontend.lk import build_pyramid, lk_track_pyramidal

__all__ = ["build_pyramid", "lk_track_pyramidal"]
