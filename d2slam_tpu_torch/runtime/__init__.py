"""The integrated per-robot node (``system.D2SLAMSystem``, single-robot
mode)."""
from d2slam_tpu_torch.runtime.system import D2SLAMSystem, SystemConfig, image_embedding_gdesc

__all__ = ["D2SLAMSystem", "SystemConfig", "image_embedding_gdesc"]
