"""Multi-robot programs with the robots as a batch dimension."""
from d2slam_tpu_torch.parallel.consensus import (
    ConsensusCarry,
    admm_vio_round,
    build_consensus_rows,
    consensus_average,
    dual_update,
)
from d2slam_tpu_torch.parallel.mesh import RobotMesh, robot_mesh

__all__ = ["ConsensusCarry", "RobotMesh", "admm_vio_round", "build_consensus_rows",
           "consensus_average", "dual_update", "robot_mesh"]
