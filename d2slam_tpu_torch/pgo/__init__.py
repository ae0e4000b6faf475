"""Pose-graph optimization: dense LM (``pose_graph``), matrix-free LM +
PCG (``pcg``), PCM loop-outlier rejection (``pcm``) and g2o I/O."""
from d2slam_tpu_torch.pgo.g2o_io import read_g2o, write_g2o
from d2slam_tpu_torch.pgo.pcg import solve_pgo_pcg
from d2slam_tpu_torch.pgo.pose_graph import PGOEdges, PGOLayout, PGOReport, PGOState, solve_pgo

__all__ = ["PGOEdges", "PGOLayout", "PGOReport", "PGOState", "read_g2o", "solve_pgo",
           "solve_pgo_pcg", "write_g2o"]
