"""Dataset readers: the EuRoC-ASL directory layout and ROS1 bags."""
from d2slam_tpu_torch.datasets.euroc import EuRoCDataset
from d2slam_tpu_torch.datasets.rosbag import RosbagReader, RosbagWriter

__all__ = ["EuRoCDataset", "RosbagReader", "RosbagWriter"]
