"""Depth: fisheye undistortion, stereo disparity, HitNet, the quadcam pipeline."""
