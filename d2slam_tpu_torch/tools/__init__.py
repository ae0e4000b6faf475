"""Tools: calibration, ONNX reading and lowering, int8 quantization, PCA."""
from d2slam_tpu_torch.tools.calibration import (
    calibrate_pinhole,
    calibrate_kb,
    calibrate_vignette,
)
