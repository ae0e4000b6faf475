"""The SuperPoint stem's share of its roofline, in %: the least time the
card could take for the stem's work at each call's shape (bf16 FLOPs
against 989 TFLOP/s, bytes against 3.35 TB/s) over all the device time
launched inside the harness's range around ``superpoint_stem``, in the
traced part of the window."""
from portbench.metrics_common import roofline


def read(run):
    return roofline(run, "stem")
