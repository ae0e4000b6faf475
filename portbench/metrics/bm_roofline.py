"""The block matcher's share of its roofline, in %: the least time the
card could take for a frame's two SAD passes over its pairs (operations
against 33.5 T/s, bytes against 3.35 TB/s) over all the device time
launched inside the harness's range around ``disparity`` as
``depth/quadcam.py`` calls it, in the traced part of the window."""
from portbench.metrics_common import roofline


def read(run):
    return roofline(run, "disparity")
