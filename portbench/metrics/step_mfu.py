"""The whole step's share of the card's peak, in %: the frames completed
in the traced window times the least time the card could take for a
frame's known work (the driver's ``frame_work_s``: the networks of a VIO
frame at their dtypes' peaks, the two block-matching passes of a depth
frame), over the traced window. A kernel that leaves the path leaves its
roofline silent; this share still bounds the step."""


def read(run):
    t, w = run.trace, run.stats.get("frame_work_s")
    if t is None or not t.frames or not w or t.window_s <= 0:
        return None
    return 100.0 * t.frames * w / t.window_s
