"""Arithmetic shared by the metric readers."""


def roofline(run, label: str):
    """100 x (the least time of the work of the calls in range ``label``)
    / (their device time), from the traced part of the window; None where
    the range launched nothing on the card."""
    t = run.trace
    if t is None:
        return None
    dev_s = t.range_device_s.get(label, 0.0)
    work = run.probes.range_work.get(label, [])
    if dev_s <= 0 or not work:
        return None
    return 100.0 * sum(work) / dev_s
