"""The control of a cell's check, and the faults it is held against, on
the card: the plain reference put in the program's place at the next
lower precision than the configuration states, or the program with a
fault planted under its timed path, run as the cell runs.

    python -m portbench.control --workload <cell> --seeds 1,2,3 --seconds 30
    python -m portbench.control --workload <cell> --seeds 1,2,3 --seconds 30 --fault nms_off

For the VIO cells the extraction's numbers come from SuperPoint in fp8
(the configuration states bf16), and where the configuration states a
float64 estimator the run uses the port's own float32 estimator path;
for the depth cell the reference's remap and block matching run in
bfloat16 (the configuration's float32). The faults: ``kp_shift``, the
detector's keypoints moved by 2 px; ``nms_off``, the detector's
non-maximum suppression left out; ``frozen``, the estimator returning
the odometry of its first keyframe from then on. Each seed prints one
line of the numbers beside their limits. The benchmark's runs never run
this; the limits in ``limits/`` are set between these readings and the
program's.
"""
from __future__ import annotations

import argparse
import json
import sys


def _kp_shift():
    from d2slam_tpu_torch.frontend import tracker
    inner = tracker.superpoint_extract

    def shifted(model, img):
        out = inner(model, img)
        return out._replace(kpts=out.kpts + 2.0)

    tracker.superpoint_extract = shifted


def _nms_off():
    from d2slam_tpu_torch.frontend import superpoint
    superpoint.simple_nms = lambda scores, radius: scores


def _frozen(st):
    est = st.system.estimator
    inner, first = est.input_frame, []

    def frozen(ff):
        od = inner(ff)
        if od is not None and not first:
            first.append(od)
        return first[0] if first else od

    est.input_frame = frozen


# name -> (planted before set-up, or None; planted on the state after it, or None)
FAULTS = {"kp_shift": (_kp_shift, None), "nms_off": (_nms_off, None), "frozen": (None, _frozen)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--fault", choices=sorted(FAULTS))
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("portbench.control: no CUDA card", file=sys.stderr)
        return 1
    from portbench import harness

    entry = harness.cell_entry(harness.benchmark(), args.workload)
    config = harness.load_json(harness.PB_DIR, "configs", entry["config"] + ".json")
    overrides, before, after = {}, None, None
    if args.fault:
        before, after = FAULTS[args.fault]
    elif config.get("dtype") == "float64":
        overrides = {"config": {"dtype": "float32"}}
    if before is not None:
        before()
    for seed in (int(s) for s in args.seeds.split(",")):
        out = harness.run_cell(args.workload, seed, args.seconds, False, "cuda",
                               harness.boottime(), overrides=overrides, fault=after,
                               control=not args.fault, log=lambda s: print(s, flush=True))
        print(json.dumps({"control": args.workload, "fault": args.fault, "seed": seed,
                          "correct": out["correct"], "checks": out["checks"],
                          "metrics": out["metrics"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
