"""Phase n.3 of ``chip_smoke.py`` alone on the card, with the landmarks
each robot unified.

    python tests/diag_distributed_full.py [--root DIR] [--runs N]

Runs ``distributed_full_run`` (two robots at 480x640 in phase m's
textured room, ``estimation_mode="distributed"`` with DPGO, a server)
of the ``chip_smoke.py`` under ``--root`` (default: this checkout; an
unpacked older commit compares the two, one process each) ``--runs``
times, and prints one JSON line per run: the phase's readings, each
robot's VIO ATE, the remote landmark ids each robot unified with one of
its own (``SwarmManager.lm_unify``) and the remote landmarks whose
estimator key fused with an own track (``D2SLAMSystem._lm_key``). Needs
a card.
"""
import argparse
import json
import os
import sys

ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
ap.add_argument("--root", default=os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))
ap.add_argument("--runs", type=int, default=1)
args = ap.parse_args()
root = os.path.abspath(args.root)
sys.path.insert(0, root)
sys.argv = [os.path.join(root, "chip_smoke.py")]

import chip_smoke as cs  # noqa: E402
import torch  # noqa: E402

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
made = []


class Recorded(cs.D2SLAMSystem):
    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        made.append(self)


cs.D2SLAMSystem = Recorded
params = cs.load_params(cs.WEIGHTS)
for run in range(args.runs):
    made.clear()
    res = cs.distributed_full_run(params, torch.device("cuda"))
    robots = [s for s in made if s.drone_id in (0, 1)]
    print(json.dumps(dict(
        root=root, run=run, shared_keys=res["shared_keys"], inter_loops=res["inter_loops"],
        duals=res["duals"], finite=res["finite"], wall_s=res["wall_s"],
        vio_ate_m=[r["vio_ate_m"] for r in res["robots"]],
        unified=[sum(1 for k, v in s.swarm.lm_unify.items()
                     if k[0] != s.drone_id and v[0] == s.drone_id) for s in robots],
        fused=[sum(1 for o, k in s._lm_key_pin.items() if o != k) for s in robots])),
        flush=True)
