"""The readings a configuration's limit is set from, on the card:

    python -m eqlb_bench.calibrate --config <config> --seeds 1 2 ... \\
        [--control-seeds 1 2 3] [--traffic strict]

In one process: the configuration's mesh and program as a run sets them
up, then per seed the load cases a run draws, each equilibrated once
through the timed call, and held to the plain reference as a run holds
them (``max_rel_err``, the lower reading over the seeds).  The control is
the same program in the nearest precision below the configuration's (the
engine in f32), on the same data (``max_rel_err`` of the control, the upper
reading).  One JSON line per reading.  The benchmark's runs never run it.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

from . import check, run
from .data import make_data
from .program import Program, sync
from .reference.kkt import Reference
from .reference.topology import Topology


def readings(config: dict, traffic: dict, seeds, control_seeds, device,
             emit=print) -> list[dict]:
    device = torch.device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    points, cells_ = run.make_mesh(config)
    topo = Topology(cells_, len(points))
    ref = Reference(points, cells_, config["degree"], topo=topo)
    programs = {"program": Program(config, points, cells_, device)}
    if control_seeds:
        programs["control"] = Program(config, points, cells_, device,
                                      dtype=torch.float32)
    out = []
    for seed in sorted(set(seeds) | set(control_seeds)):
        dp, dr = make_data(points, topo, config["degree"],
                           traffic["load_cases"], seed, device)
        t0 = time.perf_counter()
        x_ref = ref.solve(dp, dr)
        sync(device)
        t_ref = time.perf_counter() - t0
        for side, prog in programs.items():
            if seed not in (seeds if side == "program" else control_seeds):
                continue
            x = torch.cat([prog(dp[i:i + 1], dr[i:i + 1])
                           for i in range(dp.shape[0])])
            errs = check.row_errors(x, prog.facet_vertices(), ref, x_ref)
            line = {"config": config["name"], "side": side, "seed": seed,
                    "max_rel_err": max(errs), "rows": errs,
                    "reference_s": t_ref}
            emit(json.dumps(line))
            out.append(line)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", required=True)
    ap.add_argument("--traffic", default="strict")
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no result: no CUDA card", file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(here, "configs", f"{args.config}.json")) as f:
        config = dict(json.load(f), name=args.config)
    with open(os.path.join(here, "traffic", f"{args.traffic}.json")) as f:
        traffic = json.load(f)
    readings(config, traffic, args.seeds, args.control_seeds, "cuda",
             emit=lambda s: print(s, flush=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
