#!/usr/bin/env python3
"""Spread of the port's optimize_window over repeated runs on one CUDA card.

    python3 scripts/torch_backend_spread.py [--runs 20]

Builds chip_smoke.py's back-end window (BACKEND_WINDOW, float32 on the
card, perturbed with numpy seed 7) and runs each optimize variant of
chip_smoke.OPTIMIZE_GATES `--runs` times on the same inputs. `index_add`
sums with atomics, so each run adds in another order; the script prints,
per variant, the min, median and max of the final position, orientation
and speed/bias errors against ground truth and of the final cost, and the
distinct accept patterns. Needs a card; it raises without one.
"""

import argparse
import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import chip_smoke  # noqa: E402
from okvis_tpu_torch.solver import optimize_window  # noqa: E402


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--runs", type=int, default=20)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_backend_spread: needs a CUDA device")
    cfg, imu, intr, problem, truth = chip_smoke.build_window("cuda", torch.float32)
    S = cfg.num_states
    for name in chip_smoke.OPTIMIZE_GATES:
        c = chip_smoke.cfg_of(name, cfg)
        errs, patterns = [], set()
        for _ in range(args.runs):
            states, diag = optimize_window(c, imu, intr, problem)
            r, a = chip_smoke.pose_errors(states, truth["r_WS"], truth["q_WS"])
            sb = float((states.speed_and_bias[:S].cpu().double() - torch.as_tensor(truth["sb"])).abs().max())
            errs.append((r, a, sb, float(diag.final_cost)))
            patterns.add("".join("1" if x else "0" for x in diag.accepted.cpu().tolist()))
        e = np.asarray(errs)
        print(json.dumps(dict(
            variant=name, runs=args.runs, columns=["position", "orientation", "speed_bias", "final_cost"],
            min=e.min(0).tolist(), median=np.median(e, 0).tolist(), max=e.max(0).tolist(),
            accept_patterns=sorted(patterns), device=torch.cuda.get_device_name(0))))


if __name__ == "__main__":
    main()
