"""What the pipeline's tracing costs when on: the benchmark's untraced run
(vio_bench.harness.run) of each cell with ThreadedVio.set_tracing off and
on, in turns (off, on, then on, off for the next seed), one process a run.

    python3 scripts/torch_tracing_cost.py [--cells c ...] [--seeds n ...] [--seconds s]

Needs a CUDA card. Prints one JSON line a run ({cell, seed, tracing,
frames_per_s, frame_ms.p90, correct}) and one summary line a cell (the
medians and each side's runs).
"""

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def one(cell: str, seed: int, seconds: float, tracing: bool) -> dict:
    import torch

    sys.path.insert(0, ROOT)
    from vio_bench import harness

    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[var] = "1"
    prepare = (lambda vio: vio.set_tracing(True)) if tracing else None
    result, _ = harness.run(cell, seed, seconds, False, time.perf_counter(), device="cuda", prepare=prepare)
    m = result["metrics"]
    return dict(cell=cell, seed=seed, tracing=tracing, frames_per_s=m["frames_per_s"]["value"],
                frame_ms_p90=m["frame_ms.p90"]["value"], correct=result["correct"],
                device=torch.cuda.get_device_name(0))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cells", nargs="+", default=["euroc_stereo.lap", "euroc_mono.lap", "euroc_stereo.spin"])
    ap.add_argument("--seeds", nargs="+", type=int, default=[2147101001, 2147101002, 2147101003])
    ap.add_argument("--seconds", type=float, default=51.0)
    ap.add_argument("--one", nargs=3, metavar=("CELL", "SEED", "TRACING"), help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.one:
        cell, seed, tracing = args.one
        print(json.dumps(one(cell, int(seed), args.seconds, tracing == "1")), flush=True)
        return 0
    for cell in args.cells:
        runs = []
        for i, seed in enumerate(args.seeds):
            for tracing in ((False, True) if i % 2 == 0 else (True, False)):
                out = subprocess.run([sys.executable, os.path.abspath(__file__), "--seconds", str(args.seconds),
                                      "--one", cell, str(seed), "1" if tracing else "0"],
                                     cwd=ROOT, capture_output=True, text=True)
                if out.returncode != 0:
                    print(out.stderr[-3000:], file=sys.stderr)
                    return out.returncode
                runs.append(json.loads(out.stdout.strip().splitlines()[-1]))
                print(json.dumps(runs[-1]), flush=True)
        side = {t: [r["frames_per_s"] for r in runs if r["tracing"] == t] for t in (False, True)}
        print(json.dumps(dict(cell=cell, off=side[False], on=side[True],
                              median_off=statistics.median(side[False]), median_on=statistics.median(side[True]),
                              on_over_off=statistics.median(side[True]) / statistics.median(side[False]))),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
