"""Full EuRoC benchmark sweep: run the pipeline over all 11 MAV sequences
(port of okvis_tpu.apps.euroc_sweep).

The accuracy protocol of the EuRoC benchmark (sequences MH_01..V2_03,
evaluated as ATE RMSE against the Vicon/Leica ground truth, Leutenegger et
al. IJRR'15):

    python -m okvis_tpu_torch.apps.euroc_sweep <config.yaml> <euroc_root> \
        [--sequences MH_01_easy,V1_02_medium] [--out sweep.json]

<euroc_root> holds one directory per sequence (each containing mav0/).
Sequences missing on disk are reported as "missing" and skipped, so the
sweep completes on whatever subset exists. Prints one row per sequence and
a final JSON summary with per-sequence ATE RMSE [m], frames/s, and the mean
and median ATE. `device` (--device) is passed to run_euroc.run: None means
the CUDA card. Without --out-dir the trajectories go to the system's
temporary directory.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

# the canonical 11-sequence EuRoC MAV benchmark set
EUROC_SEQUENCES = (
    "MH_01_easy",
    "MH_02_easy",
    "MH_03_medium",
    "MH_04_difficult",
    "MH_05_difficult",
    "V1_01_easy",
    "V1_02_medium",
    "V1_03_difficult",
    "V2_01_easy",
    "V2_02_medium",
    "V2_03_difficult",
)


def find_mav0(root: str, seq: str) -> str | None:
    """Accept <root>/<seq>/mav0, or <root>/<seq> already shaped as mav0."""
    cand = os.path.join(root, seq, "mav0")
    if os.path.isdir(cand):
        return cand
    direct = os.path.join(root, seq)
    if os.path.isdir(os.path.join(direct, "cam0")):
        return direct
    return None


def sweep(
    config,
    euroc_root: str,
    sequences=EUROC_SEQUENCES,
    skip_sec: float = 0.0,
    max_frames: int = 0,
    out_dir: str = None,
    loop_closure: bool = False,
    device=None,
) -> dict:
    from .run_euroc import run

    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
    results = {}
    for seq in sequences:
        mav0 = find_mav0(euroc_root, seq)
        if mav0 is None:
            results[seq] = {"status": "missing"}
            print(f"{seq:18s}  MISSING ({euroc_root}/{seq})", file=sys.stderr)
            continue
        traj = (os.path.join(out_dir, f"{seq}.tum") if out_dir
                else os.path.join(tempfile.gettempdir(), f"okvis_tpu_torch_{seq}.tum"))
        try:
            r = run(
                config,
                mav0,
                skip_sec=skip_sec,
                max_frames=max_frames,
                trajectory_out=traj,
                loop_closure=loop_closure,
                device=device,
            )
            results[seq] = {
                "status": "ok",
                "ate_rmse_m": r.get("ate_rmse_m"),
                "frames_per_s": r.get("frames_per_s"),
                "frames_processed": r.get("frames_processed"),
                "trajectory": traj,
            }
            ate = r.get("ate_rmse_m")
            ate_s = f"{ate:.4f} m" if ate is not None else "n/a (no GT)"
            print(f"{seq:18s}  ATE {ate_s}  {r.get('frames_per_s', 0):.1f} f/s", file=sys.stderr)
        except Exception as e:  # one bad sequence must not end the sweep
            results[seq] = {"status": "error", "error": repr(e)}
            print(f"{seq:18s}  ERROR {e!r}", file=sys.stderr)

    ates = [v["ate_rmse_m"] for v in results.values()
            if v.get("status") == "ok" and v.get("ate_rmse_m") is not None]
    return {
        "sequences": results,
        "n_ok": sum(1 for v in results.values() if v["status"] == "ok"),
        "n_missing": sum(1 for v in results.values() if v["status"] == "missing"),
        "ate_mean_m": (sum(ates) / len(ates)) if ates else None,
        "ate_median_m": (sorted(ates)[len(ates) // 2]) if ates else None,
    }


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("config")
    p.add_argument("euroc_root")
    p.add_argument("--sequences", default=",".join(EUROC_SEQUENCES),
                   help="comma-separated subset (default: all 11)")
    p.add_argument("--skip-sec", type=float, default=0.0)
    p.add_argument("--max-frames", type=int, default=0)
    p.add_argument("--out-dir", default=None, help="directory for .tum trajectories")
    p.add_argument("--loop-closure", action="store_true")
    p.add_argument("--device", default=None, help="torch device (default: the CUDA card; 'cpu' for the CPU)")
    p.add_argument("--out", default=None, help="write the JSON summary here too")
    args = p.parse_args(argv)

    summary = sweep(
        args.config,
        args.euroc_root,
        sequences=tuple(s.strip() for s in args.sequences.split(",") if s.strip()),
        skip_sec=args.skip_sec,
        max_frames=args.max_frames,
        out_dir=args.out_dir,
        loop_closure=args.loop_closure,
        device=args.device,
    )
    line = json.dumps(summary)
    print(line)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return summary


if __name__ == "__main__":
    main()
