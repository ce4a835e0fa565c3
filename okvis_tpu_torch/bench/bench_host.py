"""Host-side cost per frame of the pipeline (port of scripts/bench_host.py).

The host bookkeeping (association input tables, match resolution, problem
assembly, the post-optimize update) is what a faster card cannot remove.
This tool runs the pipeline bench (bench_pipeline) at 400 keypoints a
camera, the reference's ceiling, on a 600-landmark world and reads that
run's `host:` Timing stages, as a total a frame over the steady frames.

    python -m okvis_tpu_torch.bench.bench_host [n_frames] [--device cpu] [--out PATH]
"""

from __future__ import annotations

from . import common

# stage -> the `host:` Timing names it reads; pure numpy/python bookkeeping
PURE = {
    "assoc input tables": "host: assoc tables (np)",
    "assoc match resolve": "host: assoc resolve (cpu)",
    "obs/problem tables": "host: obs table (np)",
    "post-optimize update": "host: optimize update",
}


def host_table(result: dict) -> dict:
    """The bookkeeping stages (ms a frame) of a pipeline bench result, their
    sum, and the upload/dispatch ms a frame inside the two build stages
    (the tensor construction around the numpy tables)."""
    h = result["host_stage_ms_per_frame"]
    pf = lambda name: h.get(name, 0.0)  # noqa: E731
    pure = {k: pf(v) for k, v in PURE.items()}
    upload = (pf("host: assoc build") - pf("host: assoc tables (np)")
              + pf("host: build problem") - pf("host: obs table (np)"))
    return dict(stages_ms_per_frame=pure, bookkeeping_ms_per_frame=sum(pure.values()),
                upload_dispatch_ms_per_frame=upload, keypoints=result["keypoints"],
                world_landmarks=result["world_landmarks"], frames=result["frames"], device=result["device"])


def print_table(table: dict) -> None:
    print(f"\nhost-side cost a frame ({table['keypoints']} keypoints a camera, {table['device']}):")
    for k, v in table["stages_ms_per_frame"].items():
        print(f"  {k:<24s} {v:7.3f} ms/frame")
    print(f"  pure host bookkeeping:   {table['bookkeeping_ms_per_frame']:7.3f} ms/frame")
    print(f"  upload/dispatch:         {table['upload_dispatch_ms_per_frame']:7.3f} ms/frame", flush=True)


def main(argv=None):
    from .bench_pipeline import WARMUP, run_pipeline_bench

    ap = common.parser(__doc__.splitlines()[0])
    ap.add_argument("n_frames", nargs="?", type=int, default=25)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    result = run_pipeline_bench(args.n_frames, max_keypoints=400, n_world_landmarks=600, device=args.device,
                                warmup=min(WARMUP, args.n_frames // 2), verbose=False)
    table = host_table(result)
    print_table(table)
    common.emit(dict(metric="host_bookkeeping_ms_per_frame", value=table["bookkeeping_ms_per_frame"],
                     unit="ms/frame", **table), args.out)


if __name__ == "__main__":
    main()
