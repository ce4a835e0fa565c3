"""Blocking host<->device round trips a frame of the processing loop (the
frame's critical path), from okvis_tpu_torch.utils.syncstats over the
window: the tags of bench_pipeline.py's PROC_SYNCS."""

PROC_SYNCS = ("associate_fetch", "optimize_fetch", "resolve_prop", "propagate_fetch", "ransac2d2d",
              "stereo_standalone", "lmq_fetch", "assoc_recovery")


def read(record):
    if not record or not record.get("frames"):
        return None
    return sum(record["syncs"].get(t, 0) for t in PROC_SYNCS) / record["frames"]
