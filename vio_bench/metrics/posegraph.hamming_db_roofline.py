"""The hamming kernel's share of its roofline at the keyframe database's
shapes (the pose graph's retrieval, (1, 400, 256 x 400) at the default
capacities) over the window: the sum over its launches of the bound
(vio_bench/kernels.py's hamming_bound_s: the larger of bytes over the memory
rate and operations over the fastest route) over the sum of their times,
each launch shape the window made timed alone with CUDA events."""

KERNEL = "hamming_db"


def read(record):
    rows = (record or {}).get("kernels", {}).get(KERNEL) or []
    spent = sum(r["count"] * r["time_s"] for r in rows)
    if not spent:
        return None
    return 100.0 * sum(r["count"] * r["bound_s"] for r in rows) / spent
