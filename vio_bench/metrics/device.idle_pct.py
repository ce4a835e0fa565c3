"""The card's idle share of a profiled stretch of frames after the window:
100 less the union of its operations' intervals (raw trace events) over the
stretch's wall."""


def read(record):
    tr = (record or {}).get("trace")
    if not tr or not tr["window_s"]:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
