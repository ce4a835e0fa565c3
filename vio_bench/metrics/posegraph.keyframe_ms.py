"""Host ms a keyframe in the Timing stage `3.3 posegraph` (okvis_tpu_torch's
ThreadedVio: the pose-graph layer's whole call on a keyframe, the hand-off,
retrieval, verification, solve and insert; its fetches are blocking, so
the device's time is inside it), its total over its count in the window;
nothing where the layer did not run."""

STAGE = "3.3 posegraph"


def read(record):
    n = (record or {}).get("stages_n", {}).get(STAGE)
    if not n:
        return None
    return 1e3 * record["stages_s"][STAGE] / n
