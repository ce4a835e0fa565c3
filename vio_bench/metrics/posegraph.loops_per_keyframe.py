"""Loops closed a keyframe: the calls of the Timer `posegraph.solve` (one
for each loop candidate verified and accepted) over those of `3.3 posegraph`
(one a keyframe) in the window; it falls when a change loses closures.
0 where the program keeps the layer's Timers (`posegraph.query`, one a
keyframe) and closed no loop; nothing on a commit without them, or where
the layer did not run."""


def read(record):
    n = (record or {}).get("stages_n", {})
    if not n.get("3.3 posegraph") or "posegraph.query" not in n:
        return None
    return n.get("posegraph.solve", 0) / n["3.3 posegraph"]
