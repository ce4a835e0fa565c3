"""Host ms a call in the Timing entry `posegraph.verify`
(okvis_tpu_torch.posegraph.manager): the geometric verification of a loop
candidate (the query padded, the matching and the 3D-2D RANSAC, and its
host read), its total over its count in the window. Nothing where the
program keeps no such entry, or verified no candidate."""

STAGE = "posegraph.verify"


def read(record):
    n = (record or {}).get("stages_n", {}).get(STAGE)
    if not n:
        return None
    return 1e3 * record["stages_s"][STAGE] / n
