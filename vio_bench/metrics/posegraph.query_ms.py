"""Host ms a call in the Timing entry `posegraph.query`
(okvis_tpu_torch.posegraph.manager): the keyframe database's retrieval
(`db.query`: one Hamming launch over the whole database, the votes and
scores, and its two host reads), its total over its count in the window.
Nothing where the program keeps no such entry."""

STAGE = "posegraph.query"


def read(record):
    n = (record or {}).get("stages_n", {}).get(STAGE)
    if not n:
        return None
    return 1e3 * record["stages_s"][STAGE] / n
