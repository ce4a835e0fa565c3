"""Host ms a call in the Timing entry `posegraph.solve`
(okvis_tpu_torch.posegraph.manager): an accepted loop's pose-graph solve
(`graph.optimize`, float64 Levenberg-Marquardt, its host read of the poses,
and the world correction), its total over its count in the window. Nothing
where the program keeps no such entry, or closed no loop."""

STAGE = "posegraph.solve"


def read(record):
    n = (record or {}).get("stages_n", {}).get(STAGE)
    if not n:
        return None
    return 1e3 * record["stages_s"][STAGE] / n
