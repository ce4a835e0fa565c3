"""Host ms a frame in the estimator's Timing entry `preintegrate` (the
batched re-preintegration of the IMU links, in the optimize's problem build
and in the marginalization's), its total over the window's frames; nothing
where the program keeps no such entry."""

STAGE = "preintegrate"


def read(record):
    if not record or not record.get("frames") or STAGE not in record["stages_s"]:
        return None
    return 1e3 * record["stages_s"][STAGE] / record["frames"]
