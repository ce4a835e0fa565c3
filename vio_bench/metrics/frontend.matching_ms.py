"""Host ms a frame in the Timing stage `2.4 matching` (okvis_tpu_torch.utils.timing,
its span ends in a blocking fetch, so the device's time is inside it), its
total over the window's frames; nothing where the stage is not entered."""

STAGE = "2.4 matching"


def read(record):
    if not record or not record.get("frames") or STAGE not in record["stages_s"]:
        return None
    return 1e3 * record["stages_s"][STAGE] / record["frames"]
