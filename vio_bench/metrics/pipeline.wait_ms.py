"""Host ms a frame outside the pipeline's stages: the Timing entry `frame`
(okvis_tpu_torch's ThreadedVio: each frame's first add_image to its state's
publication) less the pipeline's stage Timers, their totals over the
window's frames: waits for the IMU, queues and hand-offs between the
threads, and the host work between stages. A frame's stages run one after
another inside it, so their sum is their union. Nothing where the program
keeps no `frame` entry."""

STAGES = ("1.x detectAndDescribe", "2.1 addStates", "2.4 matching", "3.1 optimization", "3.2 marginalization",
          "3.3 posegraph")


def read(record):
    if not record or not record.get("frames") or "frame" not in record["stages_s"]:
        return None
    st = record["stages_s"]
    return 1e3 * (st["frame"] - sum(st.get(k, 0.0) for k in STAGES)) / record["frames"]
