#!/usr/bin/env python3
"""What the runtime's threads cost on the card: the stage times of the
port's ThreadedVio on chip_smoke.py's runtime frames, with the feeder's
thread polling wait_idle while a frame is processed (as a user's loop
does), and with the feeder asleep until the frame is done (no thread but
the stages asks for the interpreter lock). Runs in turns: polling, asleep,
asleep, polling; each run feeds the 20 frames as chip_smoke.run_runtime
does, without callbacks, and reads the Timing table after two warm-up
frames. The difference between the two readings is what the feeder's
polling costs the stages; the rest of what chip_smoke.py's `runtime` line
puts over the vio phase lies in the stage threads themselves.

    python3 scripts/torch_runtime_threads.py        # needs a CUDA card

Prints one JSON line a run and a summary line with the card's name and
power limit.
"""

import json
import os
import statistics
import subprocess
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import torch  # noqa: E402

import chip_smoke  # noqa: E402
from okvis_tpu_torch.cameras.ncamera import NCameraSystem  # noqa: E402
from okvis_tpu_torch.datasets.synthetic import euroc_stereo_rig  # noqa: E402
from okvis_tpu_torch.pipeline import ThreadedVio  # noqa: E402
from okvis_tpu_torch.utils.ids import IdProvider  # noqa: E402
from okvis_tpu_torch.utils.time import ns_from_sec  # noqa: E402
from okvis_tpu_torch.utils.timing import Timing  # noqa: E402

ASLEEP_S = 2.5  # longer than a frame takes on the card (chip_smoke.py: about 1.2 s)


def run(scene, polling: bool) -> dict:
    specs, T_SC, intr = euroc_stereo_rig(device="cuda")
    rig = NCameraSystem(specs=specs, T_SC=T_SC, intrinsics=intr)
    rig.compute_overlaps()
    IdProvider.reset()
    vio = ThreadedVio(chip_smoke.runtime_params(), rig=rig, blocking=True, dtype=torch.float32)
    traj = scene.traj
    ts_ns = [int(ns_from_sec(t)) for t in traj.ts]
    imu_i, frame_ms = 0, []
    Timing.reset()
    for fi, (t, images) in enumerate(zip(scene.times, scene.images)):
        t_ns = int(ns_from_sec(t))
        while imu_i < len(ts_ns) and ts_ns[imu_i] <= t_ns + 25_000_000:
            vio.add_imu_measurement(ts_ns[imu_i], traj.gyro[imu_i], traj.acc[imu_i])
            imu_i += 1
        t0 = time.perf_counter()
        for c, image in enumerate(images):
            vio.add_image(t_ns, c, image)
        if not polling:
            time.sleep(ASLEEP_S)
        vio.wait_idle(timeout=120)
        frame_ms.append(1e3 * (time.perf_counter() - t0))
        if fi == 1:
            Timing.reset()
    vio.shutdown()
    stages = {name: 1e3 * Timing.mean(name) for name in chip_smoke.RUNTIME_STAGES}
    return dict(polling=polling, stages_mean_ms=stages, stages_sum_ms=sum(stages.values()),
                frame_ms_median=statistics.median(frame_ms[2:]) if polling else None,
                frames=len(vio.trajectory))


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_runtime_threads: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    scene = chip_smoke.vio_scene()
    run(scene, True)  # warm-up: kernels, allocator, cuBLAS
    rows = [run(scene, polling) for polling in (True, False, False, True)]
    for r in rows:
        print(json.dumps(r))
    poll = [r["stages_sum_ms"] for r in rows if r["polling"]]
    asleep = [r["stages_sum_ms"] for r in rows if not r["polling"]]
    print(json.dumps(dict(card=smi, stages_sum_ms_polling=poll, stages_sum_ms_asleep=asleep,
                          polling_cost_ms=statistics.fmean(poll) - statistics.fmean(asleep))))
    return 0


if __name__ == "__main__":
    sys.exit(main())
