#!/usr/bin/env python3
"""What reading a torch.profiler trace costs on the host, on the card: the
estimator loop of chip_smoke.py's estimator phase (ESTIMATOR_SCENARIO, the
default window, float32), 12 warm-up frames, then windows of 1, 2 and 5
frames under torch.profiler (CUDA activity alone, then CPU and CUDA). For
each window: the seconds of the profiled frames, of the profiler's exit, of
chip_smoke.device_kernels (the raw trace events) and of key_averages(), and
the launches and kernel ms each reads.

    python3 scripts/torch_profiler_cost.py

Needs the card; a few minutes.
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import torch  # noqa: E402
from torch.profiler import ProfilerActivity  # noqa: E402

import chip_smoke  # noqa: E402
from okvis_tpu_torch.cameras.ncamera import NCameraSystem  # noqa: E402
from okvis_tpu_torch.datasets.synthetic import euroc_stereo_rig, feed_estimator_frame  # noqa: E402
from okvis_tpu_torch.estimator import Estimator  # noqa: E402
from okvis_tpu_torch.imu import ImuParams  # noqa: E402


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("torch_profiler_cost: no CUDA device")
    frames, init = chip_smoke.estimator_frames()
    specs, T_SC, intr = euroc_stereo_rig(device="cuda")
    est = Estimator(NCameraSystem(specs=specs, T_SC=T_SC, intrinsics=intr), ImuParams.euroc(torch.float32, "cuda"),
                    5, 3, device="cuda", dtype=torch.float32)

    def step(f):
        feed_estimator_frame(est, f, init)
        est.optimize()
        est.apply_marginalization_strategy()
        torch.cuda.synchronize()

    for f in frames[:12]:
        step(f)
    nxt = 12
    for acts in ([ProfilerActivity.CUDA], [ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        for n in (1, 2, 5):
            prof = torch.profiler.profile(activities=acts)
            prof.__enter__()
            t0 = time.perf_counter()
            for f in frames[nxt: nxt + n]:
                step(f)
            nxt += n
            t1 = time.perf_counter()
            prof.__exit__(None, None, None)
            t2 = time.perf_counter()
            raw = chip_smoke.device_kernels(prof)
            t3 = time.perf_counter()
            ka = [e for e in prof.key_averages() if str(e.device_type).endswith("CUDA")]
            t4 = time.perf_counter()
            print(json.dumps(dict(
                activities=[str(a).split(".")[-1] for a in acts], frames=n, frames_s=t1 - t0, exit_s=t2 - t1,
                raw_events_s=t3 - t2, key_averages_s=t4 - t3, raw=dict(launches=raw[0], kernel_ms=raw[1]),
                key_averages=dict(launches=sum(e.count for e in ka),
                                  kernel_ms=sum(e.self_device_time_total for e in ka) / 1e3))), flush=True)


if __name__ == "__main__":
    main()
