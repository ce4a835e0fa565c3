"""Relative-pose solver study: batched 8-point against the host 5-point
(port of scripts/study_relpose.py).

Synthetic two-view sets sweep the correspondence count, the pixel noise and
the outlier share (numpy seed 99); both RANSAC paths score the same data:
ransac_relative_pose (64 hypotheses of uniform draws from a torch generator
seeded with the trial) on the device, ransac_relative_pose_5pt (50
iterations, seed = the trial) on the host. Per row: inlier recall, outlier
leakage and the rotation error of the decomposed best model (capped at 30
degrees), each a mean over the trials.

    python -m okvis_tpu_torch.bench.study_relpose [n_trials] [--device cpu]
"""

from __future__ import annotations

import numpy as np
import torch

from . import common

N_HYP = 64


def make_pair(rng, n, noise_px, out_frac, focal=460.0):
    n_out = int(round(out_frac * n))
    Pb = rng.uniform(-1, 1, (n, 3)) * [2, 2, 1] + [0, 0, 4]
    ang = rng.uniform(0.05, 0.3)
    ax = rng.normal(size=3)
    ax /= np.linalg.norm(ax)
    K = np.array([[0, -ax[2], ax[1]], [ax[2], 0, -ax[0]], [-ax[1], ax[0], 0]])
    R = np.eye(3) + np.sin(ang) * K + (1 - np.cos(ang)) * K @ K
    t = rng.uniform(-0.4, 0.4, 3)
    Pa = Pb @ R.T + t
    noise = noise_px / focal
    xa = Pa[:, :2] / Pa[:, 2:3] + rng.normal(0, noise, (n, 2))
    xb = Pb[:, :2] / Pb[:, 2:3] + rng.normal(0, noise, (n, 2))
    for i in range(n_out):
        xb[i] += rng.uniform(0.05, 0.3, 2) * rng.choice([-1, 1], 2)
    fa = np.concatenate([xa, np.ones((n, 1))], 1)
    fa /= np.linalg.norm(fa, axis=1, keepdims=True)
    fb = np.concatenate([xb, np.ones((n, 1))], 1)
    fb /= np.linalg.norm(fb, axis=1, keepdims=True)
    return fa, fb, R, n_out


def rot_err_deg(E, fa, fb, inl, R_gt) -> float:
    from ..frontend.ransac import decompose_essential

    t = lambda x: torch.as_tensor(np.asarray(x))  # noqa: E731
    R, _ = decompose_essential(t(E).reshape(3, 3).double(), t(fa), t(fb), t(inl))
    c = np.clip((np.trace(R.cpu().numpy().T @ R_gt) - 1) / 2, -1, 1)
    return float(np.degrees(np.arccos(c)))


def run(n_trials: int = 40, device=None, verbose: bool = True) -> dict:
    from ..frontend.fivepoint import ransac_relative_pose_5pt
    from ..frontend.ransac import ransac_relative_pose

    dev = common.resolve_device(device)
    rng = np.random.default_rng(99)
    focal, thr = 460.0, 9.0
    rows = []
    if verbose:
        print(f"{'N':>4s} {'noise':>6s} {'out%':>5s} | {'8pt recall':>10s} {'8pt leak':>9s} {'8pt rot°':>9s} | "
              f"{'5pt recall':>10s} {'5pt leak':>9s} {'5pt rot°':>9s}")
    for n in (10, 14, 20, 30, 50):
        for noise_px in (0.5, 1.0):
            for out_frac in (0.0, 0.3):
                m8, m5 = np.zeros(3), np.zeros(3)
                for trial in range(n_trials):
                    fa, fb, R_gt, n_out = make_pair(rng, n, noise_px, out_frac)
                    mask = np.ones(n, bool)
                    true_inl = np.ones(n, bool)
                    true_inl[:n_out] = False
                    u = torch.rand((N_HYP, 8), generator=torch.Generator().manual_seed(trial), dtype=torch.float64)
                    r8 = ransac_relative_pose(u.to(dev), torch.from_numpy(fa).to(dev), torch.from_numpy(fb).to(dev),
                                              torch.from_numpy(mask).to(dev), focal, thr)
                    inl8 = r8.inliers.cpu().numpy()
                    m8 += [inl8[true_inl].mean(), inl8[~true_inl].mean() if n_out else 0.0,
                           min(rot_err_deg(r8.model.cpu().numpy(), fa, fb, inl8, R_gt), 30.0)]
                    inl5, _, E5, _ = ransac_relative_pose_5pt(fa, fb, mask, focal=focal, threshold_px2=thr,
                                                              n_iters=50, seed=trial)
                    m5 += [inl5[true_inl].mean(), inl5[~true_inl].mean() if n_out else 0.0,
                           min(rot_err_deg(E5, fa, fb, inl5, R_gt), 30.0)]
                m8 /= n_trials
                m5 /= n_trials
                rows.append(dict(n=n, noise_px=noise_px, outlier_share=out_frac,
                                 eight_point=dict(recall=m8[0], leakage=m8[1], rotation_deg=m8[2]),
                                 five_point=dict(recall=m5[0], leakage=m5[1], rotation_deg=m5[2])))
                if verbose:
                    print(f"{n:>4d} {noise_px:>5.1f}px {100 * out_frac:>4.0f}% | {m8[0]:>10.2f} {m8[1]:>9.2f} "
                          f"{m8[2]:>9.2f} | {m5[0]:>10.2f} {m5[1]:>9.2f} {m5[2]:>9.2f}", flush=True)
    return dict(metric="relpose_study", device=common.device_name(dev), trials=n_trials, rows=rows)


def main(argv=None):
    ap = common.parser(__doc__.splitlines()[0])
    ap.add_argument("n_trials", nargs="?", type=int, default=40)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    common.emit(run(args.n_trials, args.device), args.out)


if __name__ == "__main__":
    main()
