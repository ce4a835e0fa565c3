"""Frontend orchestration: detection, data association, initialization
(port of okvis_tpu.frontend.frontend).

Host code orchestrates; the heavy work runs in the fixed-shape programs of
frontend.kernels on the rig's device:

- detect_and_describe(_multi) (Frontend.cpp:92-114; gravity-aligned
  extraction), single octave without detection masks;
- data_association_and_initialization (Frontend.cpp:117-271): match to the
  last ≤ 3 keyframes (3D-2D then 2D-2D), RANSAC outlier rejection, the
  keyframe decision, match to the last frame, stereo matching with
  triangulation, creating landmarks and observations in the estimator.

One association round is one call of kernels.associate_multicam (no host
sync inside) and one blocking fetch of its results through
Estimator.fetch_with_pending; the rare conflict-loser recovery round is one
more call. Every RANSAC draw goes through Frontend._draw, from a
torch.Generator on the rig's device seeded 7 (the JAX package seeds its key
with 7), in the JAX package's order of key splits, so a test can replay the
JAX draws; the five-point seed comes from a host generator.

Not ported: scale-space (detection_octaves > 0) and masked detection
(raise NotImplementedError).
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from .. import kinematics as kin
from ..cameras.ncamera import NCameraSystem
from ..device import resolve_device
from ..estimator.estimator import device_get
from ..imu.preintegration import propagate
from ..kinematics import np_se3
from ..utils import syncstats
from ..utils.ids import IdProvider
from ..utils.timing import Timing
from . import kernels
from .brisk import describe_keypoints, detect_and_describe_batch, gravity_extraction_angle
from .detection import detect_keypoints
from .frame import FrameData, MultiFrame
from .keyframe import need_new_keyframe

_log = logging.getLogger("okvis_tpu_torch")

N_HYP = 64  # RANSAC hypotheses per solve (per camera for the rig RANSAC)


@dataclasses.dataclass
class FrontendConfig:
    detection_threshold: float = 30.0
    detection_octaves: int = 0  # >0 enables scale-space detection
    max_keypoints: int = 400
    matching_threshold: int = 60  # BRISK Hamming
    gate_radius_px: float = 40.0  # image-space gate for 3D-2D candidates
    keyframe_overlap: float = 0.6
    keyframe_ratio: float = 0.2
    num_matching_keyframes: int = 3  # match against the last 3 keyframes
    ransac_threshold_px2: float = 9.0
    min_3d2d_matches: int = 5  # tracking-failure warning level
    detection_masks: tuple = None  # optional per-camera (H, W) bool masks
    # below this correspondence count the 2D-2D relative model also runs the
    # 5-point solver
    fivepoint_max_corr: int = 24
    # added in quadrature to every keypoint gate stddev (uncalibrated rig
    # during online extrinsics estimation); 0 when extrinsics are fixed
    gate_extra_px: float = 0.0


# (ca, cb, assign (K,), hp_W (K,4), valid (K,), parallel (K,), can_init (K,))
StereoResult = Tuple[int, int, np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray]


class Frontend:
    """Host-side frontend (the reference's VioFrontendInterface); device work
    runs on the rig's device."""

    def __init__(self, rig: NCameraSystem, cfg: FrontendConfig = None):
        self.rig = rig
        self.cfg = cfg or FrontendConfig()
        self.device = resolve_device(rig.device)
        self.is_initialized = False
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(7)
        self._host_rng = np.random.default_rng(7)
        self._pending_stereo = None  # fused stereo results awaiting resolution
        # frames where the absolute-pose RANSAC found <10 inliers despite
        # >=10 candidates, so outlier removal was skipped
        self.ransac_degenerate_frames = 0

    def _draw(self, shape, high: Optional[int] = None):
        """The next RANSAC draw: uniform [0, 1) of `shape` on the rig's
        device, in the rig's dtype, or, with `high`, one integer in
        [0, high) from the host generator. Every draw of the frontend goes
        through here, one call where the JAX package splits one key."""
        if high is not None:
            return int(self._host_rng.integers(0, high))
        return torch.rand(shape, generator=self._gen, dtype=self.rig.dtype, device=self.device)

    # ------------------------------------------------------------------
    def _check_detection_mode(self) -> None:
        if self.cfg.detection_octaves > 0 or self.cfg.detection_masks is not None:
            raise NotImplementedError(
                "okvis_tpu_torch: scale-space and masked detection are not ported yet")

    def detect_and_describe(self, cam_idx: int, image, T_WC: Optional[kin.SE3] = None) -> FrameData:
        """Detection + gravity-aligned description of one camera's image
        (Frontend.cpp:92-114)."""
        self._check_detection_mode()
        image = torch.as_tensor(image, dtype=torch.float32, device=self.device)
        kps = detect_keypoints(image, threshold=self.cfg.detection_threshold,
                               max_keypoints=self.cfg.max_keypoints)
        angle = None
        if T_WC is not None:
            down = T_WC.q.new_tensor([0.0, 0.0, -1.0])
            g_C = kin.quat_rotate(kin.quat_conjugate(T_WC.q), down)
            angle = gravity_extraction_angle(g_C).to(torch.float32)
        desc = describe_keypoints(image, kps, angle)
        return FrameData(keypoints=kps, descriptors=desc,
                         landmark_ids=np.zeros(self.cfg.max_keypoints, np.int64), image=image)

    def _extraction_angles(self, T_WS: Optional[kin.SE3], C: int) -> torch.Tensor:
        """Per-camera angle of gravity projected into the image (float32)."""
        if T_WS is None:
            return torch.zeros(C, dtype=torch.float32, device=self.device)
        T_WC = kin.compose(
            kin.SE3(r=T_WS.r[None], q=T_WS.q[None]),
            kin.SE3(r=self.rig.T_SC.r[:C], q=self.rig.T_SC.q[:C]),
        )
        down = T_WC.q.new_tensor([0.0, 0.0, -1.0])
        g_C = kin.quat_rotate(kin.quat_conjugate(T_WC.q), down)
        return gravity_extraction_angle(g_C).to(torch.float32)

    def detect_and_describe_multi(self, images, T_WS: Optional[kin.SE3] = None) -> List[FrameData]:
        """All cameras of a multiframe in one batched call, with gravity-aligned
        per-camera extraction angles. `images` are (H, W) arrays or tensors."""
        self._check_detection_mode()
        C = len(images)
        stack = torch.stack(
            [torch.as_tensor(im, dtype=torch.float32, device=self.device) for im in images])
        if T_WS is not None:  # the angles are computed in the rig's dtype
            T_WS = kin.SE3(r=T_WS.r.to(self.device, self.rig.dtype), q=T_WS.q.to(self.device, self.rig.dtype))
        kps_b, desc_b = detect_and_describe_batch(
            stack,
            self._extraction_angles(T_WS, C),
            threshold=self.cfg.detection_threshold,
            max_keypoints=self.cfg.max_keypoints,
        )
        # one joint host copy of every camera's uv/mask mirrors: the
        # association path reads them many times
        syncstats.bump("detect_fetch")
        uv_h = kps_b.uv.cpu().numpy()
        mask_h = kps_b.mask.cpu().numpy()
        out = []
        for c in range(C):
            fd = FrameData(
                keypoints=_camera_slice(kps_b, c),
                descriptors=desc_b[c],
                landmark_ids=np.zeros(self.cfg.max_keypoints, np.int64),
                image=stack[c],
            )
            fd.set_host_mirrors(uv_h[c], mask_h[c])
            out.append(fd)
        return out

    # ------------------------------------------------------------------
    def propagation(self, imu_params, T_WS, sb, ts, gyro, acc, t0, t1):
        """Real-time state prediction (ref Frontend::propagation), on the
        device and dtype of `sb`."""
        like = torch.as_tensor(sb)
        t = lambda x: torch.as_tensor(x, dtype=like.dtype, device=like.device)  # noqa: E731
        return propagate(imu_params, T_WS, like, t(ts), t(gyro), t(acc), t(t0), t(t1))

    # ------------------------------------------------------------------
    def data_association_and_initialization(
        self,
        estimator,
        T_WS_prop: kin.SE3,
        multiframe: MultiFrame,
        sb_prop=None,
    ) -> bool:
        """Match the current multiframe against keyframes / the last frame /
        stereo and feed the estimator. Returns the as_keyframe decision."""
        cfg = self.cfg
        kf_ids = [
            s.id for s in estimator._states_by_time() if s.is_keyframe and s.id != multiframe.id
        ][-cfg.num_matching_keyframes:]
        # keyframe sources, newest first, matched in one batched round; the
        # last frame is matched after the keyframe decision, and only
        # keyframe matches feed num3dMatches (Frontend.cpp:153-233)
        sources: List[MultiFrame] = []
        for kf_id in reversed(kf_ids):
            kf_mf = estimator.multiframes.get(kf_id)
            if kf_mf is not None:
                sources.append(kf_mf)
        n_primary = len(sources)

        # once tracking is initialized the last frame rides the same round
        # as the lowest-priority source; the host resolves the keyframe
        # sources, takes the decision, then resolves the last frame, which
        # keeps the reference's ordering with one device round trip
        by_time = estimator._states_by_time()
        last_mf = None
        if len(by_time) >= 2 and by_time[-2].id not in kf_ids:
            last_mf = estimator.multiframes.get(by_time[-2].id)
        fold_last = self.is_initialized and last_mf is not None
        if fold_last:
            sources.append(last_mf)

        # one-model rigs carry the intra-frame stereo matching inside the
        # association round; its results are resolved after the last-frame
        # phase via _pending_stereo
        self._pending_stereo = None

        def keyframe_decision():
            # keyframe decision (Frontend.cpp:196), after the keyframe sources
            # resolved and before the last-frame phase
            kps, matched = [], []
            for f in multiframe.frames:
                m = f.mask_np
                kps.append(f.uv_np[m])
                matched.append(f.landmark_ids[: len(m)][m] != 0)
            return need_new_keyframe(
                kps, matched,
                overlap_threshold=cfg.keyframe_overlap,
                ratio_threshold=cfg.keyframe_ratio,
                num_frames=estimator.num_frames(),
                is_initialized=self.is_initialized,
            )

        # RANSAC outlier removal is gated on isInitialized_ for the keyframe
        # round (Frontend.cpp:434-436)
        as_keyframe = None
        if sources:
            num_3d2d, as_keyframe = self._associate_batched(
                estimator, sources, multiframe, T_WS_prop,
                apply_ransac=self.is_initialized,
                stereo=True,
                n_primary=n_primary,
                phase_callback=keyframe_decision if fold_last else None,
                sb_b=sb_prop,
            )
        else:
            num_3d2d = 0
            estimator.resolve_pending_prop()
        if n_primary and self.is_initialized and num_3d2d <= cfg.min_3d2d_matches:
            _log.warning("Tracking failure. Number of 3d2d-matches: %d", num_3d2d)

        # initialization: the 2D-2D RANSAC decides rotation-only against
        # translation (runRansac2d2d, Frontend.cpp:645-810; :184-189)
        if not self.is_initialized and kf_ids:
            kf_mf = estimator.multiframes.get(kf_ids[-1])
            if kf_mf is not None:
                rotation_only = self._ransac_2d2d(
                    estimator, kf_mf, multiframe, initialize_pose=True, remove_outliers=False)
                if not rotation_only:
                    self.is_initialized = True
        if not self.is_initialized and num_3d2d > 0:
            # stereo shortcut: metric landmarks already exist
            self.is_initialized = True

        if as_keyframe is None:
            as_keyframe = keyframe_decision()

        # bootstrap: the last frame in its own round after the decision
        if not fold_last and last_mf is not None:
            self._associate_batched(estimator, [last_mf], multiframe, T_WS_prop, apply_ransac=True)
            # the reference also runs the 2D-2D RANSAC against the last frame
            # while uninitialized (Frontend.cpp:513-516); a decisive
            # translational model flips tracking to initialized, the pose
            # stays IMU-predicted
            if not self.is_initialized:
                rotation_only = self._ransac_2d2d(
                    estimator, last_mf, multiframe, initialize_pose=False, remove_outliers=False)
                if not rotation_only:
                    self.is_initialized = True

        # stereo matching within the multiframe (Frontend.cpp:238-268): from
        # the fused round's results when present, otherwise its own launch
        # (first frame, mixed-model rigs)
        if self._pending_stereo is not None and self._pending_stereo[0] == multiframe.id:
            (_fid, prs, (s_assign, s_hp, s_valid, s_par, s_ci)) = self._pending_stereo
            self._pending_stereo = None
            for i, (ca, cb) in enumerate(prs):
                self._resolve_stereo_pair(
                    estimator, multiframe, ca, cb, s_assign[i], s_hp[i], s_valid[i], s_par[i], s_ci[i])
        else:
            self._match_stereo(estimator, multiframe, T_WS_prop)
        return as_keyframe

    # ------------------------------------------------------------------
    def _associate_batched(
        self,
        estimator,
        sources: List[MultiFrame],
        frame_b: MultiFrame,
        T_WS_b: kin.SE3,
        apply_ransac: bool = False,
        stereo: bool = False,
        n_primary: Optional[int] = None,
        phase_callback=None,
        sb_b=None,
    ):
        """3D-2D + 2D-2D association of all source frames against the current
        frame in one association call for the whole rig
        (kernels.associate_multicam), fetched with one blocking copy; a
        mixed-model rig runs one call per camera.

        Sources [0, n_primary) are the keyframe round; the rest form the
        folded last-frame round, resolved after `phase_callback` (the
        keyframe decision). Returns (num 3D-2D keyframe matches,
        phase_callback result or None).

        Conflicts (two sources matching one current keypoint) are resolved
        on the host in source order, newest keyframe first; losers re-match
        against the remaining free keypoints in a rare second round."""
        t_host0 = time.perf_counter()
        t_host0_cpu = time.thread_time()
        cfg = self.cfg
        K = cfg.max_keypoints
        P = len(sources)
        C = frame_b.num_cameras
        dev = self.device
        dtype = estimator.intrinsics[0].dtype

        # ---------- (P, C, ...) inputs of the round ----------
        mask_b_np = [frame_b.frames[c].mask_np for c in range(C)]
        uv_b_all = [frame_b.frames[c].uv_np for c in range(C)]
        free_b_np = [mask_b_np[c] & (frame_b.frames[c].landmark_ids == 0) for c in range(C)]
        # 3D-2D uses only initialized landmarks with >= 2 observations;
        # carried uninitialized ones go through the 2D-2D pool (ref doSetup
        # skip lists). Sorted landmark tables make every lookup below a
        # vectorized searchsorted.
        obs_count = estimator.obs_count
        n_lm = len(estimator.landmarks)
        tbl_ids = np.fromiter(estimator.landmarks.keys(), np.int64, n_lm)
        _order = np.argsort(tbl_ids)
        tbl_ids = tbl_ids[_order]
        _recs = list(estimator.landmarks.values())
        tbl_slot = np.fromiter((r.slot for r in _recs), np.int64, n_lm)[_order]
        tbl_init = np.fromiter((r.initialized for r in _recs), bool, n_lm)[_order]
        tbl_obs2 = np.fromiter((obs_count.get(int(i), 0) >= 2 for i in tbl_ids), bool, n_lm)

        def _lm_lookup(lids):
            """(row, found) in the tables per id; id 0 is never found."""
            if n_lm == 0:
                return np.zeros(lids.shape, np.int64), np.zeros(lids.shape, bool)
            idx = np.clip(np.searchsorted(tbl_ids, lids), 0, n_lm - 1)
            return idx, (lids != 0) & (tbl_ids[idx] == lids)

        sel_a = np.zeros((P, C, K), bool)
        hp_rows = np.tile(np.asarray([0.0, 0, 0, 1.0]), (P, C, K, 1))
        free2_a = np.zeros((P, C, K), bool)
        # the landmark id each 3D-2D source row carries at launch time: the
        # folded RANSAC's verdicts apply only to the landmark it scored
        lm_a_ids = np.zeros((P, C, K), np.int64)
        for p, src in enumerate(sources):
            for c in range(C):
                fa = src.frames[c]
                m_a = fa.mask_np
                lids = fa.landmark_ids
                idx, found = _lm_lookup(lids)
                stale = (lids != 0) & ~found
                if stale.any():
                    fa.landmark_ids[stale] = 0
                carried = found & m_a
                init = carried & tbl_init[idx] if n_lm else carried
                # single-observation initialized landmarks: depth not
                # observable, demote (ref doSetup :195-199)
                demote = init & ~tbl_obs2[idx] if n_lm else init
                if demote.any():
                    for lm_id in np.unique(lids[demote]):
                        estimator.landmarks[int(lm_id)].initialized = False
                    tbl_init[idx[demote]] = False
                    init &= ~demote
                sel_a[p, c] = init
                if init.any():
                    hp_rows[p, c][init] = estimator.hp_W[tbl_slot[idx[init]]]
                    lm_a_ids[p, c][init] = lids[init]
                free2_a[p, c] = (carried & ~init) | (m_a & (fa.landmark_ids == 0))
        Timing.add("host: assoc tables (np)", time.thread_time() - t_host0_cpu)

        desc_a_t = torch.stack([torch.stack([src.frames[c].descriptors for c in range(C)]) for src in sources])
        uv_a_t = torch.stack(
            [torch.stack([src.frames[c].keypoints.uv for c in range(C)]) for src in sources]).to(dtype)
        desc_b_t = torch.stack([frame_b.frames[c].descriptors for c in range(C)])
        uv_b_t = torch.stack([frame_b.frames[c].keypoints.uv for c in range(C)]).to(dtype)
        # keypoint stddevs (0.8·size/12, ref doSetup :211-214)
        std_b = np.stack([self._kp_std(frame_b.frames[c]) for c in range(C)])
        std_a = np.stack([np.stack([self._kp_std(src.frames[c]) for c in range(C)]) for src in sources])
        # keypoints that already carry landmarks with >= 2 observations are
        # RANSAC candidates too (FrameNoncentralAbsoluteAdapter.cpp:83-84)
        lids0 = np.stack([frame_b.frames[c].landmark_ids.copy() for c in range(C)])
        idx0, found0 = _lm_lookup(lids0)
        if n_lm:
            sel_prev = found0 & tbl_obs2[idx0]
            hp0 = estimator.hp_W[tbl_slot[idx0]]
            sel_prev &= np.abs(hp0[..., 3]) >= 1e-8  # points at infinity carry no position
            w0 = np.where(sel_prev, hp0[..., 3], 1.0)[..., None]
            pts_prev = np.where(sel_prev[..., None], hp0[..., :3] / w0, 0.0)
        else:
            sel_prev = found0
            pts_prev = np.zeros((C, K, 3))
        # source camera poses from the host tables; the current frame's
        # camera poses and gate variance are composed on the device from
        # (T_WS_b, sb_b), so a deferred propagation is never fetched alone
        src_slots = [estimator.states[src.id].slot for src in sources]
        T_WC_a_list = [
            [np_se3.compose(estimator.r_WS[s], estimator.q_WS[s], estimator.r_SC[c], estimator.q_SC[c])
             for c in range(C)]
            for s in src_slots
        ]

        def t(x, dt=dtype):
            return torch.as_tensor(np.asarray(x), device=dev).to(dt)

        T_WC_a_stk = kin.SE3(r=t([[tc[0] for tc in row] for row in T_WC_a_list]),
                             q=t([[tc[1] for tc in row] for row in T_WC_a_list]))
        T_SC_stk = kin.SE3(r=t(estimator.r_SC[:C]), q=t(estimator.q_SC[:C]))
        T_WS_b_t = kin.SE3(r=torch.as_tensor(T_WS_b.r).to(dev, dtype), q=torch.as_tensor(T_WS_b.q).to(dev, dtype))
        if sb_b is None:
            try:
                sb_b = estimator.get_speed_and_bias(frame_b.id)
            except KeyError:
                sb_b = np.zeros(9)
        sb_b_t = torch.as_tensor(sb_b).to(dev, dtype)
        uniform = len(set(self.rig.specs[:C])) == 1
        # intra-frame stereo rides the round only on one-model rigs
        stereo_pairs = self._stereo_pairs(C) if (stereo and uniform) else ()
        b = lambda x: t(x, torch.bool)  # noqa: E731
        if uniform:
            out = kernels.associate_multicam(
                self.rig.specs[0],
                self._draw((C, N_HYP, 3)),
                torch.stack(estimator.intrinsics[:C]),
                desc_a_t, b(sel_a), t(hp_rows), b(free2_a), uv_a_t, t(std_a),
                T_WS_b_t, sb_b_t, T_WC_a_stk,
                desc_b_t, b(np.stack(free_b_np)), uv_b_t, t(std_b), b(sel_prev), t(pts_prev),
                T_SC_stk, float(cfg.gate_radius_px), float(cfg.ransac_threshold_px2),
                threshold=cfg.matching_threshold, stereo_pairs=stereo_pairs,
            )
            # one blocking fetch: the round's results, the propagated body
            # state (host copy for the recovery round), and any deferred
            # add_states propagation
            Timing.add("host: assoc build", time.perf_counter() - t_host0)
            out_f, T_b_f, sb_f = estimator.fetch_with_pending((out, (T_WS_b_t.r, T_WS_b_t.q), sb_b_t))
            (assign3_all, assign2_all, hp_all, val_all, par_all, ci_all,
             rs_inliers, rs_num, _rs_success, stereo_out) = out_f
            rs_num = np.full(C, int(rs_num))  # rig-pooled count
            if stereo_pairs:
                self._pending_stereo = (frame_b.id, stereo_pairs, stereo_out)
        else:
            # mixed camera models: one round per camera (the folded RANSAC
            # then pools per camera)
            parts = []
            for c in range(C):
                parts.append(kernels.associate_onecam(
                    self.rig.specs[c], self._draw((1, N_HYP, 3)), estimator.intrinsics[c],
                    desc_a_t[:, c], b(sel_a[:, c]), t(hp_rows[:, c]), b(free2_a[:, c]),
                    uv_a_t[:, c], t(std_a[:, c]), T_WS_b_t, sb_b_t,
                    kin.SE3(r=T_WC_a_stk.r[:, c], q=T_WC_a_stk.q[:, c]),
                    desc_b_t[c], b(free_b_np[c]), uv_b_t[c], t(std_b[c]), b(sel_prev[c]),
                    t(pts_prev[c]), kin.SE3(r=T_SC_stk.r[c], q=T_SC_stk.q[c]),
                    float(cfg.gate_radius_px), float(cfg.ransac_threshold_px2),
                    threshold=cfg.matching_threshold,
                ))
            Timing.add("host: assoc build", time.perf_counter() - t_host0)
            fetched, T_b_f, sb_f = estimator.fetch_with_pending((parts, (T_WS_b_t.r, T_WS_b_t.q), sb_b_t))
            assign3_all, assign2_all, hp_all, val_all, par_all, ci_all = (
                np.stack([f[i] for f in fetched], axis=1) for i in range(6))
            rs_inliers = np.stack([f[6] for f in fetched])
            rs_num = np.asarray([int(f[7]) for f in fetched])  # per-camera pools

        # ---------- RANSAC degeneracy counter ----------
        if apply_ransac:
            n_cand = int(np.count_nonzero(sel_prev))
            claimed_dev = np.zeros((C, K), bool)
            for p in range(P):
                for c in range(C):
                    hit = assign3_all[p, c] >= 0
                    claimed_dev[c, assign3_all[p, c][hit]] = True
            n_cand += int(np.count_nonzero(claimed_dev & ~sel_prev))
            if n_cand >= 10 and int(np.max(rs_num)) < 10:
                self.ransac_degenerate_frames += 1
                _log.warning(
                    "absolute-pose RANSAC found <10 inliers from %d candidates on frame %d; "
                    "outlier removal skipped (%d such frames so far)",
                    n_cand, frame_b.id, self.ransac_degenerate_frames)

        # ---------- the landmark the device scored per target keypoint:
        # its pre-existing landmark, or the newest source's candidate ----------
        dev_lm = np.zeros((C, K), np.int64)
        for p in range(P - 1, -1, -1):  # oldest first; newest overwrites
            for c in range(C):
                hit = assign3_all[p, c] >= 0
                dev_lm[c, assign3_all[p, c][hit]] = lm_a_ids[p, c][hit]
        dev_lm = np.where(sel_prev, lids0, dev_lm)

        # host copies of the propagated state (fetched with the main sync)
        # feed the rare recovery round without another wait
        r_b_np = np.asarray(T_b_f[0], np.float64)
        q_b_np = np.asarray(T_b_f[1], np.float64)
        scale = max(1.0, float(np.linalg.norm(np.asarray(sb_f, np.float64)[:3])))
        sigma_pos2 = scale * scale * 1e-2
        T_CW_host = [
            np_se3.inverse(*np_se3.compose(r_b_np, q_b_np, estimator.r_SC[c], estimator.q_SC[c]))
            for c in range(C)
        ]
        # current-frame camera centers (world): the 2D-2D creation branch
        # compares triangulated depth against the pair baseline
        cam_centers_b = [
            np_se3.compose(r_b_np, q_b_np, estimator.r_SC[c], estimator.q_SC[c])[0] for c in range(C)
        ]

        # ---------- host resolution, in phases: primary (keyframe) sources,
        # the keyframe decision, then the folded last-frame source ----------
        n_primary = P if n_primary is None else n_primary
        # a landmark claims at most one keypoint per camera and frame
        claimed_by_cam = [{int(lm) for lm in frame_b.frames[c].landmark_ids if lm != 0} for c in range(C)]
        n3d_primary = 0
        nonlocal_t = {"recovery": 0.0, "recovery_cpu": 0.0}

        def resolve_phase(p_lo, p_hi, apply_rs):
            nonlocal n3d_primary
            for cam in range(C):
                fb = frame_b.frames[cam]
                uv_b_np = uv_b_all[cam]
                free_b = free_b_np[cam]
                claimed = claimed_by_cam[cam]

                def resolve_3d2d(assign_np, collect_losers):
                    nonlocal n3d_primary
                    losers = np.zeros((P, K), bool)
                    for p in range(p_lo, p_hi):
                        fa = sources[p].frames[cam]
                        for ia in np.nonzero(assign_np[p] >= 0)[0]:
                            lm_id = int(fa.landmark_ids[ia])
                            if lm_id == 0 or not estimator.is_landmark_added(lm_id):
                                continue
                            if lm_id in claimed:
                                continue  # already observed in this frame/camera
                            ib = int(assign_np[p, ia])
                            if not free_b[ib]:
                                # keypoint taken by an earlier (newer) source
                                if collect_losers:
                                    losers[p, ia] = True
                                continue
                            if not estimator.add_observation(
                                lm_id, frame_b.id, cam, uv_b_np[ib], keypoint_idx=ib, size=fb.keypoint_size(ib),
                            ):
                                continue  # observation table full
                            frame_b.set_landmark_id(cam, ib, lm_id)
                            claimed.add(lm_id)
                            free_b[ib] = False
                            if p < n_primary:
                                n3d_primary += 1  # only keyframe matches count
                    return losers

                losers = resolve_3d2d(assign3_all[:, cam], collect_losers=True)
                # second round: conflict losers re-match against the
                # remaining free keypoints (one extra batched call, only on
                # frames that had conflicts)
                if losers.any() and free_b.any():
                    t_rec0 = time.perf_counter()
                    t_rec0_cpu = time.thread_time()
                    T_CW_b = kin.SE3(r=t(np.tile(T_CW_host[cam][0], (P, 1))),
                                     q=t(np.tile(T_CW_host[cam][1], (P, 1))))
                    assign_r, _ = kernels.gated_match_pairs(
                        self.rig.specs[cam], estimator.intrinsics[cam], desc_a_t[:, cam], b(losers),
                        t(hp_rows[:, cam]), T_CW_b, fb.descriptors, b(free_b), uv_b_t[cam], t(std_b[cam]),
                        sigma_pos2, float(cfg.gate_radius_px), threshold=cfg.matching_threshold)
                    syncstats.bump("assoc_recovery")
                    assign_r = assign_r.cpu().numpy()
                    nonlocal_t["recovery"] += time.perf_counter() - t_rec0
                    nonlocal_t["recovery_cpu"] += time.thread_time() - t_rec0_cpu
                    resolve_3d2d(assign_r, collect_losers=False)

                # 2D-2D: resolve conflicts, create landmarks, and upgrade
                # carried uninitialized landmarks (ref setBestMatch 2D-2D
                # path, VioKeyframeWindowMatchingAlgorithm.cpp:398-441)
                assign2 = assign2_all[:, cam]
                taken_b = ~free_b | (fb.landmark_ids[:K] != 0)
                for p in range(p_lo, p_hi):
                    src = sources[p]
                    fa = src.frames[cam]
                    uva = fa.uv_np
                    for ia in np.nonzero(assign2[p] >= 0)[0]:
                        ib = int(assign2[p, ia])
                        if taken_b[ib]:
                            continue
                        taken_b[ib] = True  # one landmark per current keypoint
                        if not val_all[p, cam, ia]:
                            continue
                        if fb.landmark_ids[ib] != 0:
                            continue
                        hp = hp_all[p, cam, ia]
                        w = hp[3]
                        lm_a = int(fa.landmark_ids[ia])
                        if lm_a != 0:
                            # the source row carries an uninitialized
                            # landmark: reuse it, update its estimate if the
                            # match triangulates with parallax, add the
                            # current-frame observation (ref :436-441)
                            if not estimator.is_landmark_added(lm_a):
                                fa.landmark_ids[ia] = 0
                            elif lm_a not in claimed:
                                can_init = bool(ci_all[p, cam, ia]) and abs(w) >= 1e-6
                                if can_init:
                                    estimator.set_landmark(lm_a, hp[:3] / w)
                                    estimator.landmarks[lm_a].initialized = True
                                if estimator.add_observation(
                                    lm_a, frame_b.id, cam, uv_b_np[ib], keypoint_idx=ib, size=fb.keypoint_size(ib),
                                ):
                                    frame_b.set_landmark_id(cam, ib, lm_a)
                                    claimed.add(lm_a)
                            continue
                        lm_id = IdProvider.new_id()
                        par_flag = bool(par_all[p, cam, ia]) or abs(w) < 1e-6
                        ci = bool(ci_all[p, cam, ia])
                        try:
                            if par_flag:
                                estimator.add_landmark(lm_id, hp, initialized=False)
                            elif not ci:
                                # depth-unobservable finite triangulation:
                                # parallax below the noise floor (depth >
                                # 500 baselines, or a baseline < 3 cm) keeps
                                # only the bearing (a point at infinity along
                                # the ray); measurable but sub-threshold
                                # parallax keeps the midpoint
                                c_a = T_WC_a_list[p][cam][0]
                                pt = hp[:3] / w
                                depth = float(np.linalg.norm(pt - c_a))
                                bl = float(np.linalg.norm(cam_centers_b[cam] - c_a))
                                if depth > 500.0 * max(bl, 1e-9) or bl < 0.03:
                                    d = pt - c_a
                                    nd = float(np.linalg.norm(d))
                                    if nd < 1e-9:
                                        continue
                                    hp_inf = np.concatenate([d / nd, [1e-3]])
                                    estimator.add_landmark(lm_id, hp_inf / np.linalg.norm(hp_inf),
                                                           initialized=False)
                                else:
                                    estimator.add_landmark(lm_id, pt, initialized=False)
                            else:
                                estimator.add_landmark(lm_id, hp[:3] / w, initialized=True)
                        except RuntimeError:
                            break  # landmark table full
                        ok1 = estimator.add_observation(
                            lm_id, src.id, cam, uva[ia], keypoint_idx=int(ia), size=fa.keypoint_size(int(ia)))
                        ok2 = ok1 and estimator.add_observation(
                            lm_id, frame_b.id, cam, uv_b_np[ib], keypoint_idx=ib, size=fb.keypoint_size(ib))
                        if not ok2:
                            # observation table full: roll back the half-added
                            # landmark so bookkeeping matches the factor graph
                            estimator._remove_landmark(lm_id)
                            break
                        fa.landmark_ids[ia] = lm_id
                        frame_b.set_landmark_id(cam, ib, lm_id)

                # the folded 3D-2D RANSAC's outlier removals over this
                # round's candidates and pre-existing associations, gated on
                # >= 10 rig inliers (Frontend.cpp:613-640); idempotent
                if apply_rs and int(rs_num[cam]) >= 10:
                    cand = assign3_all[:, cam]
                    targets = set(np.unique(cand[cand >= 0]).tolist())
                    targets.update(np.nonzero(sel_prev[cam])[0].tolist())
                    outl = ~rs_inliers[cam]
                    for ib in sorted(targets):
                        ib = int(ib)
                        if not outl[ib]:
                            continue
                        lm_id = int(fb.landmark_ids[ib])
                        if lm_id == 0:
                            continue  # host never resolved this candidate
                        if lm_id != int(dev_lm[cam, ib]):
                            # the host bound another landmark than the one the
                            # device scored: the verdict does not apply
                            continue
                        if estimator.is_landmark_added(lm_id):
                            estimator.remove_observation(lm_id, frame_b.id, cam, ib)
                        frame_b.set_landmark_id(cam, ib, 0)

        t_res0 = time.perf_counter()
        t_res0_cpu = time.thread_time()
        resolve_phase(0, n_primary, apply_ransac)
        decision = None
        t_cb = t_cb_cpu = 0.0
        if phase_callback is not None:
            t_cb0 = time.perf_counter()
            t_cb0_cpu = time.thread_time()
            decision = phase_callback()
            t_cb = time.perf_counter() - t_cb0
            t_cb_cpu = time.thread_time() - t_cb0_cpu
        if n_primary < P:
            resolve_phase(n_primary, P, apply_ransac)
        Timing.add("host: assoc resolve", time.perf_counter() - t_res0 - nonlocal_t["recovery"] - t_cb)
        Timing.add("host: assoc resolve (cpu)",
                   time.thread_time() - t_res0_cpu - nonlocal_t["recovery_cpu"] - t_cb_cpu)
        if nonlocal_t["recovery"]:
            Timing.add("assoc recovery launch", nonlocal_t["recovery"])
        return n3d_primary, decision

    # ------------------------------------------------------------------
    def _frame_T_WC(self, estimator, state_or_T, cam: int) -> kin.SE3:
        T_SC = estimator.get_extrinsics(cam)
        if isinstance(state_or_T, kin.SE3):
            return kin.compose(state_or_T, T_SC)
        return kin.compose(estimator.get_T_WS(state_or_T), T_SC)

    def _stereo_pairs(self, C: int):
        return tuple(
            (ca, cb)
            for ca in range(C)
            for cb in range(ca + 1, C)
            if self.rig.overlaps is None or self.rig.has_overlap(ca, cb)
        )

    def _kp_std(self, f: FrameData) -> np.ndarray:
        """Keypoint stddev [px]: 0.8/12 · size, with the optional gate inflation."""
        K = self.cfg.max_keypoints
        s = 0.8 / 12.0 * (np.asarray(f.sizes)[:K] if f.sizes is not None else np.full(K, 8.0))
        if self.cfg.gate_extra_px > 0.0:
            s = np.sqrt(s**2 + self.cfg.gate_extra_px**2)
        return s

    def match_stereo(self, multiframe: MultiFrame, T_WS: kin.SE3, estimator=None) -> List[StereoResult]:
        """Stereo matching + triangulation of every overlapping camera pair of
        a multiframe at body pose T_WS: the launch half of _match_stereo.
        Extrinsics and intrinsics come from `estimator` when given, else from
        the rig; geometry runs in their dtype. Keypoints already carrying a
        landmark id are not matched. Returns one host result per pair."""
        dtype = (estimator.intrinsics[0] if estimator is not None else self.rig.intrinsics[0]).dtype
        results = []
        for ca, cb in self._stereo_pairs(multiframe.num_cameras):
            fa, fb = multiframe.frames[ca], multiframe.frames[cb]
            free_a = fa.mask_np & (fa.landmark_ids == 0)
            free_b = fb.mask_np & (fb.landmark_ids == 0)
            if not free_a.any() or not free_b.any():
                continue
            if estimator is not None:
                T_SC_a, T_SC_b = estimator.get_extrinsics(ca), estimator.get_extrinsics(cb)
                intr_a, intr_b = estimator.intrinsics[ca], estimator.intrinsics[cb]
            else:
                T_SC_a, T_SC_b = self.rig.camera_T_SC(ca), self.rig.camera_T_SC(cb)
                intr_a, intr_b = self.rig.intrinsics[ca], self.rig.intrinsics[cb]

            def dev(x, dt=dtype):
                return torch.as_tensor(x).to(self.device, dt)

            def pose(T):
                return kin.SE3(r=dev(T.r), q=dev(T.q))

            T_WS_d = pose(T_WS)
            out = kernels.stereo_match_triangulate(
                self.rig.specs[ca], self.rig.specs[cb], intr_a, intr_b,
                fa.descriptors, fb.descriptors,
                dev(free_a, torch.bool), dev(free_b, torch.bool),
                fa.keypoints.uv.to(dtype), fb.keypoints.uv.to(dtype),
                kin.compose(T_WS_d, pose(T_SC_a)), kin.compose(T_WS_d, pose(T_SC_b)),
                dev(self._kp_std(fa)), dev(self._kp_std(fb)),
                threshold=self.cfg.matching_threshold,
            )
            results.append((ca, cb, *(x.cpu().numpy() for x in out)))
        return results

    def _match_stereo(self, estimator, multiframe: MultiFrame, T_WS: kin.SE3) -> None:
        """Intra-multiframe matching across overlapping camera pairs
        (Frontend.cpp:521-572): match_stereo's launches, then the host
        creates the landmarks. Used when no association round carried the
        stereo phase (first frame, mixed-model rigs)."""
        for ca, cb, assign, hp, valid, par, can_init in self.match_stereo(multiframe, T_WS, estimator):
            syncstats.bump("stereo_standalone")
            self._resolve_stereo_pair(estimator, multiframe, ca, cb, assign, hp, valid, par, can_init)

    def _resolve_stereo_pair(self, estimator, multiframe, ca, cb, assign, hp_arr, valid, par, can_init):
        """Create landmarks from a stereo match + triangulation result,
        dropping pairs whose keypoints were claimed since (ref setBestMatch
        2D-2D path)."""
        fa, fb = multiframe.frames[ca], multiframe.frames[cb]
        uva_np = fa.uv_np
        uvb_np = fb.uv_np
        for ia in np.nonzero((assign >= 0) & valid)[0]:
            ib = int(assign[ia])
            ia = int(ia)
            if fa.landmark_ids[ia] != 0 or fb.landmark_ids[ib] != 0:
                continue
            w = hp_arr[ia, 3]
            lm_id = IdProvider.new_id()
            try:
                if par[ia] or abs(w) < 1e-6:
                    # parallel rays: point at infinity (w ≈ 1e-3), kept as an
                    # uninitialized landmark constraining rotation only
                    estimator.add_landmark(lm_id, hp_arr[ia], initialized=False)
                else:
                    estimator.add_landmark(lm_id, hp_arr[ia, :3] / w, initialized=bool(can_init[ia]))
            except RuntimeError:
                break  # landmark table full
            ok1 = estimator.add_observation(
                lm_id, multiframe.id, ca, uva_np[ia], keypoint_idx=ia, size=fa.keypoint_size(ia))
            ok2 = ok1 and estimator.add_observation(
                lm_id, multiframe.id, cb, uvb_np[ib], keypoint_idx=ib, size=fb.keypoint_size(ib))
            if not ok2:
                estimator._remove_landmark(lm_id)
                break
            multiframe.set_landmark_id(ca, ia, lm_id)
            multiframe.set_landmark_id(cb, ib, lm_id)

    # ------------------------------------------------------------------
    def _ransac_2d2d(self, estimator, frame_a: MultiFrame, frame_b: MultiFrame, initialize_pose: bool,
                     remove_outliers: bool) -> bool:
        """Rotation-only against relative-pose RANSAC over shared-landmark
        correspondences between an older frame A and the current frame B
        (ref runRansac2d2d, Frontend.cpp:645-810). Returns rotationOnly.
        Syncs: the RANSAC's SVD/eigh, then one fetch of its results."""
        from .fivepoint import ransac_relative_pose_5pt
        from .ransac import decompose_essential

        rotation_only_out = True
        for cam in range(frame_b.num_cameras):
            fa, fb = frame_a.frames[cam], frame_b.frames[cam]
            # correspondences: keypoints sharing a landmark id
            lm_to_a = {int(lm): i for i, lm in enumerate(fa.landmark_ids) if lm != 0}
            pairs = [(lm_to_a[int(lm)], i) for i, lm in enumerate(fb.landmark_ids)
                     if lm != 0 and int(lm) in lm_to_a]
            if len(pairs) < 10:
                continue
            K = self.cfg.max_keypoints
            uv_a = np.zeros((K, 2))
            uv_b = np.zeros((K, 2))
            mask = np.zeros(K, bool)
            for j, (ia, ib) in enumerate(pairs[:K]):
                uv_a[j] = fa.uv_np[ia]
                uv_b[j] = fb.uv_np[ib]
                mask[j] = True
            spec = self.rig.specs[cam]
            intr = estimator.intrinsics[cam]
            dtype = intr.dtype
            focal = float(intr[0])
            n_corr = len(pairs[:K])

            syncstats.bump("ransac2d2d")
            t = lambda x: torch.as_tensor(x).to(self.device, dtype)  # noqa: E731
            rot, rel, bear_a, bear_b = kernels.ransac_2d2d_px(
                self._draw((N_HYP, 2)), self._draw((N_HYP, 8)), spec, intr,
                t(uv_a), t(uv_b), torch.as_tensor(mask).to(self.device), focal, self.cfg.ransac_threshold_px2,
            )
            rot_n, rot_inl, rel_n, rel_inl, rel_model, bear_a_np, bear_b_np = device_get(
                (rot.num_inliers, rot.inliers, rel.num_inliers, rel.inliers, rel.model, bear_a, bear_b))
            rot_n, rel_n = int(rot_n), int(rel_n)
            if n_corr <= self.cfg.fivepoint_max_corr:
                # low overlap: the Stewenius 5-point minimal solver (host,
                # init-time cold path) competes with the batched 8-point
                # model; more inliers wins
                inl5, n5, E5, _ok5 = ransac_relative_pose_5pt(
                    bear_a_np, bear_b_np, mask, focal=focal,
                    threshold_px2=self.cfg.ransac_threshold_px2, n_iters=50,
                    seed=self._draw((), high=2**31 - 1),
                )
                if n5 > rel_n:
                    rel_n, rel_inl, rel_model = int(n5), np.asarray(inl5), np.asarray(E5.ravel())

            rot_ratio = rot_n / n_corr
            rel_ratio = rel_n / n_corr
            # decision (Frontend.cpp:712-731)
            if rot_ratio > rel_ratio or rot_ratio > 0.8:
                rotation_only_cam = True
                inliers = rot_inl
                success = rot_n > 10
            else:
                rotation_only_cam = False
                inliers = rel_inl
                success = rel_n > 10
            if not success:
                continue
            rotation_only_out = rotation_only_out and rotation_only_cam

            if remove_outliers:
                for j, (ia, ib) in enumerate(pairs[:K]):
                    if not inliers[j]:
                        lm_id = int(fb.landmark_ids[ib])
                        frame_b.set_landmark_id(cam, ib, 0)
                        if lm_id and estimator.is_landmark_added(lm_id):
                            estimator.remove_observation(lm_id, frame_b.id, cam, ib)

            # pose initialization from the relative model (Frontend.cpp:756-807)
            if initialize_pose and not self.is_initialized and not rotation_only_cam:
                h = lambda x: torch.as_tensor(np.asarray(x, np.float64))  # noqa: E731
                R_ab, t_ab = decompose_essential(
                    h(rel_model).reshape(3, 3), h(bear_a_np), h(bear_b_np), torch.as_tensor(rel_inl))
                T_SC = estimator.get_extrinsics(cam)
                T_WS_a = estimator.get_T_WS(frame_a.id)
                T_WS_b = estimator.get_T_WS(frame_b.id)
                # scale the unit translation by projecting the IMU-predicted
                # relative translation onto it (Frontend.cpp:783-797)
                T_CaCb_pred = kin.compose(
                    kin.inverse(kin.compose(T_WS_a, T_SC)), kin.compose(T_WS_b, T_SC))
                scale = max(0.0, float(torch.dot(t_ab, T_CaCb_pred.r)))
                T_CaCb = kin.SE3(r=t_ab * scale, q=kin.matrix_to_quat(R_ab))
                T_WS_new = kin.compose(
                    kin.compose(kin.compose(T_WS_a, T_SC), T_CaCb), kin.inverse(T_SC))
                estimator.set_T_WS(frame_b.id, T_WS_new)
        return rotation_only_out


def _camera_slice(kps, c: int):
    """Camera c's slice of a batched Keypoints."""
    return type(kps)(*(t[c] for t in kps))
