"""Keyframe database and place recognition on the Hamming kernel (port of
okvis_tpu.posegraph.place_recognition).

A query scores its descriptors against every database keyframe at once:
one (Kq, M·K) Hamming distance matrix, which on the card is one launch of
csrc/hamming.cu (ops.hamming.masked_distance_matrix; the JAX package makes
it a ±1 bf16 matmul on the TPU's matrix unit), then a min over each
keyframe's K descriptors. Exact retrieval, no vocabulary to train.

Score: the fraction of valid query descriptors whose best match in a
database keyframe is below ``vote_threshold`` Hamming distance.

The database lives on the device as (M_cap, K_cap, 16) int32 words and an
(M_cap, K_cap) mask; an insert writes its slot only (the JAX package
uploads the whole database again after each insert; the contents are the
same). Descriptors enter as the JAX package's numpy forms, (K, 64) uint8 or
(K, 16) uint32 words, and reach the kernel as (K, 16) int32 views of the
same bytes: a Hamming distance does not depend on how its 512 bits are
grouped into words.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..ops.hamming import DESCRIPTOR_BITS, DESCRIPTOR_WORDS, masked_distance_matrix
from ..utils import syncstats


class QueryResult(NamedTuple):
    scores: torch.Tensor  # (M_cap,) per-database-frame score in [0, 1], -1 where not allowed
    best_index: torch.Tensor  # () int64 argmax slot
    best_score: torch.Tensor  # () float32


def as_words(desc: np.ndarray) -> np.ndarray:
    """(..., 16) int32 view of packed 512-bit descriptors given as (..., 64)
    uint8 or (..., 16) uint32 / int32."""
    words = np.ascontiguousarray(desc).view(np.int32)
    if words.shape[-1] != DESCRIPTOR_WORDS:
        raise ValueError(f"descriptors of shape {desc.shape} {desc.dtype} are not {DESCRIPTOR_BITS}-bit strings")
    return words


def score_against_database(
    desc_q: torch.Tensor,  # (Kq, 16) int32 query descriptors
    mask_q: torch.Tensor,  # (Kq,) bool
    db_desc: torch.Tensor,  # (M, K, 16) int32
    db_mask: torch.Tensor,  # (M, K) bool
    allowed: torch.Tensor,  # (M,) bool: candidate frames (occupied and not recent)
    vote_threshold: int = 60,
) -> QueryResult:
    """Per database frame, the share of valid query descriptors with a match
    below vote_threshold; the best allowed frame (first on ties). The JAX
    package sets masked database entries to 512 before the min over a
    frame's K; here the kernel gives them MAX_DIST and the min is clamped to
    512, which is the same number, since no distance exceeds 512."""
    M, K, W = db_desc.shape
    d = masked_distance_matrix(desc_q, db_desc.reshape(M * K, W), None, db_mask.reshape(M * K))  # (Kq, M·K)
    best = torch.clamp(d.reshape(-1, M, K).amin(dim=2), max=DESCRIPTOR_BITS)  # (Kq, M)
    votes = torch.sum((best < vote_threshold) & mask_q[:, None], dim=0)  # (M,)
    nq = torch.clamp(torch.sum(mask_q), min=1)
    scores = votes.to(torch.float32) / nq.to(torch.float32)
    scores = torch.where(allowed, scores, -1.0)
    best_idx = torch.argmax(scores)
    return QueryResult(scores=scores, best_index=best_idx, best_score=scores.index_select(0, best_idx.reshape(1))[0])


class KeyframeDatabase:
    """Fixed-capacity descriptor database on the device (the CUDA card
    unless the caller passes device="cpu").

    The host keeps the id<->slot maps, the descriptors as given and each
    keyframe's geometry (bearings, landmark positions) for geometric
    verification; the retrieval reads the device copy of the descriptors."""

    def __init__(self, frame_capacity: int = 256, kp_capacity: int = 512, desc_words: int = 64,
                 desc_dtype=np.uint8, device=None):
        self.frame_cap = frame_capacity
        self.kp_cap = kp_capacity
        self.device = resolve_device(device)
        self.desc = np.zeros((frame_capacity, kp_capacity, desc_words), desc_dtype)
        self.mask = np.zeros((frame_capacity, kp_capacity), bool)
        self.occupied = np.zeros(frame_capacity, bool)
        self.kf_ids: List[Optional[int]] = [None] * frame_capacity
        self.slot_of = {}
        # host-side geometry for verification
        self.bearings: List[Optional[np.ndarray]] = [None] * frame_capacity
        self.landmarks: List[Optional[np.ndarray]] = [None] * frame_capacity
        self.lm_valid: List[Optional[np.ndarray]] = [None] * frame_capacity
        self._order: List[int] = []  # insertion order of kf ids
        self.upload()

    def __len__(self) -> int:
        return int(self.occupied.sum())

    def upload(self) -> None:
        """Copy the whole host database to the device."""
        self.device_desc = torch.from_numpy(as_words(self.desc)).to(self.device)
        self.device_mask = torch.from_numpy(self.mask).to(self.device)

    def insert(self, kf_id: int, desc: np.ndarray, mask: np.ndarray, bearings: np.ndarray, landmarks: np.ndarray,
               lm_valid: np.ndarray) -> None:
        """Add a keyframe; evicts the oldest when full (ring replacement)."""
        if kf_id in self.slot_of:
            return
        free = np.nonzero(~self.occupied)[0]
        if len(free):
            slot = int(free[0])
        else:
            oldest = self._order.pop(0)
            slot = self.slot_of.pop(oldest)
        k = min(len(desc), self.kp_cap)
        self.desc[slot] = 0
        self.mask[slot] = False
        self.desc[slot, :k] = desc[:k]
        self.mask[slot, :k] = mask[:k]
        self.occupied[slot] = True
        self.kf_ids[slot] = kf_id
        self.slot_of[kf_id] = slot
        # geometry padded to kp_cap so verification has one shape
        brg = np.zeros((self.kp_cap, 3))
        lms = np.zeros((self.kp_cap, 3))
        val = np.zeros(self.kp_cap, bool)
        brg[:k] = bearings[:k]
        lms[:k] = landmarks[:k]
        val[:k] = lm_valid[:k]
        self.bearings[slot] = brg
        self.landmarks[slot] = lms
        self.lm_valid[slot] = val
        self._order.append(kf_id)
        self.device_desc[slot] = torch.from_numpy(as_words(self.desc[slot])).to(self.device)
        self.device_mask[slot] = torch.from_numpy(self.mask[slot]).to(self.device)

    def remove(self, kf_id: int) -> None:
        slot = self.slot_of.pop(kf_id, None)
        if slot is None:
            return
        self.occupied[slot] = False
        self.kf_ids[slot] = None
        self._order.remove(kf_id)

    def query(self, desc_q: np.ndarray, mask_q: np.ndarray, exclude_ids: set,
              vote_threshold: int = 60) -> Tuple[Optional[int], float, np.ndarray]:
        """Best loop candidate (kf_id, score, all scores); None if no frame
        is allowed. Two host reads (syncstats `posegraph_query`): the best
        slot and the scores."""
        if len(self) == 0:
            return None, 0.0, np.zeros(self.frame_cap, np.float32)
        allowed = self.occupied.copy()
        for kf_id in exclude_ids:
            s = self.slot_of.get(kf_id)
            if s is not None:
                allowed[s] = False
        if not allowed.any():
            return None, 0.0, np.zeros(self.frame_cap, np.float32)
        kq = min(len(desc_q), self.kp_cap)
        dq = np.zeros((self.kp_cap, self.desc.shape[2]), self.desc.dtype)
        mq = np.zeros(self.kp_cap, bool)
        dq[:kq] = desc_q[:kq]
        mq[:kq] = mask_q[:kq]
        dev = self.device
        res = score_against_database(
            torch.from_numpy(as_words(dq)).to(dev), torch.from_numpy(mq).to(dev), self.device_desc,
            self.device_mask, torch.from_numpy(allowed).to(dev), vote_threshold=vote_threshold)
        syncstats.bump("posegraph_query", 2)
        idx = int(res.best_index)
        scores = res.scores.cpu().numpy()
        score = float(scores[idx])
        kf_id = self.kf_ids[idx] if score >= 0 else None
        return kf_id, max(score, 0.0), scores

    def geometry_of(self, kf_id: int):
        s = self.slot_of[kf_id]
        return self.desc[s], self.mask[s], self.bearings[s], self.landmarks[s], self.lm_valid[s]
