"""The Version-A ``LoopClosingSystem``: ORB features, Hamming matching,
multi-loop detection, pose estimation and triangulation per frame, and the
batched path over a whole frame stack.

Port of :mod:`slam_loop_closing_tpu.models.loop_closing`, the API the
reference only declares (loop_closing.hpp:29-80; behaviour in README.md:
94-147):

* :meth:`LoopClosingSystem.process_frame`: ORB features of the frame, match
  against the previous frame (BF Hamming, keep dist < 2 x min dist),
  relative pose (essential matrix + recoverPose, >= 8 points), triangulation
  (reject behind-camera or > 100 units), then the loop scan;
  :meth:`~LoopClosingSystem.process_stream` the same with the next frame's
  upload overlapped.
* :meth:`LoopClosingSystem.detect_loops`: scan a frame against every frame
  >= ``min_loop_gap`` older; a loop fires when ``similarity = matches /
  min(n1, n2) > loop_threshold`` AND the pair has >= ``min_matches`` good
  matches. Candidates come in target order.
* :meth:`LoopClosingSystem.process_video`: the batched path — ORB of a
  whole stack, ONE banded all-pairs good-match pass, the loop rule;
  candidates in (i, j) row-major order.
* :meth:`LoopClosingSystem.process_videos_batched`: several videos at once
  (:func:`videos_loop_scores`, :func:`loops_from_video_scores`) — the
  front-end a video at a time, then the bands of all videos through one
  launch of the band-count kernel.
* :meth:`LoopClosingSystem.save_results`: ``loop_closures.txt``,
  ``loop_X_Y.png`` per loop and ``matches_X_Y.png`` between every
  ``viz_every``-th consecutive frame pair (README.md:140-147).

The frame database lives on the device as fixed-capacity arrays
(:class:`FrameDatabase`), written in place. A frame's whole device work —
features, database insert, consecutive-pair geometry, the scan, and a
speculative re-triangulation against the scan's first hit — is enqueued
first and read back once (:func:`_readback`), as the JAX package does.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from slam_loop_closing_tpu_torch.config import (CameraConfig, PipelineConfig,
                                                RansacConfig)
from slam_loop_closing_tpu_torch.ops import descriptors as desc_ops
from slam_loop_closing_tpu_torch.ops import epipolar, matching, orb, ransac
from slam_loop_closing_tpu_torch.ops.image import ship_frames
from slam_loop_closing_tpu_torch.utils import io as io_utils


@dataclasses.dataclass
class LoopCandidate:
    """Mirror of the reference's ``LoopCandidate`` (loop_closing.hpp:22-27)."""

    current_frame_id: int
    matched_frame_id: int
    num_matches: int
    similarity_score: float


@dataclasses.dataclass
class Frame:
    """Mirror of the reference's ``Frame`` (loop_closing.hpp:12-19), with
    the cv::Mat members replaced by arrays. The keypoint and descriptor
    members stay on the system's device (reading them back eagerly would
    cost a device round trip per frame); ``pose`` and ``points3d`` are host
    numpy."""

    id: int
    image: object                     # [H, W] as given (numpy or tensor)
    keypoints_xy: torch.Tensor        # [N, 2] float32 (padded)
    keypoints_valid: torch.Tensor     # [N] bool
    descriptors: torch.Tensor         # [N, 8] int32 packed words
    pose: np.ndarray                  # [4, 4] world->camera
    points3d: np.ndarray              # [M, 3] triangulated points (variable)

    def image_f32(self) -> np.ndarray:
        """Image as host float32 in [0, 1] (the visualization contract)."""
        img = self.image
        if isinstance(img, torch.Tensor):
            img = img.cpu().numpy()
        img = np.asarray(img)
        return img.astype(np.float32) / (255.0 if img.dtype == np.uint8
                                         else 1.0)


@dataclasses.dataclass
class FrameDatabase:
    """The frame database on the device: one row per frame, in insertion
    order. ``packed`` is kernel C's layout (invalid rows zero)."""

    packed: torch.Tensor   # [max_frames, N, 8] int32 descriptor words
    valid: torch.Tensor    # [max_frames, N] bool
    xy: torch.Tensor       # [max_frames, N, 2] float32 keypoints (pixels)
    nfeat: torch.Tensor    # [max_frames] int32 valid keypoints per frame

    @classmethod
    def empty(cls, max_frames: int, num_features: int,
              device) -> "FrameDatabase":
        return cls(
            packed=torch.zeros((max_frames, num_features, 8),
                               dtype=torch.int32, device=device),
            valid=torch.zeros((max_frames, num_features), dtype=torch.bool,
                              device=device),
            xy=torch.zeros((max_frames, num_features, 2),
                           dtype=torch.float32, device=device),
            nfeat=torch.zeros(max_frames, dtype=torch.int32, device=device))

    def write(self, start: int, packed: torch.Tensor, valid: torch.Tensor,
              xy: torch.Tensor) -> None:
        """Rows ``start .. start + B`` from [B, ...] features, in place; the
        feature counts are reduced on the device (no host read)."""
        end = start + packed.shape[0]
        self.packed[start:end] = packed
        self.valid[start:end] = valid
        self.xy[start:end] = xy
        self.nfeat[start:end] = torch.sum(valid, dim=1, dtype=torch.int32)

    def row(self, i: int | torch.Tensor):
        """(packed, valid, xy) of frame ``i``, a Python int or a 0-d device
        tensor (selected on the device, no host read)."""
        if isinstance(i, int):
            return self.packed[i], self.valid[i], self.xy[i]
        i = i.reshape(1).long()
        return (self.packed.index_select(0, i)[0],
                self.valid.index_select(0, i)[0],
                self.xy.index_select(0, i)[0])


def _pair_geometry(packed1, valid1, xy1, packed2, valid2, xy2,
                   K: torch.Tensor, cfg: RansacConfig, scale: float,
                   radius: float, tau: float,
                   generator: torch.Generator | None = None,
                   idx: torch.Tensor | None = None):
    """Version-A geometry of frame 1 (queries) against frame 2: BF Hamming
    2x-min matching (README.md:116-117), PROSAC essential RANSAC +
    recoverPose (README.md:128-132), two-view triangulation with the
    behind-camera / >100-unit gates (README.md:134-138). Fixed-shape device
    tensors out: (match count, R, t, ok, X [N, 3], keep [N]); the caller
    reads them back and applies the accept gates.

    RANSAC samples with noise from ``generator``, or takes the minimal sets
    ``idx`` [H, 8] as given (then the PROSAC quality is not needed)."""
    m = matching.nn_matches_2xmin(packed1, valid1, packed2, valid2, scale)
    _, xy2m = matching.gather_matched_points(xy1, xy2, m)
    c = torch.stack([K[0, 2], K[1, 2]])
    f = torch.stack([K[0, 0], K[1, 1]])
    x1 = (xy1 - c) / f
    x2 = (xy2m - c) / f
    focal = (K[0, 0] + K[1, 1]) * 0.5
    if idx is None:
        # argument order as the JAX package's (previous frame's points first)
        quality = matching.prosac_quality(x2, x1, m, radius, tau)
        noise = ransac.gumbel_noise(generator, ransac.resolved_hypotheses(cfg),
                                    x1.shape[0])
        idx = ransac.sample_minimal_sets(noise, m.mask, cfg.min_points,
                                         quality)
    res = ransac.essential_from_samples(x1, x2, m.mask, idx, focal, cfg)
    eye = torch.eye(3, dtype=torch.float32, device=K.device)
    zero = torch.zeros(3, dtype=torch.float32, device=K.device)
    X = epipolar.triangulate_dlt(eye, zero, res.R, res.t, x1, x2)
    z1 = epipolar.depths(eye, zero, X)
    z2 = epipolar.depths(res.R, res.t, X)
    keep = (m.mask & (z1 > 0) & (z2 > 0)
            & (torch.sqrt(torch.sum(X * X, dim=-1)) < 100.0))
    return m.count, res.R, res.t, res.ok, X, keep


def _first_hit(counts: torch.Tensor, sims: torch.Tensor, threshold: float,
               min_matches: int):
    """Index of the lowest-index loop hit (the frame the loop is
    re-triangulated against, README.md:101-102; 0 if none) and whether
    there is one, on the device."""
    hit = (sims > threshold) & (counts >= min_matches)
    return torch.argmax(hit.to(torch.int32)), torch.any(hit)


def _readback(pending: dict) -> dict:
    """Every tensor of ``pending`` ({name: tuple of tensors}) as numpy, with
    ONE wait for the device: the copies are enqueued without blocking (to
    pinned host memory) and the current stream is synchronized once."""
    host = {k: tuple(t.to("cpu", non_blocking=True) for t in v)
            for k, v in pending.items()}
    devices = {t.device for v in pending.values() for t in v
               if t.device.type == "cuda"}
    for dev in devices:
        torch.cuda.current_stream(dev).synchronize()
    return {k: tuple(t.numpy() for t in v) for k, v in host.items()}


def videos_loop_scores(videos, cfg: PipelineConfig, device):
    """Device part of the multi-video path: ``videos`` [V, B, H, W] (numpy
    or tensor, uint8 or float in [0, 1]) -> ([V, B, B] int32 counts,
    [V, B, B] float32 similarities) on ``device``. The ORB front-end runs
    one video a batch, the batch :meth:`LoopClosingSystem.process_video`
    gives it. Its bits no longer depend on the batch (kernels J and M fix
    the order of every sum), so one batch over all videos would give the
    same loops; that batching is a later item, gated by the card test
    ``test_process_videos_batched_on_card_equals_per_video``. The bands of
    all videos then go through ONE launch of the band-count kernel
    (:func:`..ops.matching.banded_pair_counts_videos`)."""
    pattern = orb.brief_matrices(cfg.orb, device)
    feats = [orb.detect_and_describe_batch(ship_frames(video, device),
                                           cfg.orb, pattern)
             for video in videos]
    valid = torch.stack([f.keypoints.valid for f in feats])
    nfeat = torch.sum(valid, dim=2, dtype=torch.int32)
    counts = matching.banded_pair_counts_videos(
        torch.stack([f.signed for f in feats]), valid, cfg.loop.min_loop_gap,
        cfg.match.hamming_filter_scale)
    sims = matching.similarity(counts, nfeat[:, :, None], nfeat[:, None, :])
    return counts, sims


def _band_hits(counts: np.ndarray, sims: np.ndarray, cfg: PipelineConfig):
    """(i, j) of the loop rule's hits on [B, B] host score matrices, in
    row-major order: ``j <= i - min_loop_gap``, similarity above the
    threshold, at least ``min_matches`` good matches (README.md:119-126)."""
    b = counts.shape[0]
    band = np.tril(np.ones((b, b), bool), -cfg.loop.min_loop_gap)
    return np.argwhere(band & (sims > cfg.loop.loop_threshold)
                       & (counts >= cfg.loop.min_matches))


def loops_from_video_scores(counts: np.ndarray, sims: np.ndarray,
                            cfg: PipelineConfig
                            ) -> list[list[LoopCandidate]]:
    """Host part of the multi-video path: the Version-A loop rule over the
    per-video [V, B, B] score matrices."""
    return [[LoopCandidate(int(i), int(j), int(c[i, j]), float(s[i, j]))
             for i, j in _band_hits(c, s, cfg)]
            for c, s in zip(counts, sims)]


class LoopClosingSystem:
    """Version-A loop detector on one explicit ``device`` (a
    ``torch.device`` or its name, e.g. ``"cuda"`` or ``"cpu"``).
    ``max_frames`` bounds the device-side frame database, as in the JAX
    package; ``log`` receives one line per detected loop; RANSAC draws its
    noise from a generator on the device, seeded with 0 (the JAX package
    starts from ``PRNGKey(0)``)."""

    def __init__(self, config: PipelineConfig | None = None,
                 max_frames: int = 512, log=print, *, device):
        if config is None:
            # Version-A default: the README's assumed intrinsics
            # fx=fy=800, cx=640, cy=360 (README.md:137)
            config = dataclasses.replace(PipelineConfig(),
                                         camera=CameraConfig.assumed())
        self.config = config
        self.max_frames = max_frames
        self.log = log
        self.device = torch.device(device)
        cam = config.camera
        self.K = torch.tensor(cam.K, dtype=torch.float32, device=self.device)
        # PROSAC motion-coherence gates in normalized units, from the host
        # config (reading them off self.K would cost a device round trip)
        focal = 0.5 * (cam.fx + cam.fy)
        w_est = 2.0 * cam.cx
        self._radius = max(config.match.motion_radius_frac * w_est,
                           24.0) / focal
        self._tau = max(config.match.motion_tau_frac * w_est, 8.0) / focal
        self._pattern = orb.brief_matrices(config.orb, self.device)
        self._generator = torch.Generator(device=self.device)
        self._generator.manual_seed(0)
        self.db = FrameDatabase.empty(max_frames, config.orb.num_features,
                                      self.device)
        self.frames: list[Frame] = []
        self.loop_closures: list[LoopCandidate] = []
        self._frame_ids: list[int] = []

    # -- Version-A API (loop_closing.hpp:34-66) ---------------------------

    def detect_features(self, image) -> orb.OrbFeatures:
        """ORB detection of one ``[H, W]`` frame (hpp:37: detectFeatures),
        numpy or tensor, uint8 or float in [0, 1]: features with the batch
        axis dropped, on the system's device."""
        feats = orb.detect_and_describe_batch(
            ship_frames(image, self.device)[None], self.config.orb,
            self._pattern)
        return orb.OrbFeatures(
            keypoints=orb.Keypoints(*(a[0] for a in feats.keypoints)),
            descriptors=feats.descriptors[0], signed=feats.signed[0])

    def match_features(self, feats1: orb.OrbFeatures,
                       feats2: orb.OrbFeatures) -> matching.Matches:
        """BF Hamming + 2 x min-dist filter (hpp:40; README.md:116-117)."""
        return matching.nn_matches_2xmin(
            feats1.descriptors, feats1.keypoints.valid, feats2.descriptors,
            feats2.keypoints.valid, self.config.match.hamming_filter_scale)

    def estimate_pose(self, feats1: orb.OrbFeatures, feats2: orb.OrbFeatures,
                      m: matching.Matches):
        """Essential-matrix relative pose (hpp:43-45; README.md:128-132):
        (R, t, ok), ok False below 8 correspondences / 10 inliers."""
        x1, x2 = self._matched_normalized(feats1, feats2, m)
        quality = matching.prosac_quality(x2, x1, m, self._radius, self._tau)
        res = ransac.estimate_essential_ransac(
            x1, x2, m.mask, self._generator, (self.K[0, 0] + self.K[1, 1]) * 0.5,
            self.config.ransac, quality=quality)
        return res.R, res.t, bool(res.ok)

    def triangulate_points(self, feats1: orb.OrbFeatures,
                           feats2: orb.OrbFeatures, m: matching.Matches,
                           R: torch.Tensor, t: torch.Tensor) -> np.ndarray:
        """Two-view triangulation; rejects points behind either camera or
        farther than 100 units (README.md:134-138)."""
        x1, x2 = self._matched_normalized(feats1, feats2, m)
        eye = torch.eye(3, device=self.device)
        zero = torch.zeros(3, device=self.device)
        X = epipolar.triangulate_dlt(eye, zero, R, t, x1, x2)
        keep = (m.mask & (epipolar.depths(eye, zero, X) > 0)
                & (epipolar.depths(R, t, X) > 0)
                & (torch.sqrt(torch.sum(X * X, dim=-1)) < 100.0))
        return X[keep].cpu().numpy()

    def process_frame(self, image,
                      frame_id: Optional[int] = None) -> list[LoopCandidate]:
        """Full per-frame pipeline (hpp:34; README.md:94-126). Returns the
        loops detected at this frame. Everything the frame needs is enqueued
        on the device, then read back once; only a host/device disagreement
        on the scan's first hit costs a second readback."""
        idx = len(self.frames)
        if idx >= self.max_frames:
            raise ValueError(f"max_frames={self.max_frames} exceeded")
        fid = idx if frame_id is None else frame_id
        feats = self.detect_features(image)
        kp = feats.keypoints
        self.db.write(idx, feats.descriptors[None], kp.valid[None], kp.xy[None])
        self._frame_ids.append(fid)

        pending = {}
        if idx > 0:
            pending["geom"] = self._geometry(idx, idx - 1)
        counts_d, sims_d = self._scan_scores(idx)
        pending["scores"] = (counts_d, sims_d)
        cfg_l = self.config.loop
        if idx >= cfg_l.min_loop_gap:
            # speculative re-triangulation (README.md:101-102) against the
            # first-hit frame, selected on the device. It applies only if the
            # readback confirms the device saw a hit AND its index equals
            # the host's first hit (the device compare is float32 tensors,
            # the host one numpy: at a knife-edge similarity they may
            # disagree, and the re-triangulation is then redone below). On
            # a multi-loop frame only the FIRST hit is re-triangulated, as
            # in the reference's flow.
            jstar, anyhit = _first_hit(counts_d, sims_d, cfg_l.loop_threshold,
                                       cfg_l.min_matches)
            pending["regeom"] = self._geometry(idx, jstar)
            pending["regeom_target"] = (jstar, anyhit)
        out = _readback(pending)  # the frame's single readback

        pose = np.eye(4)
        points3d = np.zeros((0, 3), np.float32)
        if idx > 0:
            count, R, t, ok, X, keep = out["geom"]
            if int(count) >= self.config.ransac.min_points and bool(ok):
                pose[:3, :3] = R
                pose[:3, 3] = t
                points3d = X[keep]
        self.frames.append(Frame(
            id=fid, image=image, keypoints_xy=kp.xy,
            keypoints_valid=kp.valid, descriptors=feats.descriptors,
            pose=pose, points3d=points3d))

        new_loops = self._emit_loops(idx, *out["scores"])
        if new_loops and "regeom" in out:
            jstar_h, anyhit_h = out["regeom_target"]
            first = self._frame_ids.index(new_loops[0].matched_frame_id)
            if bool(anyhit_h) and int(jstar_h) == first:
                geom = out["regeom"]
            else:
                geom = _readback({"g": self._geometry(idx, first)})["g"]
            self._keep_points(idx, geom)
        return new_loops

    def process_stream(self, frames, frame_ids: list[int] | None = None):
        """Live frame-at-a-time processing with a double-buffered upload:
        on a CUDA device, frame ``k+1`` is copied from pinned host memory on
        a side stream while :meth:`process_frame` works on frame ``k``.
        Yields ``(frame_id, loops)`` per frame; the loops are those of
        calling :meth:`process_frame` in a plain loop (the side stream only
        moves the upload; no device computation is reordered)."""
        n = len(frames)
        ids = list(frame_ids) if frame_ids is not None else [None] * n
        if self.device.type != "cuda":
            for i in range(n):
                yield ids[i], self.process_frame(frames[i], frame_id=ids[i])
            return
        copy_stream = torch.cuda.Stream(self.device)
        main = torch.cuda.current_stream(self.device)
        nxt = self._upload(frames[0], copy_stream) if n else None
        for i in range(n):
            cur, ready = nxt
            main.wait_event(ready)
            # the frame was allocated on the copy stream and is used here
            cur.record_stream(main)
            if i + 1 < n:
                nxt = self._upload(frames[i + 1], copy_stream)
            yield ids[i], self.process_frame(cur, frame_id=ids[i])

    def detect_loops(self, idx: int) -> list[LoopCandidate]:
        """Loop scan of frame ``idx`` against all frames >= min_loop_gap
        older (hpp:48; README.md:119-126). On a loop, this frame's 3D points
        are re-triangulated against the first matched frame
        (README.md:101-102)."""
        counts, sims = _readback({"s": self._scan_scores(idx)})["s"]
        new_loops = self._emit_loops(idx, counts, sims)
        if new_loops and idx < len(self.frames):
            j = self._frame_ids.index(new_loops[0].matched_frame_id)
            self._keep_points(idx, _readback({"g": self._geometry(idx, j)})["g"])
        return new_loops

    def get_frames(self) -> list[Frame]:
        return self.frames

    def get_loop_closures(self) -> list[LoopCandidate]:
        return self.loop_closures

    def visualize_matches(self, id1: int, id2: int, path: str | Path) -> Path:
        """Side-by-side match image between two processed frames (hpp:56)."""
        i = self._frame_ids.index(id1)
        j = self._frame_ids.index(id2)
        fi, fj = self._features_of(i), self._features_of(j)
        m = self.match_features(fi, fj)
        return io_utils.save_match_visualization(
            path, self.frames[i].image_f32(), self.frames[j].image_f32(),
            fi.keypoints.xy.cpu().numpy(), fj.keypoints.xy.cpu().numpy(),
            m.mask.cpu().numpy(), m.idx.cpu().numpy())

    def save_results(self, out_dir: str | Path,
                     match_viz: bool = True) -> Path:
        """``loop_closures.txt`` + visualizations (hpp:66; README.md:140-147):
        ``loop_X_Y.png`` per loop and ``matches_X_Y.png`` between every
        ``viz_every``-th consecutive frame pair (README.md:144)."""
        out = Path(out_dir)
        out.mkdir(parents=True, exist_ok=True)
        txt = io_utils.write_loop_closures_txt(
            out / "loop_closures.txt",
            [{"current": c.current_frame_id, "matched": c.matched_frame_id,
              "num_matches": c.num_matches, "similarity": c.similarity_score}
             for c in self.loop_closures],
            total_frames=len(self.frames))
        for c in self.loop_closures:
            self.visualize_matches(
                c.current_frame_id, c.matched_frame_id,
                out / f"loop_{c.current_frame_id}_{c.matched_frame_id}.png")
        if match_viz:
            every = self.config.loop.viz_every
            for i in range(every, len(self._frame_ids), every):
                a, b = self._frame_ids[i], self._frame_ids[i - 1]
                self.visualize_matches(a, b, out / f"matches_{a}_{b}.png")
        return txt

    # -- batched path ------------------------------------------------------

    def process_video(self, frames, frame_ids: list[int] | None = None
                      ) -> list[LoopCandidate]:
        """Loop detection over a ``[B, H, W]`` frame stack (numpy or tensor,
        uint8 or float in [0, 1]): batched ORB front-end, banded all-pairs
        good-match counts, loop rule. Returns the new loops. The features
        are mirrored into the frame database and :attr:`frames` (identity
        poses, no points), so a later :meth:`detect_loops` or
        :meth:`save_results` sees the frames."""
        b = frames.shape[0]
        if b > self.max_frames:
            raise ValueError("frame stack exceeds max_frames")
        ids = list(frame_ids) if frame_ids is not None else list(range(b))
        feats = orb.detect_and_describe_batch(
            ship_frames(frames, self.device), self.config.orb, self._pattern)
        kp = feats.keypoints
        self.db.write(0, feats.descriptors, kp.valid, kp.xy)

        cfg = self.config.loop
        new_loops: list[LoopCandidate] = []
        if b > cfg.min_loop_gap:
            counts = matching.banded_pair_counts(
                feats.signed, kp.valid, cfg.min_loop_gap,
                self.config.match.hamming_filter_scale)
            nfeat = self.db.nfeat[:b]
            sims = matching.similarity(counts, nfeat[:, None], nfeat[None, :])
            counts, sims = _readback({"s": (counts, sims)})["s"]
            for i, j in _band_hits(counts, sims, self.config):
                new_loops.append(LoopCandidate(ids[i], ids[j],
                                               int(counts[i, j]),
                                               float(sims[i, j])))
        self.loop_closures.extend(new_loops)
        self._frame_ids = ids
        self.frames = [
            Frame(id=ids[i], image=frames[i], keypoints_xy=kp.xy[i],
                  keypoints_valid=kp.valid[i],
                  descriptors=feats.descriptors[i], pose=np.eye(4),
                  points3d=np.zeros((0, 3), np.float32))
            for i in range(b)]
        return new_loops

    # -- multi-video batched path ------------------------------------------

    @staticmethod
    def process_videos_batched(videos, config: PipelineConfig | None = None,
                               *, device) -> list[list[LoopCandidate]]:
        """All videos processed together on ``device``: ``videos``
        [V, B, H, W] -> per-video loop candidate lists (frame indices as
        ids), equal to :meth:`process_video` run on each video alone."""
        cfg = config or PipelineConfig()
        v, b = videos.shape[:2]
        if b <= cfg.loop.min_loop_gap:
            return [[] for _ in range(v)]
        counts, sims = videos_loop_scores(videos, cfg, device)
        counts, sims = _readback({"s": (counts, sims)})["s"]
        return loops_from_video_scores(counts, sims, cfg)

    # -- internals ---------------------------------------------------------

    def _features_of(self, idx: int) -> orb.OrbFeatures:
        """Frame ``idx``'s features from the database (response, angle and
        octave are not kept there: zeros)."""
        packed, valid, xy = self.db.row(idx)
        zeros = torch.zeros(packed.shape[0], device=self.device)
        kps = orb.Keypoints(xy=xy, response=zeros, angle=zeros,
                            octave=zeros.to(torch.int32), valid=valid)
        signed = desc_ops.bits_to_signed(desc_ops.packed_to_bits(packed))
        return orb.OrbFeatures(keypoints=kps, descriptors=packed,
                               signed=signed * valid[:, None].to(torch.int8))

    def _geometry(self, i: int, j: int | torch.Tensor):
        """:func:`_pair_geometry` of database frames ``i`` (queries) and
        ``j`` (an int, or a 0-d device tensor selected on the device)."""
        return _pair_geometry(
            *self.db.row(i), *self.db.row(j), self.K, self.config.ransac,
            self.config.match.hamming_filter_scale, self._radius, self._tau,
            generator=self._generator)

    def _keep_points(self, idx: int, geom) -> None:
        """Replace frame ``idx``'s points with a read-back geometry's, if
        its pose passes the accept gates."""
        count, _R, _t, ok, X, keep = geom
        if int(count) >= self.config.ransac.min_points and bool(ok):
            self.frames[idx].points3d = X[keep]

    def _scan_scores(self, idx: int):
        """Enqueue the loop scan of frame ``idx``: ([nb] counts, [nb]
        similarities) against the first ``nb`` database rows, ``nb`` the
        power of two (>= 32, <= max_frames) covering the frames so far.
        Only the frames ``t <= idx - min_loop_gap`` are counted (one
        frame-pair kernel launch over them); the rest are zero."""
        cfg = self.config.loop
        nb = 32
        while nb < idx + 1:
            nb *= 2
        nb = min(nb, self.max_frames)
        nt = idx - cfg.min_loop_gap + 1
        counts = torch.zeros(nb, dtype=torch.int32, device=self.device)
        if nt > 0:
            counts[:nt] = self._pair_counts(
                idx, torch.arange(nt, dtype=torch.int32, device=self.device))
        sims = matching.similarity(counts, self.db.nfeat[idx],
                                   self.db.nfeat[:nb])
        return counts, torch.where(torch.arange(nb, device=self.device) < nt,
                                   sims, 0.0)

    def _pair_counts(self, idx: int, targets: torch.Tensor) -> torch.Tensor:
        from slam_loop_closing_tpu_torch.ops import cuda_kernels

        qidx = torch.full_like(targets, idx)
        return cuda_kernels.pair_counts(
            self.db.packed, self.db.valid, qidx, targets,
            self.config.match.hamming_filter_scale)

    def _emit_loops(self, idx: int, counts: np.ndarray,
                    sims: np.ndarray) -> list[LoopCandidate]:
        """Build, record and log the loop candidates of host scan scores."""
        cfg = self.config.loop
        hits = np.flatnonzero((sims > cfg.loop_threshold)
                              & (counts >= cfg.min_matches))
        new_loops = []
        for j in hits:
            cand = LoopCandidate(
                current_frame_id=self._frame_ids[idx],
                matched_frame_id=self._frame_ids[int(j)],
                num_matches=int(counts[j]),
                similarity_score=float(sims[j]))
            new_loops.append(cand)
            self.loop_closures.append(cand)
            self.log(f"Loop closure detected: frame {cand.current_frame_id} "
                     f"<-> frame {cand.matched_frame_id} "
                     f"({cand.num_matches} matches, similarity "
                     f"{cand.similarity_score:.4f})")
        return new_loops

    def _matched_normalized(self, feats1: orb.OrbFeatures,
                            feats2: orb.OrbFeatures, m: matching.Matches):
        """Matched pairs in normalized camera coordinates, fixed shape."""
        xy1, xy2 = matching.gather_matched_points(
            feats1.keypoints.xy, feats2.keypoints.xy, m)
        c = torch.stack([self.K[0, 2], self.K[1, 2]])
        f = torch.stack([self.K[0, 0], self.K[1, 1]])
        return (xy1 - c) / f, (xy2 - c) / f

    def _upload(self, frame, stream: torch.cuda.Stream):
        """Enqueue ``frame``'s host-to-device copy on ``stream`` from pinned
        memory: (device tensor, event recorded after the copy)."""
        host = torch.as_tensor(frame, device="cpu").contiguous().pin_memory()
        with torch.cuda.stream(stream):
            dev = host.to(self.device, non_blocking=True)
        ready = torch.cuda.Event()
        ready.record(stream)
        return dev, ready
