"""Configuration for the whole framework — a copy of
``slam_loop_closing_tpu/config.py`` (which imports nothing of JAX but sits in
a package whose ``__init__`` does), so JSON configs round-trip unchanged
between the two packages; tests hold the copies equal.

Every tunable that is a compile-time constant in the reference becomes a typed
config field here, with the reference default and citation:

* keyframe / triangulation / outlier gates: reference main.cpp:34-59
* loop-detection thresholds (Version A): reference loop_closing.hpp:31,
  README.md:104-126
* hardcoded camera calibration: reference main.cpp:1076-1084
* README "assumed" intrinsics (Version A): reference README.md:137

Configs are frozen dataclasses so they are hashable (usable as cache keys).
"""

from __future__ import annotations

import dataclasses
import enum
import json
from typing import Tuple


class PoseGraphMethod(enum.Enum):
    """Pose-graph optimization backend (reference main.cpp:54-58)."""

    SIMPLE_LINEAR = "simple_linear"
    GAUSS_NEWTON = "gauss_newton"


@dataclasses.dataclass(frozen=True)
class OrbConfig:
    """ORB detector/descriptor (reference README.md:112-115, loop_closing.hpp:72)."""

    num_features: int = 2000        # README.md:114 (ORB 2000); SIFT path uses 4000
    fast_threshold: int = 20        # FAST-9 intensity threshold (OpenCV ORB default)
    num_levels: int = 4             # image-pyramid levels
    scale_factor: float = 1.2       # pyramid scale step
    patch_size: int = 31            # orientation / BRIEF patch diameter
    descriptor_bits: int = 256      # README.md:115: 256-bit binary descriptors
    nms_radius: int = 1             # 3x3 non-max suppression
    pattern_seed: int = 17          # deterministic rBRIEF sampling-pattern seed
    brief_bins: int = 30            # quantized pattern rotations (12 deg steps)
    border: int = 19                # keypoint exclusion border (>= patch half 16)
    grid_cell: int = 0              # >0: one keypoint per NxN cell (faster,
                                    # spreads features; changes selection)


@dataclasses.dataclass(frozen=True)
class SiftConfig:
    """SIFT-class float front-end for the Version-B pipeline (main.cpp:497-504).

    A Gaussian-pyramid DoG detector + 4x4x8 gradient-histogram descriptor;
    quality parity with cv::SIFT, not bit parity.
    """

    num_features: int = 4000        # main.cpp:502: cv::SIFT::create(4000)
    num_octaves: int = 4
    scales_per_octave: int = 3
    contrast_threshold: float = 0.04
    edge_threshold: float = 10.0
    sigma0: float = 1.6
    # grid_cell > 0: keep at most one keypoint per cell x cell spatial cell
    # (max over the scale axis too). Shrinks the top-K input ~cell^2 x
    # (S+2) and removes multi-scale duplicate keypoints, which measurably
    # raises match purity; changes which keypoints are picked, so opt-in
    # like OrbConfig.grid_cell.
    grid_cell: int = 0
    # Frames processed per device step in the batched front-end: bounds the
    # transient Gaussian/DoG stacks ([chunk, S+2, H, W] each — a 96-frame
    # 1080p batch would need ~15 GB of HBM temps unchunked).
    batch_chunk: int = 8


@dataclasses.dataclass(frozen=True)
class MatchConfig:
    """Descriptor matching (reference main.cpp:509-534, README.md:116-117)."""

    ratio_threshold: float = 0.75   # Lowe ratio, main.cpp:513 default
    loop_ratio_threshold: float = 0.7   # tighter ratio in loop search, main.cpp:1386
    hamming_filter_scale: float = 2.0   # keep dist < 2 x min dist, README.md:117
    # (the >=50-good-matches loop gate lives in LoopConfig.min_matches)
    # Motion-coherence support (ops/matching.motion_support) used as the
    # PROSAC sampling quality in RANSAC — TPU-native addition, no reference
    # equivalent (OpenCV compensates with adaptive iteration counts,
    # main.cpp:589). Radii as fractions of image width.
    motion_radius_frac: float = 0.13
    motion_tau_frac: float = 0.016


@dataclasses.dataclass(frozen=True)
class LoopConfig:
    """Version-A loop detection rule (reference README.md:104-126, loop_closing.hpp:31)."""

    loop_threshold: float = 0.15    # README.md:108 (header default is 0.7, hpp:31)
    min_loop_gap: int = 30          # README.md:109
    frame_skip: int = 3             # README.md:110
    min_matches: int = 50           # README.md:125
    viz_every: int = 10             # matches_X_Y.png every 10th frame, README.md:144


@dataclasses.dataclass(frozen=True)
class LoopVerifyConfig:
    """Version-B single-best-loop verification gates (reference
    main.cpp:1386-1418). Defaults are the reference's SIFT-4000 numbers;
    scale them with the feature budget."""

    min_matches: int = 300          # main.cpp:1388: need > 300 matches
    min_inliers: int = 200          # main.cpp:1403
    min_inlier_ratio: float = 0.6   # main.cpp:1403
    min_pose_inliers: int = 100     # main.cpp:1407-1418


@dataclasses.dataclass(frozen=True)
class KeyframeConfig:
    """Version-B keyframe gates (reference main.cpp:36-44)."""

    min_median_displacement: float = 20.0   # main.cpp:37
    max_median_displacement: float = 150.0  # main.cpp:38
    min_tracked_features: int = 100         # main.cpp:39
    min_inlier_ratio: float = 0.3           # main.cpp:40
    min_inliers: int = 50                   # main.cpp:41 MIN_INLIERS_FOR_KEYFRAME


@dataclasses.dataclass(frozen=True)
class RansacConfig:
    """Essential-matrix RANSAC (reference main.cpp:586-614).

    The reference uses OpenCV's adaptive-iteration RANSAC (prob 0.999, 1 px
    threshold). On TPU we run a fixed batch of hypotheses: 512 gives 0.999
    confidence for inlier ratios >= ~0.58 (typical for gated keyframe
    pairs); raise it for low-ratio regimes (see ops/ransac.py budget math).

    ``num_hypotheses = 0`` derives the budget from ``confidence`` at
    ``design_inlier_ratio`` via the classic RANSAC bound
    (ops/ransac.hypotheses_for) — the reference's prob=0.999 contract made
    explicit. The default stays a fixed 512 so compiled shapes are stable.
    """

    threshold_px: float = 1.0       # main.cpp:590
    confidence: float = 0.999       # main.cpp:589; drives the budget when
                                    # num_hypotheses == 0
    num_hypotheses: int = 512       # fixed TPU hypothesis budget (0 = derive
                                    # from confidence at design_inlier_ratio)
    design_inlier_ratio: float = 0.585  # worst-case w the derived budget
                                        # must guarantee confidence at
    min_points: int = 8             # main.cpp:574: need >= 8 correspondences
    min_inliers: int = 10           # main.cpp:604
    refit_iters: int = 5            # LO-RANSAC inlier-refit iterations


@dataclasses.dataclass(frozen=True)
class TriangulationConfig:
    """Triangulation gates (reference main.cpp:45-48, 1261-1341)."""

    min_depth_rel: float = 0.1      # main.cpp:45 MIN_DEPTH x baseline
    max_depth_rel: float = 50.0     # main.cpp:46 MAX_DEPTH x baseline
    min_parallax_deg: float = 1.0   # main.cpp:47
    max_reproj_error_px: float = 4.0  # main.cpp:48


@dataclasses.dataclass(frozen=True)
class PgoConfig:
    """Pose-graph optimization (reference main.cpp:54-59, 282-445)."""

    method: PoseGraphMethod = PoseGraphMethod.GAUSS_NEWTON  # main.cpp:58
    max_iterations: int = 20        # main.cpp:59
    loop_edge_weight: float = 10.0  # main.cpp:1468
    damping: float = 1e-4           # main.cpp:411: lambda = 1e-4 tr(H)/n
    convergence_tol: float = 1e-6   # main.cpp:424 max-update stop
    # TPU scale-out: above this pose count switch from dense Cholesky to
    # matrix-free Gauss-Newton preconditioned CG (JVP/VJP normal equations).
    dense_solver_max_poses: int = 1500
    cg_iterations: int = 100


@dataclasses.dataclass(frozen=True)
class BaConfig:
    """Alternating bundle adjustment (reference main.cpp:632-943)."""

    outer_iterations: int = 5       # main.cpp:1546 (3 on the filtered map, :1666)
    camera_gn_iterations: int = 5   # main.cpp:929
    point_gn_iterations: int = 5    # main.cpp:934
    camera_damping: float = 1e-3    # main.cpp:676 fixed LM damping
    point_damping: float = 1e-3     # main.cpp:800
    min_camera_observations: int = 10   # main.cpp:648
    min_point_observations: int = 2     # main.cpp:771


@dataclasses.dataclass(frozen=True)
class OutlierConfig:
    """Map outlier removal (reference main.cpp:51, 1557-1659)."""

    reproj_threshold_px: float = 5.0    # main.cpp:51
    distance_floor: float = 10.0        # main.cpp:1601 max(10, ...)
    distance_scale: float = 5.0         # main.cpp:1601 5 x max camera spread


@dataclasses.dataclass(frozen=True)
class CameraConfig:
    """Pinhole intrinsics + 5-coefficient distortion.

    Defaults are the reference's hardcoded iPhone calibration
    (main.cpp:1076-1084). ``assumed()`` gives the Version-A README intrinsics
    (README.md:137).
    """

    fx: float = 1226.991674550505
    fy: float = 1231.583548480416
    cx: float = 529.5391035340654
    cy: float = 936.7114915473007
    k1: float = 0.009593106889362086
    k2: float = -0.08836017837645339
    p1: float = -0.002369764239215277
    p2: float = -0.002095085353035259
    k3: float = 0.1736273482549004

    @staticmethod
    def assumed() -> "CameraConfig":
        return CameraConfig(fx=800.0, fy=800.0, cx=640.0, cy=360.0,
                            k1=0.0, k2=0.0, p1=0.0, p2=0.0, k3=0.0)

    @property
    def K(self):
        import numpy as np

        return np.array(
            [[self.fx, 0.0, self.cx], [0.0, self.fy, self.cy], [0.0, 0.0, 1.0]],
            dtype=np.float64,
        )

    @property
    def dist_coeffs(self):
        import numpy as np

        return np.array([self.k1, self.k2, self.p1, self.p2, self.k3],
                        dtype=np.float64)


@dataclasses.dataclass(frozen=True)
class CalibrationConfig:
    """Chessboard calibration tool (reference calibrate.cpp:5-150)."""

    board_cols: int = 9             # calibrate.cpp:9 inner corners
    board_rows: int = 6
    square_size_m: float = 0.03     # calibrate.cpp:10: 3 cm squares
    refine_window: int = 11         # cornerSubPix 11x11 half-window, calibrate.cpp:85
    refine_iterations: int = 30     # cornerSubPix term criteria, calibrate.cpp:86
    refine_eps: float = 1e-3        # cornerSubPix eps, calibrate.cpp:86
    lm_iterations: int = 30         # joint-LM iterations (cv::calibrateCamera stage)


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Device-mesh layout for scale-out (TPU-native; no reference equivalent —
    the reference is single-threaded, SURVEY.md section 2.11)."""

    data_axis: str = "data"
    num_devices: int = 0            # 0 = use all available


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    """Top-level pipeline configuration bundling all the stage configs.

    ``detector`` picks the SfM front-end: "orb" (binary, Hamming MXU path —
    the TPU-native default) or "sift" (float, L2 GEMM path — the detector
    the reference's main.cpp actually ships, main.cpp:497-504).
    """

    detector: str = "orb"
    orb: OrbConfig = OrbConfig()
    sift: SiftConfig = SiftConfig()
    match: MatchConfig = MatchConfig()
    loop: LoopConfig = LoopConfig()
    loop_verify: LoopVerifyConfig = LoopVerifyConfig()
    keyframe: KeyframeConfig = KeyframeConfig()
    ransac: RansacConfig = RansacConfig()
    triangulation: TriangulationConfig = TriangulationConfig()
    pgo: PgoConfig = PgoConfig()
    ba: BaConfig = BaConfig()
    outlier: OutlierConfig = OutlierConfig()
    camera: CameraConfig = CameraConfig()
    calibration: CalibrationConfig = CalibrationConfig()
    mesh: MeshConfig = MeshConfig()
    video_filename: str = "IMG_0284.MOV"    # main.cpp:35

    def to_json(self) -> str:
        def enc(o):
            if dataclasses.is_dataclass(o):
                return {k: enc(v) for k, v in dataclasses.asdict(o).items()}
            if isinstance(o, enum.Enum):
                return o.value
            return o

        return json.dumps(enc(self), indent=2, default=lambda o: o.value)

    @staticmethod
    def from_json(text: str) -> "PipelineConfig":
        raw = json.loads(text)

        def build(cls, d):
            kwargs = {}
            for f in dataclasses.fields(cls):
                if f.name not in d:
                    continue
                v = d[f.name]
                if dataclasses.is_dataclass(f.type) or f.name in _SUB:
                    kwargs[f.name] = build(_SUB[f.name], v)
                elif f.name == "method":
                    kwargs[f.name] = PoseGraphMethod(v)
                else:
                    kwargs[f.name] = v
            return cls(**kwargs)

        _SUB = {
            "orb": OrbConfig, "sift": SiftConfig, "match": MatchConfig,
            "loop": LoopConfig, "loop_verify": LoopVerifyConfig,
            "keyframe": KeyframeConfig,
            "ransac": RansacConfig, "triangulation": TriangulationConfig,
            "pgo": PgoConfig, "ba": BaConfig, "outlier": OutlierConfig,
            "camera": CameraConfig, "calibration": CalibrationConfig,
            "mesh": MeshConfig,
        }
        return build(PipelineConfig, raw)
