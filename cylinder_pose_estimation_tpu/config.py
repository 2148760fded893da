"""Static configuration for the detect->pose pipeline.

The reference scatters its configuration as hardcoded constants at call sites
(SURVEY.md §5 "Config / flag system"): cylinder radius 45
(ref exp_gridDetection.m:39), patch 3 / error 0.3 (ref utils/fitSingleCylinder.m:12),
kinematic config [321.1, 143.1, 110] (ref utils/getTAGVcyl.m:9), polynomial degree
2 vs 1 (ref utils/util_cylinder.py:2035 vs utils/util_plane.py:2820), and dozens of
kernel sizes/thresholds throughout the detection stages.  Here they are all
centralized into frozen dataclasses that are *static* under jit: every field is
a Python int/float/bool/str, the dataclasses are hashable, and they parametrize
trace-time shapes (MAX_* capacities) and compile-time constants.

Deliberate plane-vs-cylinder differences in the reference are encoded as two
config subclasses, not code forks (SURVEY.md §7 "hard parts" (e)).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class DetectConfig:
    """Shared grid-detection front-end configuration.

    Field provenance is cited against the reference implementation so parity
    can be audited; shapes (image size, capacities) are ours.
    """

    # --- static shapes -----------------------------------------------------
    height: int = 480
    width: int = 640
    # Capacity of the fixed-size point/label arrays (ragged data in the
    # reference becomes dense arrays + validity masks).
    max_points: int = 512        # joint centroids / grid points per image
    max_rows: int = 24           # row labels (reference uses dicts keyed row1..N)
    max_cols: int = 24           # col labels
    cc_iters: int = 16           # bounded connected-component label rounds;
                                 # each round = 3x3 pool + full row & column
                                 # segmented scans, so convergence needs
                                 # O(#direction changes) rounds, not O(diameter)
    label_downsample: int = 2    # line-mask labeling + component stats run at
                                 # 1/this resolution (2x2 max-pool).  Labels
                                 # only serve as grouping keys for joint
                                 # centroids and px-scale gate statistics;
                                 # pooling preserves component identity for
                                 # masks spaced > 2 px (laser-grid pitch is
                                 # >= ~12 px) and quarters the cost of the
                                 # detector's three most expensive stages.
                                 # Set 1 for full-res labeling.

    # --- preprocess / binarize (ref utils/util_cylinder.py:1769-1802) ------
    blur_ksize: int = 5          # cv2.GaussianBlur (5,5), sigma=0 -> 1.1
    ridge_sigma: float = 3.0     # hessian_matrix sigma (ref :1796)
    sauvola_window: int = 15     # ref :1740
    sauvola_k: float = 0.5
    sauvola_r: float = 128.0

    # --- joints (ref utils/util_cylinder.py:1805-1827) ---------------------
    line_kernel_len: int = 20    # 20x1 / 1x20 rect opening kernels

    # --- centroid/center seed (ref utils/util_cylinder.py:1902-1941) -------
    center_patch_half: int = 5   # 11x11 brightness patch around centroid
    joint_peak_iters: int = 5    # masked 3x3 max-propagation rounds for the
                                 # per-blob joint peak (bounds the blob graph
                                 # radius; joint blobs are the AND of two
                                 # <= 9 px line openings).  8 was the 2x-
                                 # margin setting; 5 is xy-identical over the
                                 # 16-scene bench

    # --- saturation masking (ref utils/util_cylinder.py:1944-2007) ---------
    sat_blur_ksize: int = 19
    sat_threshold: float = 240.0

    # --- line bridging (ref utils/util_cylinder.py:78-237) -----------------
    bridge_repeats: int = 1      # expands_line_roi(mask, 1, ...) ref :2022
    endpoint_probe_len: int = 9  # our endpoint detector's directional probe
    bridge_skip_long: bool = True  # don't expand near-full-length segments
    bridge_long_frac: float = 0.8  # "long" = extent > frac * max extent
                                   # (ref utils/util_cylinder.py:169 gate)
    bridge_stats_k: int = 32     # line components tracked for the bridge's
                                 # angle/expandability stats (the one-hot
                                 # stats matmuls and the (HW, K) gate compare
                                 # scale linearly in K; a 480x640 grid scene
                                 # has < 30 line fragments per orientation --
                                 # at the bridge's half resolution fragments
                                 # only merge, so 32 keeps margin)
    bridge_stats_quarter: bool = True  # compute the bridge's moment stats
                                 # over 2x2-min-pooled labels (4x smaller
                                 # one-hot passes; gates keep px meaning via
                                 # a 2x moment rescale; xy-identical over the
                                 # 16-scene bench)
    roi_blob_k: int = 32         # component slots for the largest-blob ROI
                                 # stats at quarter res (the (HW/16, K)
                                 # one-hot reductions scale linearly in K;
                                 # the ROI seed is a 9x9-dilated quarter-res
                                 # union -- a handful of merged blobs, so 32
                                 # is ample)

    # --- polynomial fitting (ref utils/util_cylinder.py:454-550) -----------
    poly_degree: int = 2         # cylinder path deg 2 (ref :2035)
    domain_margin: float = 50.0  # domain extended +-50 px (ref :497-499)
    newton_iters: int = 12       # our intersection solver (ref scipy root :1074)
    intersection_tol: float = 1e-3  # domain acceptance tol (ref :1095-1100)

    # --- subpixel refinement (ref utils/util_cylinder.py:706-971, OFF in the
    # reference's main path: commented out at ref :2040) --------------------
    subpixel_refine: bool = False
    subpixel_samples: int = 64
    subpixel_window: int = 7

    # --- indexing (ref utils/util_cylinder.py:1350-1571) -------------------
    index_blur_ksize: int = 7    # Gaussian (7,7) before brightness scan
    patch_half_min: int = 3      # brightness patch half-size floor (ref
                                 # :1379 min); above it the patch grows with
                                 # the saturation radius like the reference's
                                 # (circle_radius0/5, ref :1377; detector
                                 # stage 6g, traced-range rectangle means).

    # --- result gating ------------------------------------------------------
    # Minimum accepted intersections for DetectResult.ok.  The downstream
    # cylinder fit needs >= FitConfig.knn_k well-spread points for its
    # curvature seeding (ref utils/estCurvatures.m:6 K=20); fewer points would
    # run the LM chain on garbage with ok=True.
    min_ok_points: int = 20
    # Stability fence for the documented steep-diagonal chaotic regime
    # (PARITY.md, known deviations: on >= ~30 deg diagonal grids fragment
    # merges cascade through polyfit/indexing, so small numeric differences
    # change the labels).  DetectResult.stable is False
    # when the median |line tilt| from the grid axes exceeds this (radians)
    # or the final labeling CC did not reach its fixpoint; frame_health
    # masks such frames out of multi-frame registration.
    max_stable_tilt: float = 0.35  # ~20 deg; bench scenes are < 0.1
    # Second fence for the same regime: beyond ~20 deg the 20-px axis-
    # aligned line openings (ref utils/util_cylinder.py:1810-1815) shred
    # tilted lines into short axis-aligned specks -- the measured tilt goes
    # to ~0 (the specks ARE axis-aligned) while detection keeps "working"
    # chaotically.  The tell is retention: the fraction of binarized pixels
    # surviving the openings collapses (measured: legit scene families
    # >= 0.98; 22-26 deg grids 0.20-0.34; 32 deg 0.0).
    min_mask_retention: float = 0.6

    # --- plane-path short-column merge (ref utils/util_plane.py:449-557) ----
    # Merge consecutive "abnormal" short columns (span <= 0.9 * max span)
    # while their cumulative span stays <= the max span, then refit.  ON the
    # reference's main plane path (called from fit_and_draw_polynomial at
    # ref utils/util_plane.py:2828); not part of the cylinder path.
    merge_short_cols: bool = False
    merge_margin: float = 10.0   # +-10 px domain pad in the stored span
                                 # (ref utils/util_plane.py:455-457)

    # --- dtype ---------------------------------------------------------------
    # image compute dtype ("float32" or "bfloat16" for the filter front-end)
    image_dtype: str = "float32"

    # --- stage variants ------------------------------------------------------
    bridge_half_res: bool = True  # run the ENTIRE bridge (stats + endpoint
                                 # probes + oriented dilation) at label
                                 # (half) resolution with kernel reach and
                                 # probe halved: bridged masks only feed the
                                 # half-res labeling CC, so this quarters the
                                 # bridge's pixel count.
    bright_at_points: bool = True  # evaluate the center-seed and grid-origin
                                 # brightness statistics AT their few hundred
                                 # query points (ops/mxu_conv.conv_at_points:
                                 # per-point banded HIGHEST dots) instead of
                                 # filtering full images and dynamic-gathering
                                 # from them (chosen for the first target
                                 # accelerator, whose gathers were slow; not
                                 # measured on the GPU).  Same exact-mode
                                 # arithmetic up to f32 summation order.
    stage_probe: str = ""        # profiling only: truncate detect_grid after
                                 # the named stage (preprocess/centroids/roi/
                                 # seed/carve/bridge/labels/assign/polyfit/
                                 # newton) and return a scalar probe instead
                                 # of a DetectResult.  Static -> each value
                                 # compiles a prefix of the pipeline; stage
                                 # cost = diff of consecutive probe timings
                                 # (see utils/profiling.py).

    @property
    def mode(self) -> str:
        raise NotImplementedError

    @property
    def image_shape(self) -> Tuple[int, int]:
        return (self.height, self.width)


@dataclasses.dataclass(frozen=True)
class CylinderDetectConfig(DetectConfig):
    """Cylinder-surface grid detection (ref python_grid_detection_cylinder.py).

    Differences vs the plane path (SURVEY.md §2a): blob-based ROI with CLAHE
    clipLimit 4.5 (ref utils/util_cylinder.py:1830-1899), radius-adaptive
    bridge kernel 91+circle_radius (ref :2022-2023), poly degree 2, drop first
    row + last col (ref :1211-1269), point id = (col_idx, row_idx) (ref :1497),
    negative col labels dropped (ref :1657-1669).
    """

    poly_degree: int = 2
    bridge_kernel_base: int = 91     # kernel = 91 + circle_radius0 (ref :2022)
    bridge_min_len: float = 5.0      # contour size gates (ref :169)
    bridge_max_len: float = 200.0
    drop_first_row: bool = True      # remove_label (ref :1211-1269)
    drop_last_col: bool = True
    drop_negative_cols: bool = True  # remove_minus_labels (ref :1657-1669)
    id_row_major: bool = False       # id = (col_idx, row_idx) (ref :1497)
    # NOTE deliberate redesign: the reference's CLAHE(clipLimit 4.5, 4x4) +
    # SimpleBlobDetector ROI (ref :1830-1899) is replaced by the line-density
    # ROI in models/detector._roi_cylinder, so no CLAHE/blob constants exist
    # here.  Experiment-level adapthisteq equalization (ref preProcessing.m)
    # lives in ops/clahe.preprocess_stereo and is wired via the CLI/pipeline.

    @property
    def mode(self) -> str:
        return "cylinder"


@dataclasses.dataclass(frozen=True)
class PlaneDetectConfig(DetectConfig):
    """Planar calibration-target grid detection (ref python_grid_detection_plane.py).

    Differences: convex-hull ROI from binary threshold 127 with 5 px expansion
    (ref utils/util_plane.py:2590-2689), fixed bridge kernel 201
    (ref :2807-2808), poly degree 1 (ref :2820-2823), id = (row_idx, col_idx)
    (ref :1398,1420) -- the indexing asymmetry SURVEY.md §2a flags.
    """

    poly_degree: int = 1
    roi_threshold: float = 127.0     # ref get_convex_hull binary threshold
    roi_expand: int = 5              # hull dilation (ref python_grid_detection_plane.py:95)
    roi_blob_k: int = 128            # unlike the cylinder path (dilated blob
                                     # union, a handful of components), the
                                     # plane ROI labels the RAW threshold
                                     # mask, where every hot pixel/reflection
                                     # is its own component -- scan-order
                                     # slots must outnumber the specks that
                                     # can precede the grid blob or the
                                     # largest-component pick degrades to a
                                     # speck (counts-only enumeration, so 4x
                                     # the slots costs ~nothing at 1/4 res)
    bridge_kernel_base: int = 201    # fixed kernel (ref utils/util_plane.py:2807)
    bridge_min_len: float = 8.0      # ref utils/util_plane.py:140
    bridge_max_len: float = 700.0
    drop_first_row: bool = False
    drop_last_col: bool = False
    drop_negative_cols: bool = False
    id_row_major: bool = True        # id = (row_idx, col_idx)
    bridge_skip_long: bool = False   # plane path always expands
                                     # (ref utils/util_plane.py:78-137 diff)
    merge_short_cols: bool = True    # abnormal short-column merge is on the
                                     # plane main path (ref utils/util_plane.py:2828)

    @property
    def mode(self) -> str:
        return "plane"


@dataclasses.dataclass(frozen=True)
class FitConfig:
    """Stereo correspondence + cylinder fitting (ref utils/fitSingleCylinder.m)."""

    cyl_radius: float = 45.0        # ref exp_gridDetection.m:39
    patch_size: int = 3             # chooseIdx patch (ref fitSingleCylinder.m:12)
    error_threshold: float = 0.3    # mean patch reprojection error gate
    grid_extent: int = 24           # dense grid-index raster (static): must
                                    # cover the grid's index span per axis.
                                    # The detector caps labels at
                                    # max_rows/max_cols = 24, so 24 is exact;
                                    # bump for external grids with wider spans.
                                    # Raster cells feed the kNN/eigh/LM chain,
                                    # so capacity is quadratic in this.
    knn_k: int = 20                 # estCurvatures kNN (ref utils/estCurvatures.m:6)
    lm_iters: int = 20              # LM refinement steps (replaces fminsearch,
                                    # ref utils/fitCylinderWPts3.m:33-38).
                                    # Swept 60/40/30/20/12 on the 16-scene
                                    # bench: reprojection error is IDENTICAL
                                    # at 12 vs 40 (params move only along the
                                    # cylinder's axis-slide gauge there), BUT
                                    # the noise-free synthetic pose scene
                                    # (tests/test_pose_model.py) still moves
                                    # its AXIS between 12 and 20 iters
                                    # (3.0 deg -> <0.3 deg): reprojection
                                    # converges before direction does.  20 is
                                    # the floor for pose accuracy.
    lm_lambda0: float = 1e-3
    dtype: str = "float32"


@dataclasses.dataclass(frozen=True)
class KinematicsConfig:
    """Pan/tilt AGV->cylinder forward kinematics (ref utils/getTAGVcyl.m:8-38)."""

    l1: float = 321.1   # cylinder origin -> tilt joint
    l2: float = 143.1   # AGV origin -> tilt joint at tilt 0
    h: float = 110.0    # tilt joint -> cylinder origin height


@dataclasses.dataclass(frozen=True)
class RegistrationConfig:
    """Multi-frame camera<->AGV registration (ref utils/fitCylinderWPts3sAngs.m)."""

    cyl_radius: float = 45.0
    lm_iters: int = 80
    lm_lambda0: float = 1e-3
    kinematics: KinematicsConfig = dataclasses.field(default_factory=KinematicsConfig)
    # Frame-health gate for the multi-frame objective (models/pipeline.
    # frame_health): frames with fewer triangulated points or a worse mean
    # reprojection error are excluded from the registration residuals (the
    # reference lets such frames poison fminsearch, ref :82-94).
    min_frame_points: int = 8
    max_frame_reproj_px: float = 2.0
    # Observability gate for RegistrationResult.well_posed: minimum
    # eigenvalue of the 6-dof JtJ at the solution, per contributing frame,
    # with the rotation block non-dimensionalized by the scene's RMS point
    # radius so the value is invariant to units / robot scale / working
    # distance (round 4; verified identical at 1x and 2x full geometric
    # scale).  A narrow pan swing leaves t_cam_agv's along-axis translation
    # unobservable (a LOWER objective than ground truth exists -- PARITY.md
    # gauge-flatness diagnosis; the reference shares the failure mode,
    # ref utils/fitCylinderWPts3sAngs.m:71-94).  Measured: ~5.5e-3/frame for
    # a +-0.5 rad pan sweep, ~2.2e-4/frame at +-0.05 rad -- a 24x
    # separation this threshold sits inside.
    min_observability: float = 1.5e-3
