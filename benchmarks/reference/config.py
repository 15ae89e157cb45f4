"""Frozen configuration for the whole pipeline (SURVEY.md C17).

Every numeric constant that the reference hard-codes in C++ lives here; the
dataclass is hashable so it can be closed over by jitted step functions (one
XLA compile per config).  These constants are the accuracy-critical tuning
surface: curvature thresholds, per-sector feature budgets, voxel sizes,
iteration caps, robust-loss scales.

Frozen copy of the program's ``velo_tpu_torch/config.py`` (its
dataclasses) for the benchmark's reference.  The benchmark builds it from
a configuration file that spells out every field, so its defaults decide
nothing.  The measurements quoted in the comments were taken on the JAX
package.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass


@dataclass(frozen=True)
class LidarConfig:
    """Velodyne front-end (HDL-64E geometry by default)."""

    n_rings: int = 64
    n_azimuth: int = 2048  # range-image width (azimuth bins per ring)
    elev_max_deg: float = 2.0  # top laser elevation
    elev_min_deg: float = -24.8  # bottom laser elevation
    ring_mode: str = "linear"  # "linear": ring from uniform elevation
    # interpolation (synthetic scanner). "hdl64e": nearest beam in the
    # nominal HDL-64E two-block table (upper 32 lasers ~1/3 deg apart,
    # lower 32 ~1/2 deg apart) — use for real KITTI .bin scans, where
    # uniform interpolation misassigns lower-block rings.
    az_start: float = 0.0  # sweep-start azimuth (rad).  The synthetic
    # scanner starts at +x (0); real KITTI sweeps start near the rear (~pi).
    min_range: float = 2.5  # drop self-returns closer than this (m)
    max_range: float = 80.0
    # Curvature / feature selection (LOAM-style)
    curvature_halfwin: int = 5  # +/- neighbors in the ring for curvature
    n_sectors: int = 8  # azimuth sectors for even feature spread
    edges_per_sector: int = 2  # per ring-sector edge budget
    planars_per_sector: int = 4  # per ring-sector planar budget
    edge_min_curv: float = 0.5  # spacing-normalized curvature gate for edges
    planar_max_curv: float = 0.1  # gate for planar points
    occlusion_range_jump: float = 0.30  # relative range jump => occluded edge
    parallel_beam_tan: float = 5.7  # tan(max surface incidence) ~ 80 deg
    target_mult: int = 3  # density multiplier of the match-target feature set

    @property
    def k_edge(self) -> int:
        return self.n_rings * self.n_sectors * self.edges_per_sector

    @property
    def k_planar(self) -> int:
        return self.n_rings * self.n_sectors * self.planars_per_sector


@dataclass(frozen=True)
class VisionConfig:
    """Visual front-end: Shi-Tomasi corners + pyramidal KLT (C6/C7/C8)."""

    height: int = 192
    width: int = 640
    k_tracks: int = 256  # fixed track-table capacity
    grid_rows: int = 8  # corner bucketing grid
    grid_cols: int = 32
    pyr_levels: int = 4
    klt_halfwin: int = 7  # (2*7+1)^2 = 15x15 patch
    klt_iters: int = 8  # GN iterations per pyramid level
    klt_iters_fb: int = 4  # GN iterations per level of the BACKWARD
    # (consistency-check) pass.  The backward track only needs to land
    # within fb_max_err (1 px) of the start to certify a match — half the
    # iterations of the forward pass (which must converge to sub-pixel)
    # keeps the gate's discrimination at ~half its cost (A/B'd on the
    # 150-frame fused fixtures: drift unchanged vs fb-iters=8)
    klt_impl: str = "auto"  # patch sampling: "auto" (global selection
    # matmuls on TPU, gather elsewhere) | "pallas" (fused level-0 kernel —
    # per-track VMEM blocks, in-kernel Scharr, roll-based VPU bilinear;
    # coarse levels stay on the matmul path) | "window" | "matmul" |
    # "gather" — forced values are for testing/sweeps
    klt_dtype: str = "bf16"  # matmul-path operand dtype: "bf16" (1-pass
    # MXU; quantization ~4e-3 intensity, far below tracking noise) | "f32"
    klt_win_slack: int = 8  # window-impl per-level flow budget (px): the
    # GN iterations can move at most this far from the level's initial
    # guess before the track freezes at the window edge
    fb_max_err: float = 1.0  # forward-backward consistency gate (px)
    max_track_residual: float = 1e9  # mean |patch residual| appearance gate
    # (cv2's `err` analog; intensity units on [0,1] images, ~0.05-0.1
    # typical).  >=1e8 disables the gate and its two extra patch samples.
    fb_levels: int = 2  # pyramid levels of the backward FB pass (finest-n,
    # initialized at the expected position; >= pyr_levels for the classic
    # full uninitialized backward track).  fb_levels=1 admitted locally-
    # self-similar wrong matches whose depth residuals dragged the solve
    # (round-3 full-scale A/B: fused drift 0.74 -> 1.60 %/100m); 2 levels
    # restore the discrimination — round-4 full-scale 5-seed A/B on the
    # seam-fixed pipeline measured fused planar 0.987 %/100m at fb_levels=2
    # vs 1.129 at fb_levels=4, and 103.7 vs 100.7 fused fps.
    min_corner_response: float = 1e-4
    depth_grid_cell: int = 4  # pixel bucket size for LiDAR depth association
    depth_search_cells: int = 1  # bucket search radius: (2s+1)^2 neighborhood
    # (raise to 2-3 for sparse-ring LiDAR where projected rows are far apart)
    max_depth_spread: float = 1.0  # reject depth interp across discontinuity (m)
    # Grazing-plane gates (held-out suburban world exposed these: open
    # scenes put mostly GROUND under the tracked features, and a near-
    # grazing interpolation plane amplifies pixel noise into meters of
    # depth error — measured 18 %/100m fused vs 0.4 novis before gating).
    min_plane_incidence: float = 0.05  # |cos| between ray and plane normal
    # (~3 deg).  Only the most extreme grazing fails: a grazing SMOOTH
    # plane is safe once the coplanarity gate below has excluded occlusion
    # edges (corridor walls ahead are grazing-but-exact and carry the
    # whole forward-recovery signal — 0.17 here broke that recovery).
    max_depth_grad: float = 1.0  # m of interpolated depth per px of track
    # error, |dt/duv| — the t-scaled version of the grazing test: corridor
    # walls 30 m out are ~0.6 m/px (keep), horizon ground at 26 m is
    # ~1.4 m/px (reject).
    depth_range_slack: float = 0.5  # m; ray-plane intersection must land
    # within the 3-NN depth span (+slack) — outside it is extrapolation
    # across geometry the neighbors do not support (fence->ground, step).
    max_plane_outlier: float = 1.0  # m; ALL valid neighborhood points must
    # lie near the 3-NN plane.  Distinguishes a receding planar surface
    # (large depth spread but coplanar -> keep) from an occlusion edge
    # (foreground fence + background ground are not coplanar -> reject).
    # Corners love occlusion edges, and a fence-top association measured
    # 12 m of depth error while passing every spread/incidence gate.
    # 1.0 m keeps pole/crate-edge corners (whose foreground depth is a
    # correct physical point — 0.4 here cost the canyon ~0.8 %/100m)
    # while still rejecting the multi-meter fence->ground T-junctions.


@dataclass(frozen=True)
class SolverConfig:
    """Correspondence + joint LM solve (C9/C10/C12)."""

    nn_engine: str = "dense"  # "dense" (MXU matmul top-k) | "hash" (C9 grid)
    nn_approx_impl: str = "pallas"  # "pallas" (fused dist+topk) | "xla"
    reuse_candidates: bool = True  # share the per-frame candidate cache
    # between the pre- and post-redeskew scan-to-scan solves
    voxel_size: float = 1.0  # correspondence voxel-hash cell (m)
    hash_capacity: int = 8192  # voxel table slots (power of two)
    voxel_occupancy: int = 8  # max points stored per voxel
    corr_max_dist: float = 1.0  # gate NN correspondences beyond this (m)
    map_knn: int = 5  # neighbors for map line/plane eigen-fit
    icp_iters_odom: int = 5  # outer re-search iterations, scan-to-scan
    icp_iters_redeskew: int = 1  # outer iterations of the post-redeskew
    # re-solve (starts from the converged pose; needs fewer re-searches —
    # (5,1,3) beat (6,3,4) on both drift and runtime in the seed sweep)
    icp_iters_map: int = 3  # outer re-search iterations, scan-to-map
    lm_iters: int = 4  # inner LM iterations per re-search
    lm_lambda_init: float = 1e-4
    lm_lambda_up: float = 10.0
    lm_lambda_down: float = 0.1
    huber_delta_icp: float = 0.10  # meters
    huber_delta_repr: float = 1.5  # pixels
    icp_loss: str = "huber"  # robust loss of the geometric ICP residuals:
    # "huber" | "cauchy" (redescending — hard-rejects gross outliers, but
    # see _vis_prior_terms6 for why the VISUAL terms must stay Huber)
    vis_weight: float = 0.1  # relative weight of reprojection residuals
    # Reprojection trust ramp on the depth-track count: below lo the
    # consensus pre-gate has no statistics (the median IS the outlier) and
    # one bad landmark owns the weakly-observed DoF, so the block is
    # silenced; full weight from hi up.  Epipolar terms are unaffected
    # (depth-free).  Canyon/corridor scenes run far above hi.
    vis_depth_lo: int = 4
    vis_depth_hi: int = 12
    # Inverse-variance landmark weighting: w = 1/(1+(|dt/duv|/g0)^2).  At
    # g0=0.6 m/px a frontal surface (~0 m/px) keeps full weight, corridor
    # walls 30 m out (~0.6 m/px) keep 50 % — they carry the corridor
    # forward recovery, which broke at g0=0.3 — and landmarks near the
    # 1.0 m/px hard gate keep ~25 %.
    vis_grad_soft: float = 0.6
    vis_pregate_px: float = 6.0  # cull depth landmarks whose reprojection at
    # the predicted pose is already off by this many pixels (wrong depth)
    epi_weight: float = 0.01  # weight of depth-unknown epipolar residuals
    # (pixel-scale residuals with ~fx px/rad leverage: keep small so hundreds
    # of tracks refine rotation without overpowering the LiDAR blocks)
    converge_tol: float = 1e-4  # pose-delta convergence mask threshold
    # Constant-velocity motion prior in the joint cost: r = log(T T_pred^-1)
    # with these diagonal weights.  Sized so healthy frames (hundreds of
    # well-conditioned correspondences, H_rot ~ 1e4-1e5) barely feel it while
    # correspondence-starved frames get pulled to the prediction instead of
    # latching a 2-6 deg rotation error (the dominant long-run drift source).
    prior_weight_trans: float = 50.0  # 1/sigma^2, sigma ~ 0.14 m/frame^2
    prior_weight_rot: float = 5000.0  # 1/sigma^2, sigma ~ 0.014 rad/frame^2
    # Dead zone: deviations within normal vehicle dynamics cost nothing (a
    # quadratic prior drags against genuine turns); only the excess beyond
    # is penalized.
    prior_deadzone_trans: float = 0.2  # m/frame^2
    prior_deadzone_rot: float = 0.015  # rad/frame^2 (~0.86 deg)
    # Per-DoF observability-scaled prior: rotate the prior into the
    # eigenbasis of the geometric Hessian's trans/rot 3x3 blocks and, along
    # directions the current correspondences barely constrain (eigenvalue
    # below prior_obs_ref x the block's strongest), boost the prior weight
    # by up to (1 + prior_obs_gain) and shrink the dead zone toward
    # prior_obs_dz_floor x its base width.  Rationale: open-stretch failure
    # episodes show a consistent body-frame bias in exactly the weak
    # directions (healthy feature counts, wrong constraint directionality);
    # a deviation-from-prediction prior low-passes that bias — per frame the
    # solve moves only ~W_L/(W_L+W_P) of the way toward the biased answer —
    # while fully-observed directions keep their tuned behavior.  gain=0
    # disables (zero-cost static branch).
    prior_obs_gain: float = 4.0  # round-4 full-scale 5-seed A/Bs (seam-
    # fixed pipeline): planar LiDAR 0.885 vs 1.119 %/100m, 6-DoF 2.416 vs
    # 2.999, fused planar 1.007 vs 1.129, suburban neutral (0.651 both) —
    # wins or ties every family, and mean rotation drift improves too
    # (planar 1.29 vs 1.96 deg/100m).  Set 0.0 to disable (static branch).
    prior_obs_ref: float = 0.05
    prior_obs_dz_floor: float = 0.25
    # LM iterations that RE-DERIVE the observability eigenbasis at their own
    # linearization point before it freezes for the rest of the solve.  The
    # basis must track the early LM steps (round-5 A/B on bit-identical
    # fixtures: freezing from iteration 0 regressed fused planar 0.73 ->
    # 1.52 %/100m, i.e. the prediction-pose Hessian misjudges weak
    # directions until data corrects the pose).  Default >= lm_iters =
    # refresh every iteration (the dynamic-equivalent build schedule): with
    # the first-linearization reuse + batched closed-form eig the full
    # refresh costs only ~1 fused fps vs stage_iters=2 (measured 103.6 vs
    # 104.7) while fused planar drift improves 1.08 -> 0.89 %/100m
    # (5-seed means, bit-identical fixtures).
    prior_obs_stage_iters: int = 4
    # HOW the obs-scaled prior rides the LM loop:
    #   "staged"   — per-iteration basis refresh on the build side, but each
    #                iteration's trial-cost probe scores the prior in the
    #                basis FROZEN at its linearization point, so trial costs
    #                carry no Hessian dependence and XLA dead-code-eliminates
    #                their J^T W J einsums (solve cost: lm_iters H-builds).
    #   "deferred" — exact dynamic cost everywhere: every LM evaluation is a
    #                full linearization of the true dynamic-basis cost, and
    #                the accept/reject decision reuses the cost that the next
    #                step's linearization computes anyway (deferred-reject
    #                LM: solve-then-evaluate, lm_iters+1 H-builds — vs the
    #                round-4 dynamic loop's 2*lm_iters+1, which cost 31-38 %
    #                of end-to-end throughput).  Accept decisions are
    #                identical to the round-4 dynamic formulation.
    #   "deferred_tail" — deferred for the first lm_iters-1 steps, staged
    #                for the LAST accept only: a final build's H/g are
    #                discarded, but the dynamic prior cost keeps the Hessian
    #                einsums live just to derive its basis — freezing that
    #                one decision lets XLA dead-code-eliminate the whole
    #                final build (lm_iters H-builds, the staged cost, with
    #                only 1 of lm_iters accepts approximated).
    # Round-5 decision (10 full-scale seeds, BUILD_NOTES "10-seed
    # decision"): the seed-0-4 draw (deferred fused 0.888 vs staged 1.478
    # %/100m) REVERSED on fresh seeds 5-9 (2.350 vs 1.092) — 10-seed means
    # favor staged on both planar families (fused 1.285 vs 1.619, LiDAR
    # 1.385 vs 1.584), i.e. the impls are statistically tied within the
    # per-seed chaos band.  Staged stays default; deferred/deferred_tail
    # are the documented opt-in throughput levers (fused 111.6 vs ~103.6
    # fps, LiDAR 150.8 vs 139.6) for fps-bound deployments.
    prior_obs_impl: str = "staged"
    # Continuous-time sweep solve (12 DoF): jointly estimate the current
    # scan's own sweep motion instead of assuming the constant-velocity
    # prediction — removes the O(acceleration) residual-distortion error
    # that dominates rotation noise on turning trajectories.
    ct_sweep: bool = False
    # One-frame-lag EXACT deskew: scan i's sweep spans frames i -> i+1, so
    # its true sweep motion is the delta solved at frame i+1 — not the
    # constant-velocity guess available at frame i.  With this on, the
    # stored s2s targets are re-corrected with the currently-solved delta
    # (their exact motion) before the redeskew re-solve, and map inserts
    # are delayed one frame so they use the exact motion too.  Identity
    # under constant velocity.
    # Default OFF: a 3-seed CI-scale A/B measured a clear PLANAR regression
    # (mean 2.40 vs 1.48 %/100m) — under white yaw wiggle the "exact"
    # correction is dominated by solver noise, and matched-distortion
    # source/target pairs beat exact-but-one-sided correction.  On 6-DoF
    # excitation it won translation on all three seeds (1.82 vs 2.51);
    # re-evaluate on real KITTI where jerk is structured, via
    # s:deskew_exact_lag=1.
    deskew_exact_lag: bool = False
    # Sub-knob: also re-correct the s2s *targets* (and cached candidate
    # coordinates) with the in-flight solved delta.  Map inserts always
    # benefit from exact motion (multi-frame aggregate, errors don't
    # cancel); target re-correction is more delicate — the *source* scan
    # still carries CV-prediction distortion, and making only one side
    # exact can unbalance the matching when jerk is high (measured: 6-DoF
    # seed 0 rotation 2.3→3.9 deg/100m) while helping translation.
    exact_lag_targets: bool = True
    couple_weight_trans: float = 400.0  # xi2 ~ log(T) coupling, 1/sigma^2
    couple_weight_rot: float = 20000.0  # sigma ~ 7e-3 rad (accel scale)
    # Plausibility gates (failure containment, SURVEY.md §5): a solve whose
    # result deviates from the constant-velocity prediction by more than
    # physics allows between 10 Hz frames is rejected in favor of the prior,
    # so one bad frame cannot poison the map/velocity and cascade.
    max_accel_trans: float = 0.6  # m/frame^2 deviation from predicted motion
    max_accel_rot: float = 0.06  # rad/frame^2
    max_map_corr_trans: float = 1.2  # scan-to-map may move the pose this far
    max_map_corr_rot: float = 0.12  # rad
    degen_rel_min: float = 0.0  # per-block relative H-eigenvalue gate:
    # directions weaker than this fraction of the block's strongest keep the
    # motion prior (corridor degeneracy remap). Default off — it measurably
    # hurt clean-data runs; enable ~0.01 for corridor-heavy environments.


@dataclass(frozen=True)
class MapConfig:
    """Local map ring buffer + voxel downsample (C11)."""

    edge_capacity: int = 16384
    planar_capacity: int = 32768
    voxel_edge: float = 0.2  # map downsample voxel for edge features
    voxel_planar: float = 0.4
    crop_radius: float = 80.0  # drop map points farther than this from pose
    map_every: int = 1  # run scan-to-map refinement every k frames
    maintain_every: int = 2  # voxel-dedup/crop cadence: the ring buffer
    # bounds memory by construction, so density maintenance can run on a
    # cadence (the sort-based dedup costs ~0.4 ms/frame at full scale)


@dataclass(frozen=True)
class VeloConfig:
    """Top-level pipeline config; hashable => usable as a static jit arg."""

    lidar: LidarConfig = dataclasses.field(default_factory=LidarConfig)
    vision: VisionConfig = dataclasses.field(default_factory=VisionConfig)
    solver: SolverConfig = dataclasses.field(default_factory=SolverConfig)
    map: MapConfig = dataclasses.field(default_factory=MapConfig)
    n_max_points: int = 131072  # padded raw scan capacity
    use_vision: bool = True  # config 4 (fused) vs configs 1-2 (LiDAR-only)
    use_map: bool = True  # scan-to-map refinement on/off
    use_deskew: bool = True
    prebin_host: bool = False  # feed host-pre-binned (R, W, 5) grids
    # instead of raw (N, 4) scans: the loader bins during async prefetch
    # (rangeimage.bin_scan_host / the native veloio loader), removing the
    # device scatter-min + winner gather (~1.6 ms/frame, the two largest
    # LiDAR ops in the device trace)
