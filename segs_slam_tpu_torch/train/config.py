"""Optimization / mapper configuration.

A copy of segs_slam_tpu/train/config.py (the JAX module reaches JAX through
its schedules), field for field; the pose-optimisation fields are kept for
parity although the port's train step does not implement pose rows yet.

Mirrors the Optimization.* and the frequency-regularization Mapper.* keys of
the reference's gaussian-mapper YAMLs (reference:
cfg/gaussian_mapper/RGB-D/Replica/replica_rgbd.yaml, parsed by
src/gaussian_mapper.cpp:224-521; defaults in include/gaussian_parameters.h).
Values default to the Replica RGB-D config — the north-star benchmark.
"""

from __future__ import annotations

import dataclasses

from segs_slam_tpu_torch.train.schedules import ConstantLR, ExponLR


@dataclasses.dataclass(frozen=True)
class OptimizationConfig:
    iterations: int = 30_000

    # anchor position lr (zero for the live SLAM configs)
    position_lr_init: float = 0.0
    position_lr_final: float = 0.0
    position_lr_delay_mult: float = 0.01
    position_lr_max_steps: int = 30_000

    offset_lr_init: float = 0.07
    offset_lr_final: float = 0.0001
    offset_lr_delay_mult: float = 0.01
    offset_lr_max_steps: int = 30_000

    feature_lr: float = 0.0010
    opacity_lr: float = 0.02
    scaling_lr: float = 0.005
    rotation_lr: float = 0.001

    mlp_opacity_lr_init: float = 0.002
    mlp_opacity_lr_final: float = 0.00002
    mlp_opacity_lr_delay_mult: float = 0.01
    mlp_opacity_lr_max_steps: int = 30_000

    mlp_cov_lr_init: float = 0.004
    mlp_cov_lr_final: float = 0.004
    mlp_cov_lr_delay_mult: float = 0.01
    mlp_cov_lr_max_steps: int = 30_000

    mlp_color_lr_init: float = 0.008
    mlp_color_lr_final: float = 0.00005
    mlp_color_lr_delay_mult: float = 0.01
    mlp_color_lr_max_steps: int = 30_000

    mlp_featurebank_lr_init: float = 0.01
    mlp_featurebank_lr_final: float = 0.00001
    mlp_featurebank_lr_delay_mult: float = 0.01
    mlp_featurebank_lr_max_steps: int = 30_000

    appearance_lr_init: float = 0.05
    appearance_lr_final: float = 0.0005
    appearance_lr_delay_mult: float = 0.01
    appearance_lr_max_steps: int = 30_000

    percent_dense: float = 0.01
    lambda_dssim: float = 0.2

    # densification window (reference: trainForOneIteration
    # src/gaussian_mapper.cpp:961-972)
    start_stat: int = 500
    update_from: int = 1500
    update_interval: int = 100
    update_until: int = 25_500
    min_opacity: float = 0.005
    success_threshold: float = 0.8
    densify_grad_threshold: float = 0.0002

    # frequency regularization (reference: src/gaussian_mapper.cpp:930-945)
    use_frequency_regularization: bool = True
    use_multi_resolution: bool = True
    scale_num: int = 3
    frequency_regulization_until: int = 25_500
    high_frequency_regularization_start: int = 5_000
    lambda_frequency_high: float = 0.01
    lambda_frequency_low: float = 0.0

    spatial_lr_scale: float = 1.0  # cameras_extent (getNerfppNorm radius)

    # in-step photometric pose optimization (beyond reference: per-keyframe
    # SE3 tangent deltas trained jointly with the map, train/step.py).
    # Tangent units mix radians and meters; lr is NOT scaled by
    # spatial_lr_scale — pose errors are sensor-scale, not scene-scale.
    pose_lr_init: float = 1e-3
    pose_lr_final: float = 1e-5
    pose_lr_delay_mult: float = 0.01
    pose_lr_max_steps: int = 30_000
    # L2 prior anchoring each delta to its SLAM base pose. Without it the
    # deltas random-walk: Adam's scale-free steps move a pose ~lr per visit
    # even when the photometric gradient is pure noise (measured |delta|
    # drift 0.045 over 300 iterations at ground-truth poses). The prior's
    # pull (2*lambda*|d|) caps noise-driven drift at |d| ~ noise/(2*lambda)
    # while a real pose error's photometric gradient overwhelms it.
    pose_prior: float = 0.02
    # "base": the prior anchors each delta to zero (the SLAM base pose) —
    # damps noise-driven drift but also biases the equilibrium toward the
    # base when the photometric gradient vanishes near the optimum.
    # "ema": anchors the delta to a stop-gradient EMA of its own trajectory
    # (Ornstein-Uhlenbeck damping) — same random-walk suppression with no
    # pull toward the (possibly wrong) SLAM pose, so the photometric optimum
    # is reached unbiased.
    pose_prior_mode: str = "base"
    pose_ema_decay: float = 0.95
    # Optimizer family for the pose group (the map always uses Adam):
    # "adam":   scale-free steps — moves a pose ~lr per visit even when the
    #           photometric gradient is pure noise at the optimum (the
    #           measured 2.7 dB random-walk damage, RESULTS.md).
    # "sgd":    bias-corrected momentum, step proportional to the gradient —
    #           vanishes at the optimum; lr is in (loss-gradient) units, so
    #           pose_lr_* needs retuning (sweep: scripts).
    # "amsmax": Adam whose second moment is a non-decaying running max of
    #           g^2 — early steps are Adam-conditioned (unit-free lr), but
    #           once the max is set, steps scale with |g| and shrink to
    #           zero as the photometric gradient does. Keeps the Adam lr
    #           semantics while killing the stationary random walk.
    pose_opt_mode: str = "adam"
    # First iteration at which the pose deltas may move (0 = immediately).
    # The round-3 ablation localized the joint-opt damage to the EARLY
    # transient (map still converging; its error gradients drag the deltas),
    # not the stationary random walk — late-starting the deltas sidesteps it.
    pose_opt_start: int = 0
    # Optional sensor-depth supervision (beyond reference; 0 = off): L1 on
    # alpha-normalized rendered depth vs the keyframe's sensor depth over
    # confident (opacity > 0.5), valid-sensor pixels, in relative-depth
    # units. Pulls geometry onto the measured surface — counteracts the
    # photometric blur that pose inconsistency across co-visible keyframes
    # otherwise trains into the map.
    lambda_depth: float = 0.0

    def lr_schedules(self) -> dict:
        """Schedules per param-tree path prefix; mirrors updateLearningRate
        (src/gaussian_model.cpp:874-998): anchor/offset/mlp_* are scheduled,
        feat/opacity/scaling/rotation are constants set via the mapper's
        setters each iteration."""
        s = self.spatial_lr_scale
        return {
            "anchor": ExponLR(self.position_lr_init * s, self.position_lr_final * s,
                              0, self.position_lr_delay_mult, self.position_lr_max_steps),
            "offset": ExponLR(self.offset_lr_init * s, self.offset_lr_final * s,
                              0, self.offset_lr_delay_mult, self.offset_lr_max_steps),
            "feat": ConstantLR(self.feature_lr),
            "opacity": ConstantLR(self.opacity_lr),
            "scaling": ConstantLR(self.scaling_lr),
            "rotation": ConstantLR(self.rotation_lr),
            "mlp_opacity": ExponLR(self.mlp_opacity_lr_init, self.mlp_opacity_lr_final,
                                   0, self.mlp_opacity_lr_delay_mult,
                                   self.mlp_opacity_lr_max_steps),
            "mlp_cov": ExponLR(self.mlp_cov_lr_init, self.mlp_cov_lr_final,
                               0, self.mlp_cov_lr_delay_mult, self.mlp_cov_lr_max_steps),
            "mlp_color": ExponLR(self.mlp_color_lr_init, self.mlp_color_lr_final,
                                 0, self.mlp_color_lr_delay_mult,
                                 self.mlp_color_lr_max_steps),
            "mlp_featurebank": ExponLR(self.mlp_featurebank_lr_init,
                                       self.mlp_featurebank_lr_final, 0,
                                       self.mlp_featurebank_lr_delay_mult,
                                       self.mlp_featurebank_lr_max_steps),
            "appearance": ExponLR(self.appearance_lr_init, self.appearance_lr_final,
                                  0, self.appearance_lr_delay_mult,
                                  self.appearance_lr_max_steps),
            "pose": ExponLR(self.pose_lr_init, self.pose_lr_final, 0,
                            self.pose_lr_delay_mult, self.pose_lr_max_steps),
        }
