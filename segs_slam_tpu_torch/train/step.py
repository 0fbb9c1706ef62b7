"""The training step: render -> loss -> backward -> stats -> Adam.

Port of segs_slam_tpu/train/step.py, GaussianMapper::trainForOneIteration's
device work (reference: src/gaussian_mapper.cpp:823-1031) minus the
densify trigger (densify.py, called by the trainer every update_interval
iterations). The step counter lives on the host, so the JAX version's
lax.cond windows are Python branches, and the step syncs nothing: its
metrics stay on the device until a caller reads them.

In-step pose optimisation: the state may carry per-keyframe SE3 tangent
deltas (pose rows); a step given a keyframe's row renders at its pose
composed with exp(delta) (`apply_pose_delta`) and trains that row with the
map, under its own optimiser family (OptimizationConfig.pose_opt_mode),
prior and start gate.

Data parallel (parallel/dp.py): with a `group`, the step is one rank's
share of a step over several keyframes, one a rank, with the state
replicated; the reductions sit where the JAX version's `axis_name`
collectives sit and do the same: gradients averaged, the non-finite count,
the densify statistics and the pose-row mask summed, the loss metrics
averaged and the capacity counters maxed.
"""

from __future__ import annotations

import dataclasses

import torch

from segs_slam_tpu_torch.models.anchors import AnchorState
from segs_slam_tpu_torch.models.config import ModelConfig
from segs_slam_tpu_torch.models.decoders import Decoders
from segs_slam_tpu_torch.models.renderer import render
from segs_slam_tpu_torch.ops.rasterizer import RasterConfig
from segs_slam_tpu_torch.train import losses, optimizer
from segs_slam_tpu_torch.train.config import OptimizationConfig
from segs_slam_tpu_torch.utils import tracing


@dataclasses.dataclass
class DensifyStats:
    """Densification statistics (reference: include/gaussian_model.h
    opacity_accum / anchor_demon / offset_gradient_accum / offset_denom,
    updated by training_statis, src/gaussian_model.cpp:1459-1503)."""

    opacity_accum: torch.Tensor  # (cap,)
    anchor_demon: torch.Tensor  # (cap,)
    offset_grad_accum: torch.Tensor  # (cap, K)
    offset_denom: torch.Tensor  # (cap, K)

    @staticmethod
    def zeros(cap: int, k: int, device=None) -> "DensifyStats":
        z = lambda *s: torch.zeros(s, dtype=torch.float32,  # noqa: E731
                                   device=device)
        return DensifyStats(z(cap), z(cap), z(cap, k), z(cap, k))


@dataclasses.dataclass
class TrainState:
    """The map, its decoders, the pose rows, their Adam moments, the
    densify statistics and the host-side step count. The step function and
    densification update it in place."""

    anchors: AnchorState
    decoders: Decoders
    adam: optimizer.AdamState
    stats: DensifyStats
    step: int
    # per-keyframe SE3 tangent deltas (omega, upsilon), rows assigned by the
    # trainer; zero rows are the identity. (max_kfs, 6); (0, 6) when pose
    # optimisation is off
    pose: torch.Tensor = None
    # the no-gradient EMA of each row: the prior's anchor under
    # pose_prior_mode "ema". Same shape as pose
    pose_ema: torch.Tensor = None

    @property
    def pose_rows(self) -> int:
        return self.pose.shape[0]


def train_params(anchors: AnchorState, decoders: Decoders,
                 pose: torch.Tensor) -> dict:
    """The optimised tensors as the JAX version's params tree: anchors by
    field, decoders by parameter name (e.g. "color.l2.weight"), the pose
    rows."""
    return {"anchors": anchors.params(),
            "decoders": dict(decoders.named_parameters()), "pose": pose}


def init_train_state(anchors: AnchorState, decoders: Decoders,
                     config: ModelConfig, max_pose_kfs: int = 0) -> TrainState:
    pose = torch.zeros((max_pose_kfs, 6), dtype=torch.float32,
                       device=anchors.anchor.device)
    return TrainState(
        anchors=anchors,
        decoders=decoders,
        adam=optimizer.init(train_params(anchors, decoders, pose)),
        stats=DensifyStats.zeros(config.capacity, config.n_offsets,
                                 anchors.anchor.device),
        step=0,
        pose=pose,
        pose_ema=pose.clone(),
    )


def so3_exp(w: torch.Tensor) -> torch.Tensor:
    """exp of the rotation vector w (3,), differentiable at w = 0: the norm
    is sqrt(|w|^2 + 1e-16), since a plain norm has a NaN gradient there."""
    th = torch.sqrt((w * w).sum() + 1e-16)
    z = torch.zeros((), dtype=w.dtype, device=w.device)
    K = torch.stack([torch.stack([z, -w[2], w[1]]),
                     torch.stack([w[2], z, -w[0]]),
                     torch.stack([-w[1], w[0], z])])
    eye = torch.eye(3, dtype=w.dtype, device=w.device)
    return (eye + torch.sin(th) / th * K
            + (1 - torch.cos(th)) / th**2 * (K @ K))


def delta_world_view(wvt0: torch.Tensor, delta: torch.Tensor):
    """Left-multiply exp(delta), delta = (omega, upsilon), onto the W2C
    transform whose transpose is wvt0: (new world_view_transform, the
    rotation Rn, the translation tn)."""
    R = so3_exp(delta[:3])
    w2c0 = wvt0.T
    rn = R @ w2c0[:3, :3]
    tn = R @ w2c0[:3, 3] + delta[3:]
    top = torch.cat([rn, tn[:, None]], dim=1)
    last = torch.tensor([[0.0, 0.0, 0.0, 1.0]], dtype=top.dtype,
                        device=top.device)
    return torch.cat([top, last]).T, rn, tn


def apply_pose_delta(cam: dict, delta: torch.Tensor) -> dict:
    """The camera with exp(delta) left-multiplied onto its world-to-view
    transform (delta = (omega[3], upsilon[3]) in the SE3 tangent at the
    current pose). The appearance input `pose7` stays at the base pose, so
    that pose gradients flow through the geometry, not through the
    appearance MLP's colour modulation."""
    wvt, rn, tn = delta_world_view(cam["world_view_transform"], delta)
    out = dict(cam)
    out["world_view_transform"] = wvt
    out["full_proj_transform"] = wvt @ cam["projection_matrix"]
    out["camera_center"] = -rn.T @ tn
    return out


_DECODER_GROUP = {
    "opacity": "mlp_opacity",
    "cov": "mlp_cov",
    "color": "mlp_color",
    "appearance": "appearance",
    "embedding": "appearance",
    "feat_bank": "mlp_featurebank",
}


def _sanitise(g: torch.Tensor) -> torch.Tensor:
    return torch.where(torch.isfinite(g), g, 0.0)


def step_loss(out, gt_image: torch.Tensor, gt_depth, it: int,
              opt_config: OptimizationConfig):
    """The train step's loss for render output `out` at iteration `it`:
    (loss, l1, ssim, masked image, masked gt). L1 + D-SSIM on the pixels
    where the gt is not black, the scaling regulariser, the optional
    sensor-depth term and the frequency terms inside their windows."""
    oc = opt_config
    img = out.image
    # mask of non-black gt pixels (src/gaussian_mapper.cpp:917-922)
    mask_rgb = (gt_image != 0.0).any(dim=0, keepdim=True).float()
    img_m = img * mask_rgb
    gt_m = gt_image * mask_rgb

    l1 = losses.l1_loss(img_m, gt_m)
    ssim_v = losses.ssim(img_m, gt_m)
    # scaling regulariser over the rendered gaussians
    valid_f = out.neural.valid.float()
    prod = torch.prod(out.neural.scaling, dim=-1)
    scaling_reg = (prod * valid_f).sum() / torch.clamp(valid_f.sum(), min=1.0)
    lam = oc.lambda_dssim
    loss = (1.0 - lam) * l1 + lam * (1.0 - ssim_v) + 0.01 * scaling_reg
    if oc.lambda_depth > 0.0 and gt_depth is not None:
        # alpha-normalised expected depth against sensor depth over
        # confident, valid pixels, in relative-depth units
        opac_img = 1.0 - out.final_T
        dr = out.depth_map / torch.maximum(
            opac_img, torch.tensor(1e-6, device=opac_img.device))
        dm = ((gt_depth > 0.0) & (opac_img > 0.5)).float()
        dl1 = ((dr - gt_depth).abs() / torch.clamp(gt_depth, min=0.1)
               * dm).sum() / torch.clamp(dm.sum(), min=1.0)
        loss = loss + oc.lambda_depth * dl1
    if oc.use_frequency_regularization:
        in_low = it < oc.frequency_regulization_until
        in_high = in_low and it > oc.high_frequency_regularization_start
        if oc.lambda_frequency_low != 0.0 and in_low:
            loss = loss + oc.lambda_frequency_low * losses.low_freq_loss(
                img_m, gt_m)
        if in_high:
            if oc.use_multi_resolution:
                scales = tuple(1.0 / 2**i for i in range(oc.scale_num))
                high = losses.multi_scale_loss(img_m, gt_m, scales)
            else:
                high = losses.high_frequency_loss(img_m, gt_m)
            loss = loss + oc.lambda_frequency_high * high
    return loss, l1, ssim_v, img_m, gt_m


def _all_reduce(tensors: list, op: str, group) -> list:
    """`tensors` reduced across `group` in one collective (op "sum", "mean"
    or "max"), as new tensors of their shapes and dtypes."""
    import torch.distributed as dist

    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, op=dist.ReduceOp.MAX if op == "max"
                    else dist.ReduceOp.SUM, group=group)
    if op == "mean":
        flat = flat / dist.get_world_size(group)
    return [x.view_as(t) for x, t in
            zip(flat.split([t.numel() for t in tensors]), tensors)]


def make_train_step(model_config: ModelConfig, opt_config: OptimizationConfig,
                    raster_config: RasterConfig, width: int, height: int,
                    group=None):
    """The train step for one image size: step_fn(ts, cam, gt_image, bg,
    kf_row=None, gt_depth=None) -> (ts, metrics), ts updated in place and
    metrics left on the device. With a torch.distributed `group` (the JAX
    version's `axis_name`), the step is this rank's body of a data-parallel
    step: every rank of the group must call it with the same state and the
    same `kf_row` presence (see the module docstring)."""
    cap, k = model_config.capacity, model_config.n_offsets
    oc = opt_config
    schedules = oc.lr_schedules()

    def lr_for(it):
        def lr_fn(path):
            if path[0] == "anchors":
                return schedules[path[1]](it)
            if path[0] == "pose":
                return schedules["pose"](it)
            return schedules[_DECODER_GROUP[path[1].split(".")[0]]](it)
        return lr_fn

    def step_fn(ts: TrainState, cam: dict, gt_image: torch.Tensor,
                bg: torch.Tensor, kf_row=None, gt_depth=None):
        it = ts.step + 1
        dev = ts.anchors.anchor.device
        anchor_leaves = {n: t.detach().requires_grad_()
                         for n, t in ts.anchors.params().items()}
        dec_params = dict(ts.decoders.named_parameters())
        pose_leaf = ts.pose.detach().requires_grad_()
        mean2d_zero = torch.zeros((cap * k, 2), dtype=torch.float32,
                                  device=dev, requires_grad=True)
        # pose optimisation engages when the state carries pose rows and
        # the caller names the keyframe's row
        opt_pose = ts.pose_rows > 0 and kf_row is not None
        # The spans name the step's layers in a torch.profiler trace
        # (chip_smoke.py and the benchmark read them); without a running
        # profiler they record nothing (utils/tracing.py).
        with torch.enable_grad():
            with tracing.span("train_step.forward"):
                cam_used = (apply_pose_delta(cam, pose_leaf[kf_row])
                            if opt_pose else cam)
                out = render(ts.anchors.replace_params(anchor_leaves),
                             ts.decoders, cam_used, width, height, bg,
                             model_config, raster_config,
                             mean2d_offset=mean2d_zero)
            with tracing.span("train_step.loss"):
                loss, l1, ssim_v, img_m, gt_m = step_loss(out, gt_image,
                                                          gt_depth, it, oc)
                if opt_pose:
                    # L2 prior damping the delta's random walk
                    # (OptimizationConfig.pose_prior / pose_prior_mode)
                    anchor_pt = (ts.pose_ema[kf_row].detach()
                                 if oc.pose_prior_mode == "ema" else 0.0)
                    loss = loss + oc.pose_prior * (
                        (pose_leaf[kf_row] - anchor_pt) ** 2).sum()
            wrt = [*anchor_leaves.values(), *dec_params.values(),
                   pose_leaf, mean2d_zero]
            with tracing.span("train_step.backward"):
                grads = torch.autograd.grad(loss, wrt, allow_unused=True)

        with torch.no_grad():
            with tracing.span("train_step.stats"):
                grads = [torch.zeros_like(x) if g is None else g
                         for x, g in zip(wrt, grads)]
                # Non-finite gradients would poison the Adam moments for
                # good: zero them and count them.
                nonfinite = sum((~torch.isfinite(g)).sum() for g in grads)
                grads = [_sanitise(g) for g in grads]
                if group is not None:
                    # sanitised on each rank first, so that one rank's NaN
                    # cannot poison the reduction; mean2d_grad stays this
                    # rank's: the densify statistics below are summed per
                    # keyframe
                    grads = _all_reduce(grads[:-1], "mean", group) \
                        + grads[-1:]
                    (nonfinite,) = _all_reduce([nonfinite], "sum", group)
                mean2d_grad = grads[-1]
                na = len(anchor_leaves)
                grad_tree = {"anchors": dict(zip(anchor_leaves, grads[:na])),
                             "decoders": dict(zip(dec_params, grads[na:-2])),
                             "pose": grads[-2]}

                n_active = ts.anchors.num_active()
                # densification statistics (training_statis,
                # src/gaussian_model.cpp:1459-1503) inside the stats window
                if oc.start_stat < it < oc.update_until:
                    st = ts.stats
                    visible = out.visible_anchor_mask
                    vis_f = visible.float()
                    neural_op = out.neural.neural_opacity.reshape(cap, k)
                    combined = (torch.repeat_interleave(visible, k)
                                & out.neural.offset_mask
                                & out.visibility_filter).reshape(cap,
                                                                 k).float()
                    # viewspace grad in the reference's NDC-ish units:
                    # dL/dpix * (W/2, H/2) (backward.cu ddelx_dx = 0.5 * W)
                    gscale = torch.tensor([0.5 * width, 0.5 * height],
                                          device=dev)
                    g2 = mean2d_grad * gscale
                    gnorm = torch.sqrt((g2 * g2).sum(dim=-1)).reshape(cap, k)
                    deltas = [vis_f * torch.clamp(neural_op,
                                                  min=0.0).sum(dim=1),
                              vis_f, combined * gnorm, combined]
                    if group is not None:
                        # one step over B keyframes gathers what B
                        # iterations of the reference would
                        # (training_statis)
                        deltas = _all_reduce(deltas, "sum", group)
                    st.opacity_accum += deltas[0]
                    st.anchor_demon += deltas[1]
                    st.offset_grad_accum += deltas[2]
                    st.offset_denom += deltas[3]

                active = ts.anchors.active
                # pose rows: only the rendered keyframe's row may move (zero
                # gradients elsewhere would still decay that row's moments
                # into drift), and none before pose_opt_start
                rows = torch.arange(ts.pose_rows, device=dev)
                pose_mask = rows == (kf_row if opt_pose else -1)
                if opt_pose and oc.pose_opt_start > 0 \
                        and it < oc.pose_opt_start:
                    pose_mask = torch.zeros_like(pose_mask)
                if opt_pose and group is not None:
                    # every rank's row moves: the gradients were averaged,
                    # so every rank applies the same update
                    (pose_mask,) = _all_reduce([pose_mask.float()], "sum",
                                               group)
                    pose_mask = pose_mask > 0
                masks = {"anchors": active, "pose": pose_mask}
            with tracing.span("train_step.adam"):
                optimizer.update(
                    train_params(ts.anchors, ts.decoders, ts.pose),
                    grad_tree, ts.adam, lr_for(it),
                    row_mask_fn=lambda p: masks.get(p[0]),
                    mode_fn=lambda p: oc.pose_opt_mode if p[0] == "pose"
                    else "adam")
                if opt_pose and oc.pose_prior_mode == "ema":
                    dec = oc.pose_ema_decay
                    ts.pose_ema.copy_(torch.where(
                        pose_mask[:, None],
                        dec * ts.pose_ema + (1.0 - dec) * ts.pose,
                        ts.pose_ema))
            with tracing.span("train_step.metrics"):
                ts.step = it
                metrics = {
                    "loss": loss.detach(),
                    "l1": l1.detach(),
                    "psnr": losses.psnr(img_m.detach(), gt_m),
                    "ssim": ssim_v.detach(),
                    "num_instances": out.num_instances,
                    "n_active": n_active,
                    "nonfinite_grads": nonfinite,
                    # visible gaussians beyond the static `compact` cap are
                    # dropped with their gradients; oversized footprints
                    # shrunk
                    "num_compact": out.num_compact,
                    "num_kmax_truncated": out.num_kmax_truncated,
                }
                if group is not None:
                    means = ("loss", "l1", "psnr", "ssim")
                    maxes = ("num_instances", "num_compact",
                             "num_kmax_truncated")
                    for keys, op in ((means, "mean"), (maxes, "max")):
                        metrics.update(zip(keys, _all_reduce(
                            [metrics[key] for key in keys], op, group)))
        return ts, metrics

    return step_fn
