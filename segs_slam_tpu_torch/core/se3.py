"""SE(3) / quaternion utilities on torch tensors.

Port of segs_slam_tpu/core/se3.py. Quaternion convention is (w, x, y, z),
matching the reference's rotation construction (reference:
cuda_rasterizer/forward.cu:118-152 `computeCov3D`,
include/general_utils.h:31 `build_rotation`).
"""

from __future__ import annotations

import torch


def quat_to_rotmat(q: torch.Tensor) -> torch.Tensor:
    """Quaternion (..., 4) (w,x,y,z) -> rotation matrix (..., 3, 3), for the
    input as given (callers normalise where the reference does)."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    r00 = 1.0 - 2.0 * (y * y + z * z)
    r01 = 2.0 * (x * y - w * z)
    r02 = 2.0 * (x * z + w * y)
    r10 = 2.0 * (x * y + w * z)
    r11 = 1.0 - 2.0 * (x * x + z * z)
    r12 = 2.0 * (y * z - w * x)
    r20 = 2.0 * (x * z - w * y)
    r21 = 2.0 * (y * z + w * x)
    r22 = 1.0 - 2.0 * (x * x + y * y)
    return torch.stack(
        [
            torch.stack([r00, r01, r02], dim=-1),
            torch.stack([r10, r11, r12], dim=-1),
            torch.stack([r20, r21, r22], dim=-1),
        ],
        dim=-2,
    )


def normalize_quat(q: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    return q / torch.clamp(torch.linalg.norm(q, dim=-1, keepdim=True), min=eps)


def quat_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Hamilton product of (..., 4) (w,x,y,z) quaternions: rot(a∘b) =
    rot(a)·rot(b)."""
    aw, ax, ay, az = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    bw, bx, by, bz = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return torch.stack(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ],
        dim=-1,
    )


def rotmat_to_quat(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix (3, 3) -> quaternion (w, x, y, z), w >= 0."""
    m00, m01, m02 = R[0, 0], R[0, 1], R[0, 2]
    m10, m11, m12 = R[1, 0], R[1, 1], R[1, 2]
    m20, m21, m22 = R[2, 0], R[2, 1], R[2, 2]
    tr = m00 + m11 + m22

    s = torch.sqrt(torch.clamp(tr + 1.0, min=0.0)) * 2.0
    case_w = torch.stack([0.25 * s, (m21 - m12) / s, (m02 - m20) / s,
                          (m10 - m01) / s])
    s = torch.sqrt(torch.clamp(1.0 + m00 - m11 - m22, min=0.0)) * 2.0
    case_x = torch.stack([(m21 - m12) / s, 0.25 * s, (m01 + m10) / s,
                          (m02 + m20) / s])
    s = torch.sqrt(torch.clamp(1.0 + m11 - m00 - m22, min=0.0)) * 2.0
    case_y = torch.stack([(m02 - m20) / s, (m01 + m10) / s, 0.25 * s,
                          (m12 + m21) / s])
    s = torch.sqrt(torch.clamp(1.0 + m22 - m00 - m11, min=0.0)) * 2.0
    case_z = torch.stack([(m10 - m01) / s, (m02 + m20) / s, (m12 + m21) / s,
                          0.25 * s])

    use_w = tr > 0.0
    use_x = (m00 >= m11) & (m00 >= m22)
    use_y = m11 >= m22
    q = torch.where(use_w, case_w,
                    torch.where(use_x, case_x,
                                torch.where(use_y, case_y, case_z)))
    return torch.where(q[0] < 0, -q, q)


def se3_matrix(q: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """(w,x,y,z) quaternion + translation -> 4x4 world-to-camera matrix Rt
    (reference: src/gaussian_keyframe.cpp:230-249 getWorld2View2)."""
    Rt = torch.zeros(q.shape[:-1] + (4, 4), dtype=q.dtype, device=q.device)
    Rt[..., :3, :3] = quat_to_rotmat(q)
    Rt[..., :3, 3] = t
    Rt[..., 3, 3] = 1.0
    return Rt


def se3_inverse(T: torch.Tensor) -> torch.Tensor:
    """Invert a rigid 4x4 transform."""
    Rinv = T[..., :3, :3].transpose(-1, -2)
    out = torch.zeros_like(T)
    out[..., :3, :3] = Rinv
    out[..., :3, 3] = -torch.einsum("...ij,...j->...i", Rinv, T[..., :3, 3])
    out[..., 3, 3] = 1.0
    return out


def transform_points(T: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Apply a 4x4 rigid/similarity transform to (N, 3) points."""
    return pts @ T[:3, :3].T + T[:3, 3]


def scale_and_transform_points(T: torch.Tensor, scale,
                               pts: torch.Tensor) -> torch.Tensor:
    """Masked scale+transform used by loop-closure map correction
    (reference: src/operate_points.cu:96-143)."""
    return (pts * scale) @ T[:3, :3].T + T[:3, 3]
