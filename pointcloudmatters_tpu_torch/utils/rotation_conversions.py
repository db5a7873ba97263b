"""Rotation conversions in torch (port of
``pointcloudmatters_tpu/utils/rotation_conversions.py``).

Quaternions are ``(w, x, y, z)`` scalar-first, matrices ``(..., 3, 3)``, 6D
rotations the first two matrix rows flattened (Zhou et al.); every function
is batched over leading dimensions and differentiable.
"""

from __future__ import annotations

from typing import Optional

import torch

__all__ = [
    "quaternion_to_matrix",
    "matrix_to_quaternion",
    "quaternion_multiply",
    "quaternion_raw_multiply",
    "quaternion_invert",
    "quaternion_apply",
    "standardize_quaternion",
    "axis_angle_to_quaternion",
    "quaternion_to_axis_angle",
    "axis_angle_to_matrix",
    "matrix_to_axis_angle",
    "euler_angles_to_matrix",
    "matrix_to_euler_angles",
    "rotation_6d_to_matrix",
    "matrix_to_rotation_6d",
    "random_quaternions",
    "random_rotations",
]


def quaternion_to_matrix(quaternions: torch.Tensor) -> torch.Tensor:
    """(..., 4) wxyz -> (..., 3, 3)."""
    r, i, j, k = torch.unbind(quaternions, -1)
    two_s = 2.0 / (quaternions * quaternions).sum(-1)
    o = torch.stack(
        [
            1 - two_s * (j * j + k * k),
            two_s * (i * j - k * r),
            two_s * (i * k + j * r),
            two_s * (i * j + k * r),
            1 - two_s * (i * i + k * k),
            two_s * (j * k - i * r),
            two_s * (i * k - j * r),
            two_s * (j * k + i * r),
            1 - two_s * (i * i + j * j),
        ],
        dim=-1,
    )
    return o.reshape(quaternions.shape[:-1] + (3, 3))


def _sqrt_positive_part(x: torch.Tensor) -> torch.Tensor:
    """sqrt(max(0, x)) with a zero subgradient at x <= 0 (the square root
    is taken of 1 there, so no NaN reaches the gradient)."""
    positive = x > 0
    safe = torch.where(positive, x, torch.ones_like(x))
    return torch.where(positive, torch.sqrt(safe), torch.zeros_like(x))


def _first_argmax(x: torch.Tensor) -> torch.Tensor:
    """The index of the largest entry of the last axis, the first of equal
    ones (``jnp.argmax``'s order, which ``torch.argmax`` does not promise)."""
    is_max = x == x.amax(-1, keepdim=True)
    idx = torch.arange(x.shape[-1], device=x.device).expand_as(x)
    return torch.where(is_max, idx, x.shape[-1]).amin(-1)


def matrix_to_quaternion(matrix: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) -> (..., 4) wxyz: the candidate of the largest quaternion
    component, its real part made nonnegative."""
    m = matrix
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]

    q_abs = torch.stack(
        [
            _sqrt_positive_part(1.0 + m00 + m11 + m22),
            _sqrt_positive_part(1.0 + m00 - m11 - m22),
            _sqrt_positive_part(1.0 - m00 + m11 - m22),
            _sqrt_positive_part(1.0 - m00 - m11 + m22),
        ],
        dim=-1,
    )
    quat_by_rijk = torch.stack(
        [
            torch.stack([q_abs[..., 0] ** 2, m21 - m12, m02 - m20, m10 - m01], -1),
            torch.stack([m21 - m12, q_abs[..., 1] ** 2, m10 + m01, m02 + m20], -1),
            torch.stack([m02 - m20, m10 + m01, q_abs[..., 2] ** 2, m12 + m21], -1),
            torch.stack([m10 - m01, m20 + m02, m21 + m12, q_abs[..., 3] ** 2], -1),
        ],
        dim=-2,
    )  # (..., 4, 4)
    flr = 0.1
    quat_candidates = quat_by_rijk / (
        2.0 * torch.maximum(q_abs[..., None], flr * torch.ones_like(q_abs[..., None])))
    best = _first_argmax(q_abs)
    out = torch.take_along_dim(
        quat_candidates, best[..., None, None].expand(best.shape + (1, 4)), dim=-2)[..., 0, :]
    return standardize_quaternion(out)


def standardize_quaternion(quaternions: torch.Tensor) -> torch.Tensor:
    """Force a nonnegative real part."""
    return torch.where(quaternions[..., :1] < 0, -quaternions, quaternions)


def quaternion_raw_multiply(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    aw, ax, ay, az = torch.unbind(a, -1)
    bw, bx, by, bz = torch.unbind(b, -1)
    return torch.stack(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ],
        dim=-1,
    )


def quaternion_multiply(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return standardize_quaternion(quaternion_raw_multiply(a, b))


def quaternion_invert(quaternion: torch.Tensor) -> torch.Tensor:
    return quaternion * quaternion.new_tensor([1.0, -1.0, -1.0, -1.0])


def quaternion_apply(quaternion: torch.Tensor, point: torch.Tensor) -> torch.Tensor:
    """Rotate (..., 3) points by (..., 4) quaternions."""
    point_q = torch.cat([point.new_zeros(point.shape[:-1] + (1,)), point], dim=-1)
    out = quaternion_raw_multiply(
        quaternion_raw_multiply(quaternion, point_q), quaternion_invert(quaternion))
    return out[..., 1:]


def _sin_half_over_angle(angles: torch.Tensor, half: torch.Tensor) -> torch.Tensor:
    # taylor: sin(x/2)/x ~ 1/2 - x^2/48 below 1e-6
    small = torch.abs(angles) < 1e-6
    return torch.where(small, 0.5 - (angles * angles) / 48.0,
                       torch.sin(half) / torch.where(small, torch.ones_like(angles), angles))


def axis_angle_to_quaternion(axis_angle: torch.Tensor) -> torch.Tensor:
    angles = torch.linalg.norm(axis_angle, dim=-1, keepdim=True)
    half = angles * 0.5
    return torch.cat([torch.cos(half), axis_angle * _sin_half_over_angle(angles, half)], dim=-1)


def quaternion_to_axis_angle(quaternions: torch.Tensor) -> torch.Tensor:
    norms = torch.linalg.norm(quaternions[..., 1:], dim=-1, keepdim=True)
    half = torch.atan2(norms, quaternions[..., :1])
    return quaternions[..., 1:] / _sin_half_over_angle(2.0 * half, half)


def axis_angle_to_matrix(axis_angle: torch.Tensor) -> torch.Tensor:
    return quaternion_to_matrix(axis_angle_to_quaternion(axis_angle))


def matrix_to_axis_angle(matrix: torch.Tensor) -> torch.Tensor:
    return quaternion_to_axis_angle(matrix_to_quaternion(matrix))


def _axis_angle_rotation(axis: str, angle: torch.Tensor) -> torch.Tensor:
    cos, sin = torch.cos(angle), torch.sin(angle)
    one, zero = torch.ones_like(angle), torch.zeros_like(angle)
    if axis == "X":
        flat = (one, zero, zero, zero, cos, -sin, zero, sin, cos)
    elif axis == "Y":
        flat = (cos, zero, sin, zero, one, zero, -sin, zero, cos)
    elif axis == "Z":
        flat = (cos, -sin, zero, sin, cos, zero, zero, zero, one)
    else:
        raise ValueError("letter must be either X, Y or Z.")
    return torch.stack(flat, dim=-1).reshape(angle.shape + (3, 3))


def _check_convention(convention: str) -> None:
    if len(convention) != 3 or any(c not in "XYZ" for c in convention):
        raise ValueError(f"Invalid convention {convention}.")


def euler_angles_to_matrix(euler_angles: torch.Tensor, convention: str) -> torch.Tensor:
    """(..., 3) angles and a convention such as "XYZ" -> (..., 3, 3)."""
    _check_convention(convention)
    m = [_axis_angle_rotation(c, euler_angles[..., i]) for i, c in enumerate(convention)]
    return m[0] @ m[1] @ m[2]


def _angle_from_tan(axis: str, other_axis: str, data: torch.Tensor, horizontal: bool,
                    tait_bryan: bool) -> torch.Tensor:
    i1, i2 = {"X": (2, 1), "Y": (0, 2), "Z": (1, 0)}[axis]
    if horizontal:
        i2, i1 = i1, i2
    even = (axis + other_axis) in ["XY", "YZ", "ZX"]
    if horizontal == even:
        return torch.atan2(data[..., i1], data[..., i2])
    if tait_bryan:
        return torch.atan2(-data[..., i2], data[..., i1])
    return torch.atan2(data[..., i2], -data[..., i1])


def matrix_to_euler_angles(matrix: torch.Tensor, convention: str) -> torch.Tensor:
    _check_convention(convention)
    i0 = "XYZ".index(convention[0])
    i2 = "XYZ".index(convention[2])
    tait_bryan = i0 != i2
    if tait_bryan:
        central = torch.asin(torch.clamp(
            matrix[..., i0, i2] * (-1.0 if i0 - i2 in [-1, 2] else 1.0), -1.0, 1.0))
    else:
        central = torch.acos(torch.clamp(matrix[..., i0, i0], -1.0, 1.0))
    o = (
        _angle_from_tan(convention[0], convention[1], matrix[..., i2], False, tait_bryan),
        central,
        _angle_from_tan(convention[2], convention[1], matrix[..., i0, :], True, tait_bryan),
    )
    return torch.stack(o, dim=-1)


def rotation_6d_to_matrix(d6: torch.Tensor) -> torch.Tensor:
    """(..., 6) -> (..., 3, 3) by Gram-Schmidt (Zhou et al. 2019)."""
    a1, a2 = d6[..., :3], d6[..., 3:]
    b1 = a1 / torch.linalg.norm(a1, dim=-1, keepdim=True).clamp_min(1e-12)
    b2 = a2 - (b1 * a2).sum(-1, keepdim=True) * b1
    b2 = b2 / torch.linalg.norm(b2, dim=-1, keepdim=True).clamp_min(1e-12)
    b3 = torch.linalg.cross(b1, b2, dim=-1)
    return torch.stack([b1, b2, b3], dim=-2)


def matrix_to_rotation_6d(matrix: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) -> (..., 6): the first two rows flattened."""
    return matrix[..., :2, :].reshape(matrix.shape[:-2] + (6,))


def random_quaternions(n: int, generator: Optional[torch.Generator] = None,
                       dtype: torch.dtype = torch.float32, device=None) -> torch.Tensor:
    q = torch.randn((n, 4), generator=generator, dtype=dtype, device=device)
    return q / torch.linalg.norm(q, dim=-1, keepdim=True)


def random_rotations(n: int, generator: Optional[torch.Generator] = None,
                     dtype: torch.dtype = torch.float32, device=None) -> torch.Tensor:
    return quaternion_to_matrix(random_quaternions(n, generator, dtype, device))
