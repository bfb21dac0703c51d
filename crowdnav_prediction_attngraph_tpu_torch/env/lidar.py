"""Batched 2D lidar scan over circular agents (JAX package ``env/lidar.py``).

The reference declares a lidar config group (config.py:145-150: angular_res 5
degrees, range 10 m) that no shipped env consumes; here the sensor is an
observation op: ray/circle intersection over all (ray, human) pairs at once,
on any leading batch shape, in the mask-padded human layout of the rest of
the simulator.
"""

from __future__ import annotations

import math

import torch

from ..config import Config


def num_rays(cfg: Config) -> int:
    return int(round(360.0 / cfg.lidar.angular_res))


def scan(cfg: Config, robot_pos: torch.Tensor, robot_theta: torch.Tensor,
         human_pos: torch.Tensor, human_radius: torch.Tensor,
         human_mask: torch.Tensor) -> torch.Tensor:
    """Ranges to the nearest human along each ray, clipped to lidar.range.

    robot_pos:    (..., 2)
    robot_theta:  (...)    ray 0 points along the robot heading
    human_pos:    (..., A, 2)
    human_radius: (..., A)
    human_mask:   (..., A)  nonzero = present
    returns       (..., R)  R = 360 / angular_res
    """
    R = num_rays(cfg)
    max_range = cfg.lidar.range
    if human_pos.shape[-2] == 0:
        return torch.full(robot_theta.shape + (R,), max_range,
                          dtype=robot_pos.dtype, device=robot_pos.device)
    step = 2.0 * math.pi / R
    angles = robot_theta[..., None] + torch.arange(
        R, device=robot_pos.device, dtype=robot_pos.dtype) * step   # (..., R)
    d = torch.stack([torch.cos(angles), torch.sin(angles)], dim=-1)

    rel = human_pos - robot_pos[..., None, :]                    # (..., A, 2)
    # t: projection of each center onto each ray; closest2: squared distance
    # from center to the ray line
    t = torch.einsum("...rk,...ak->...ra", d, rel)               # (..., R, A)
    c2 = (rel * rel).sum(-1)[..., None, :]                       # (..., 1, A)
    closest2 = c2 - t * t
    r2 = (human_radius * human_radius)[..., None, :]
    inside = closest2 <= r2
    hit_t = t - torch.sqrt(torch.clamp(r2 - closest2, min=0.0))
    valid = inside & (hit_t > 0.0) & (human_mask[..., None, :] > 0)
    ranges = torch.where(valid, hit_t, torch.full_like(hit_t, max_range))
    return torch.clamp(ranges.amin(dim=-1), max=max_range)
