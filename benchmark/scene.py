"""The seeded scene of the offline cells: range scans of a box room with
obstacles, taken by a spinning multi-ring lidar that circles the room.

The room, its obstacles and the trajectory are those of the repository's
chip smoke (``synthetic_scans``); the sensor's rings, azimuth steps and
range noise come from the configuration file, so one generator serves every
sensor a configuration names.  The same seed gives the same scans.

The draws and the beam directions are numpy's; the rays' distances to the
walls and obstacles are float64 PyTorch on the run's device, each a single
correctly rounded operation (subtract, divide, compare, min, max), so the
card and the CPU give the same bits.
"""

from __future__ import annotations

import numpy as np
import torch


def _ray_box_exit(o, d, lo, hi):
    """Distance along unit rays d [..., 3] from o [..., 3] (inside the box)
    to its wall."""
    inf = torch.full((), float("inf"), dtype=d.dtype, device=d.device)
    t = torch.where(d > 0, (hi - o) / d, torch.where(d < 0, (lo - o) / d, inf))
    return t.min(dim=-1).values


def _ray_box_entry(o, d, lo, hi):
    """Entry distance of rays into a box outside them (inf where missed); a
    NaN slab bound (a ray in the slab's plane) is passed over."""
    t1 = (lo - o) / d
    t2 = (hi - o) / d
    near, far = torch.minimum(t1, t2), torch.maximum(t1, t2)
    tmin = torch.fmax(torch.fmax(near[..., 0], near[..., 1]), near[..., 2])
    tmax = torch.fmin(torch.fmin(far[..., 0], far[..., 1]), far[..., 2])
    hit = (tmax >= tmin) & (tmin > 0)
    return torch.where(hit, tmin, float("inf"))


def beam_directions(sensor: dict) -> tuple[np.ndarray, np.ndarray]:
    """(azimuths [A], elevations [E]) of one revolution, before its jitter:
    ``rings`` elevations evenly over ±``elevation_deg``, ``azimuth_steps``
    azimuths evenly over the circle."""
    el = np.deg2rad(float(sensor["elevation_deg"]))
    elev = np.linspace(-el, el, int(sensor["rings"]))
    az = np.linspace(0.0, 2 * np.pi, int(sensor["azimuth_steps"]), endpoint=False)
    return az, elev


def scans(config: dict, n_scans: int, seed: int, device="cpu") -> tuple[list, list]:
    """(clouds, origins): ``n_scans`` clouds [rings·azimuth_steps, 3] f32 and
    their sensor origins [3] f32, scan i taken at angle 2πi/period of the
    circle, each origin jittered, each revolution's azimuths offset, each
    range perturbed, all drawn from ``seed``; the rays traced on
    ``device``."""
    room, sensor, traj = config["scene"], config["sensor"], config["trajectory"]
    rng = np.random.default_rng(int(seed) % 2 ** 64)
    jitter = rng.normal(0.0, float(traj["origin_jitter_m"]), (n_scans, 3))
    az_off = rng.uniform(0.0, float(traj["azimuth_jitter_rad"]), n_scans)
    az, elev = beam_directions(sensor)
    n_beams = az.size * elev.size
    noise = rng.normal(0.0, float(sensor["range_noise_m"]), (n_scans, n_beams))

    i = np.arange(n_scans)
    a = 2 * np.pi * i / float(traj["period_scans"])
    r = float(traj["radius_m"])
    origins = np.stack([r * np.cos(a), r * np.sin(a),
                        np.full(n_scans, float(traj["height_m"]))], -1) + jitter
    azg = az[None, :, None] + az_off[:, None, None]                   # [S, A, 1]
    elg = elev[None, None, :]                                         # [1, 1, E]
    d = np.stack(np.broadcast_arrays(np.cos(elg) * np.cos(azg), np.cos(elg) * np.sin(azg),
                                     np.sin(elg)), -1).reshape(n_scans, n_beams, 3)

    def dev(x):
        return torch.as_tensor(np.asarray(x, np.float64), device=device)

    o, d = dev(origins[:, None, :]), dev(d)
    t = _ray_box_exit(o, d, dev(room["lo"]), dev(room["hi"]))
    for lo, hi in room["obstacles"]:
        t = torch.minimum(t, _ray_box_entry(o, d, dev(lo), dev(hi)))
    t = t + dev(noise)
    clouds = (o + d * t[..., None]).to(torch.float32).cpu().numpy()
    origins = origins.astype(np.float32)
    return [clouds[k] for k in range(n_scans)], [origins[k] for k in range(n_scans)]
