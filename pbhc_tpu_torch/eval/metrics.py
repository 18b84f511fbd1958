"""Tracking accuracy + smoothness metrics (a copy of `pbhc_tpu/eval/metrics.py`,
which imports no JAX; the port keeps its own) — formula-identical to the reference.

Reimplements the reference metric library (reference humanoidverse/
measure_traj.py:145-287) with the exact aggregation AND the exact harness
convention its eval entry points use (reference ratio_eps.py:69-70,
sample_eps.py:66-67): per-frame finite differences (``delta_per_frame=True``
=> delta=1, no dt scaling) and a final x1e3 on every value. A number produced
here is directly comparable to a number in a reference-harness metrics JSON.

Aggregation (measure_traj.py:157-195): position families take the L2 norm
over the trailing 3-vector, then mean over bodies, then mean over time; the
dof families take the L2 norm over the WHOLE dof vector, then mean over time
(NOT the elementwise-abs mean). Root errors are body 0 of the FK'd tree
(measure_traj.py:190-191).

Units with the default convention: positions mm; velocities mm/frame;
accelerations mm/frame^2; E_mpj* are L2-over-dof-vector in mrad-scale.
All functions are plain numpy over [T, ...] trajectories.
"""
from __future__ import annotations

import numpy as np


def _fd(x, delta, order=1):
    for _ in range(order):
        x = (x[1:] - x[:-1]) * delta
    return x


def _delta(dt, delta_per_frame):
    # reference measure_traj.py:169-173 — delta=1 per frame, else delta=fps
    if delta_per_frame:
        return 1.0
    if dt is None:
        raise ValueError("delta_per_frame=False requires dt (per-second units)")
    return 1.0 / float(dt)


def eval_accuracy(traj: dict, ref: dict, dt: float | None = None,
                  delta_per_frame: bool = True) -> dict:
    """Accuracy family (reference measure_traj.py:145-222, x1e3 per its
    harness callers ratio_eps.py:69 / sample_eps.py:66).

    traj/ref: dicts with body_pos [T,B,3], dof_pos [T,nd], optional
    contact_mask [T,C]. Body 0 must be the root (pelvis) body.
    """
    out = {}
    d = _delta(dt, delta_per_frame)
    bp, rbp = traj["body_pos"], ref["body_pos"]
    T = min(len(bp), len(rbp))
    bp, rbp = bp[:T], rbp[:T]

    # global mean per-body position error (measure_traj.py:161)
    out["E_gmpbpe"] = float(np.linalg.norm(bp - rbp, axis=-1).mean() * 1e3)
    # root-relative mean per-body position error (measure_traj.py:165-167)
    rel = (bp - bp[:, :1]) - (rbp - rbp[:, :1])
    out["E_mpbpe"] = float(np.linalg.norm(rel, axis=-1).mean() * 1e3)

    # dof families: L2 norm over the dof VECTOR, then mean over time
    # (measure_traj.py:170,181-182)
    dof, rdof = traj["dof_pos"][:T], ref["dof_pos"][:T]
    out["E_mpjpe"] = float(np.linalg.norm(dof - rdof, axis=-1).mean() * 1e3)
    dv, rdv = _fd(dof, d), _fd(rdof, d)
    out["E_mpjve"] = float(np.linalg.norm(dv - rdv, axis=-1).mean() * 1e3)
    da, rda = _fd(dv, d), _fd(rdv, d)
    out["E_mpjae"] = float(np.linalg.norm(da - rda, axis=-1).mean() * 1e3)

    # body velocity / acceleration errors (measure_traj.py:184-192)
    bv, rbv = _fd(bp, d), _fd(rbp, d)
    out["E_pbve"] = float(np.linalg.norm(bv - rbv, axis=-1).mean() * 1e3)
    ba, rba = _fd(bv, d), _fd(rbv, d)
    out["E_pbae"] = float(np.linalg.norm(ba - rba, axis=-1).mean() * 1e3)
    # root = body 0 of the FK'd tree (measure_traj.py:190-191)
    out["E_root_vel"] = float(
        np.linalg.norm(bv[:, 0] - rbv[:, 0], axis=-1).mean() * 1e3)
    out["E_root_acc"] = float(
        np.linalg.norm(ba[:, 0] - rba[:, 0], axis=-1).mean() * 1e3)

    if "contact_mask" in traj and "contact_mask" in ref:
        # mean absolute contact-probability error (measure_traj.py:194-195;
        # an error, LOWER is better, despite the _acc name)
        out["E_contact_acc"] = float(
            np.abs(traj["contact_mask"][:T] - ref["contact_mask"][:T])
            .mean() * 1e3)
    return out


def eval_smoothness(traj: dict, dt: float | None = None, ref: dict | None = None,
                    delta_per_frame: bool = True) -> dict:
    """Jerk-family smoothness (reference measure_traj.py:224-287, x1e3 per
    harness). dof families are L2-over-dof-vector then mean; pass ``ref`` to
    also emit the reference-motion anchors L2_ref_* (measure_traj.py:255-272).
    """
    d = _delta(dt, delta_per_frame)

    def fam(prefix, pos, dof):
        o = {}
        v = _fd(pos, d)
        a = _fd(v, d)
        j = _fd(a, d)
        o[f"L2_{prefix}vel"] = float(np.linalg.norm(v, axis=-1).mean() * 1e3)
        o[f"L2_{prefix}acc"] = float(np.linalg.norm(a, axis=-1).mean() * 1e3)
        o[f"L2_{prefix}jerk"] = float(np.linalg.norm(j, axis=-1).mean() * 1e3)
        dv = _fd(dof, d)
        da = _fd(dv, d)
        dj = _fd(da, d)
        o[f"L2_{prefix}dof_vel"] = float(np.linalg.norm(dv, axis=-1).mean() * 1e3)
        o[f"L2_{prefix}dof_acc"] = float(np.linalg.norm(da, axis=-1).mean() * 1e3)
        o[f"L2_{prefix}dof_jerk"] = float(np.linalg.norm(dj, axis=-1).mean() * 1e3)
        return o

    out = fam("", traj["body_pos"], traj["dof_pos"])
    if ref is not None:
        out.update(fam("ref_", ref["body_pos"], ref["dof_pos"]))
    return out


def episode_length_ratio(episode_lengths, motion_lengths, dt):
    """Mean episode length / motion length (reference ratio_eps.py)."""
    el = np.asarray(episode_lengths, dtype=np.float64) * dt
    ml = np.asarray(motion_lengths, dtype=np.float64)
    return float((el / ml).mean())
