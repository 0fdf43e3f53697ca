"""What decides ``correct``: the numbers compared, each against its limit.

Every number is the port's output judged by a plain reference
(``reference/``) on the harness's own inputs, after the window:

- ``kp_mismatch``: of the keyframes' keypoints (up to ``N_KEYFRAMES`` drawn
  from the seed) and the reference extractor's keypoints of the same images,
  the share that the other side lacks (same level, same position);
- ``desc_bits``: the share of descriptor bits that differ on the keypoints
  both sides have;
- ``b1_wrong``: entries of B1's four outputs that differ from the plain
  best-two, over the calls the window's capture kept;
- ``pose_dev_um``: over every OK frame of the window, the largest distance,
  in micrometres, by which a point of the frame's last pose solve lands
  elsewhere in the camera under the pose the frame's record returns than
  under the reference solver's (``reference/pose_lm.py``) from the same
  start and edges;
- ``ur_err_px``: over the keypoints of the keyframes made in the window
  that the stereo search matched, the median absolute error in pixels of
  their right-image coordinate against the true one, ``u - bf / z`` with
  the depth ``z`` of the room's wall along the keypoint's ray from the
  frame's true pose;
- ``mp_ray_mm``: the median over the map's points of the error of the
  point's distance along its first keyframe's ray against the true
  distance to the wall;
- ``rpe_t_mm``, ``rpe_r_mrad``: root mean square of the error of each
  frame's motion from the previous frame against the true motion, over
  consecutive OK frames of the window; ``ate_mm``: the root mean square
  position error of those frames after a rigid alignment per session.

A cell's limits file names the numbers that decide ``correct``; the others
are shown beside them. A number that a run cannot read (no call kept, no
keyframe made, a frame whose solve was not seen) is not correct.
``numbers(..., control=True)`` computes the same numbers for the control,
the references put in the port's place one precision lower (bfloat16
images, float8 distances, a bfloat16 solver, bfloat16 ground truth); they
set the limits' upper readings (``PERF.md``) and are never part of a run's
verdict.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch

from slambench.reference import b1 as b1_ref
from slambench.reference import orb as orb_ref
from slambench.reference import pose_lm
from slambench.reference import poses as pose_ref

N_KEYFRAMES = 6
NAMES = ("kp_mismatch", "desc_bits", "b1_wrong", "pose_dev_um", "ur_err_px",
         "mp_ray_mm", "rpe_t_mm", "rpe_r_mrad", "ate_mm")


def quat_to_R(q) -> np.ndarray:
    w, x, y, z = (float(v) for v in q)
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]])


def _keys(xy: np.ndarray, octave: np.ndarray) -> Dict:
    return {(int(o), float(x), float(y)): i
            for i, (o, (x, y)) in enumerate(zip(octave, xy))}


def _popcount_words(a: np.ndarray) -> int:
    x = a.astype(np.int64) & 0xFFFFFFFF
    return int(sum(((x >> s) & 1).sum() for s in range(32)))


def compare_keypoints(xy_a, oct_a, desc_a, xy_b, oct_b, desc_b):
    """(keypoints one side lacks, keypoints of both sides, differing bits,
    keypoints both have)."""
    A, B = _keys(xy_a, oct_a), _keys(xy_b, oct_b)
    both = sorted(set(A) & set(B))
    ia = np.array([A[k] for k in both], np.int64)
    ib = np.array([B[k] for k in both], np.int64)
    bits = (_popcount_words(desc_a[ia] ^ desc_b[ib]) if len(both) else 0)
    return len(A) + len(B) - 2 * len(both), len(A) + len(B), bits, len(both)


def _ratio(num, den):
    return num / den if den else float("nan")


def _frontend(out, device, control: bool):
    lacking = total = bits = matched = 0
    params = orb_ref.params_from_config(out["config"]["orb"])
    for kf in out["keyframes"]:
        gray = torch.from_numpy(out["grays"][kf["image"]]).to(device).float()
        ref = orb_ref.extract(gray, params)
        ref_np = (ref.xy.cpu().numpy(), ref.octave.cpu().numpy(),
                  ref.desc.cpu().numpy())
        if control:
            low = orb_ref.extract(gray, params, dtype=torch.bfloat16)
            got = (low.xy.cpu().numpy(), low.octave.cpu().numpy(),
                   low.desc.cpu().numpy())
        else:
            got = (kf["xy"], kf["octave"], kf["desc"])
        a, b, c, d = compare_keypoints(*got, *ref_np)
        lacking, total, bits, matched = (lacking + a, total + b, bits + c,
                                         matched + d)
    return _ratio(lacking, total), _ratio(bits, 256 * matched)


def _b1(out, control: bool):
    if not out["b1_calls"]:
        return float("nan")
    wrong = 0
    for args, outs in out["b1_calls"]:
        want = b1_ref.best_two(*args)
        got = b1_ref.best_two(*args, fp8=True) if control else outs
        wrong += b1_ref.wrong_entries(got, want)
    return wrong


def _pose_dev(out, control: bool):
    """On the host, in float64: each frame's returned pose (world to
    camera) against the reference solver's from its last solve's inputs."""
    slam = out["config"]
    cam, solver = slam["camera"], slam["solver"]
    sf = slam["orb"]["scale_factor"]
    if not out["solved"]:
        return float("nan")
    worst = 0.0
    for solve, R_wc, c_w in out["solved"]:
        if solve is None:
            return float("nan")
        q0, t0, pts, obs_uv, obs_ur, octave, valid = (
            a.cpu() for a in solve[:7])
        R_ref, t_ref, _ = pose_lm.optimize(q0, t0, pts, obs_uv, obs_ur,
                                           octave, valid, cam, solver, sf)
        if control:
            R, t, _ = pose_lm.optimize(q0, t0, pts, obs_uv, obs_ur, octave,
                                       valid, cam, solver, sf,
                                       dtype=torch.bfloat16)
        else:
            R = torch.from_numpy(np.asarray(R_wc, np.float64)).T
            t = -R @ torch.from_numpy(np.asarray(c_w, np.float64))
        X = pts[valid].double()
        if len(X):
            d = X @ (R - R_ref).T + (t - t_ref)
            worst = max(worst, float(torch.linalg.norm(d, dim=1).max()))
    return 1e6 * worst


def _u_right(out, control: bool):
    cam = out["config"]["camera"]
    gt = out["gt_poses"]
    errs = []
    for kf in out["window_keyframes"]:
        sel = kf["ur"] >= 0
        if not sel.any():
            continue
        R_wc, c_w = gt[kf["image"]]
        truth = pose_ref.true_u_right(kf["xy"][sel], R_wc, c_w, cam)
        got = pose_ref.to_bf16(truth) if control else kf["ur"][sel]
        errs.append(np.asarray(got, np.float64) - truth)
    if not errs:
        return float("nan")
    return float(np.median(np.abs(np.concatenate(errs))))


def _trajectory(out, control: bool):
    gt = out["gt_poses"]
    t_all, r_all, a_all = [], [], []
    for run in out["tracked_runs"]:
        truth = [gt[i] for i in run["images"]]
        if control:
            est = [(pose_ref.to_bf16(R), pose_ref.to_bf16(c)) for R, c in truth]
        else:
            est = run["poses"]
        t, r = pose_ref.relative_errors(est, truth)
        t_all += t
        r_all += r
        a_all += pose_ref.aligned_errors(est, truth)
    return (1e3 * pose_ref.rms(t_all), 1e3 * pose_ref.rms(r_all),
            1e3 * pose_ref.rms(a_all))


def _map_points(out, control: bool):
    gt = out["gt_poses"]
    errs = []
    for mp in out["maps"]:
        for k, image in mp["kf_image"].items():
            sel = mp["mp_first_kf"] == k
            if not sel.any():
                continue
            R_cw = quat_to_R(mp["kf_q"][k])
            p_cam = mp["mp_pos"][sel].astype(np.float64) @ R_cw.T + mp["kf_t"][k]
            p_cam = p_cam[np.linalg.norm(p_cam, axis=1) > 0.1]
            R_wc, c_w = gt[image]
            if control:
                p_cam = pose_ref.control_points_cam(p_cam, R_wc, c_w)
            errs.append(pose_ref.point_ray_errors(p_cam, R_wc, c_w))
    if not errs:
        return float("nan")
    return 1e3 * float(np.median(np.abs(np.concatenate(errs))))


def numbers(out, device, control: bool = False) -> Dict[str, float]:
    """The compared numbers of one run's outputs (or, with ``control``, of
    the control on the same inputs)."""
    kp, bits = _frontend(out, device, control)
    t, r, a = _trajectory(out, control)
    result = {"kp_mismatch": kp, "desc_bits": bits,
              "b1_wrong": _b1(out, control),
              "pose_dev_um": _pose_dev(out, control),
              "ur_err_px": _u_right(out, control),
              "mp_ray_mm": _map_points(out, control),
              "rpe_t_mm": t, "rpe_r_mrad": r, "ate_mm": a}
    return {k: result[k] for k in NAMES}


def verdict(values: Dict[str, float], limits: Dict[str, float]):
    """(correct, [(name, value, limit)]): every compared number finite and
    at most its limit. A number the limits do not name is shown, not
    compared; a limit whose number is missing or not finite fails."""
    rows, ok = [], True
    for name, limit in limits.items():
        v = values.get(name)
        good = v is not None and math.isfinite(v) and v <= limit
        ok = ok and good
        rows.append((name, v, limit))
    return ok, rows
