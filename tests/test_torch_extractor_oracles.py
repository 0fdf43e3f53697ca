"""The OpenCV and numpy oracles of tests/test_extractor.py, applied to the
port's extractor: FAST masks, scores and non-max vs cv2, IC angles and
rBRIEF bits vs direct numpy ports of ORBextractor.cc, the blur vs cv2, and
full descriptors vs cv2.ORB.compute. Same image, same tolerances."""

import cv2
import numpy as np
import pytest
import torch

from test_extractor import IMG, _brief_numpy, _ic_angle_numpy

from orb_slam_2_ros_tpu_torch.config import OrbConfig
from orb_slam_2_ros_tpu_torch.frontend import extractor
from orb_slam_2_ros_tpu_torch.ops import fast as fast_ops
from orb_slam_2_ros_tpu_torch.ops.image import gaussian_blur_7x7, quantize_u8

TH = 20


def _img():
    return torch.from_numpy(IMG.astype(np.float32))


def test_fast_mask_matches_opencv():
    ours = fast_ops.fast_score_map(_img()).numpy() >= TH
    det = cv2.FastFeatureDetector_create(TH, nonmaxSuppression=False)
    theirs = np.zeros(IMG.shape, bool)
    for kp in det.detect(IMG):
        theirs[int(round(kp.pt[1])), int(round(kp.pt[0]))] = True
    np.testing.assert_array_equal(ours[3:-3, 3:-3], theirs[3:-3, 3:-3])


def test_fast_score_matches_opencv():
    det = cv2.FastFeatureDetector_create(TH, nonmaxSuppression=True)
    score = fast_ops.fast_score_map(_img()).numpy()
    kps = det.detect(IMG)
    assert len(kps) >= 5
    for kp in kps[:200]:
        x, y = int(round(kp.pt[0])), int(round(kp.pt[1]))
        assert score[y, x] == pytest.approx(kp.response), (x, y)


def test_fast_nonmax_matches_opencv():
    resp = fast_ops.detect(fast_ops.fast_score_map(_img()), threshold=TH,
                           min_threshold=TH, cell=32, border=3).numpy()
    ours = set(map(tuple, np.argwhere(resp > 0)))
    det = cv2.FastFeatureDetector_create(TH, nonmaxSuppression=True)
    theirs = {(int(round(kp.pt[1])), int(round(kp.pt[0])))
              for kp in det.detect(IMG)
              if 3 <= kp.pt[0] < IMG.shape[1] - 3
              and 3 <= kp.pt[1] < IMG.shape[0] - 3}
    sym = ours.symmetric_difference(theirs)
    assert len(sym) <= max(2, 0.01 * len(theirs)), sorted(sym)[:10]


def test_ic_angle_matches_oracle():
    pts = [(60, 60), (100, 120), (150, 200), (30, 30), (200, 280)]
    ys = torch.tensor([p[0] for p in pts])
    xs = torch.tensor([p[1] for p in pts])
    got = extractor.ic_angles_at(_img(), xs, ys).numpy()
    for i, (y, x) in enumerate(pts):
        expected = _ic_angle_numpy(IMG.astype(np.float32), x, y)
        assert abs(np.angle(np.exp(1j * (got[i] - expected)))) < 1e-4, (y, x)


def test_brief_matches_numpy_oracle():
    blurred = quantize_u8(gaussian_blur_7x7(_img()))
    xs = np.array([60, 100, 200, 150, 255])
    ys = np.array([60, 120, 150, 200, 100])
    angles = np.array([0.0, 0.5, -1.2, 2.8, 3.9], np.float32)
    ours = extractor._descriptors(blurred, torch.from_numpy(xs),
                                  torch.from_numpy(ys),
                                  torch.from_numpy(angles)).numpy()
    for i in range(len(xs)):
        expected = _brief_numpy(blurred.numpy(), xs[i], ys[i],
                                float(angles[i]))
        got = np.frombuffer(np.ascontiguousarray(ours[i]).tobytes(), np.uint8)
        np.testing.assert_array_equal(got, expected, err_msg=f"kp {i}")


def test_blur_close_to_opencv():
    ours = quantize_u8(gaussian_blur_7x7(_img())).numpy()
    theirs = cv2.GaussianBlur(IMG, (7, 7), 2, borderType=cv2.BORDER_REFLECT_101)
    diff = np.abs(ours.astype(int) - theirs.astype(int))
    assert diff.max() <= 1 and (diff > 0).mean() < 0.02


def test_extract_descriptor_parity_with_opencv():
    """Full-pipeline descriptors against cv2.ORB.compute on the port's
    level-0 keypoints (OpenCV's fixed-point blur and fastAtan2 flip a few
    bits)."""
    rng = np.random.default_rng(5)
    rich = np.clip(IMG.astype(np.float32) + rng.uniform(-40, 40, IMG.shape),
                   0, 255).round().astype(np.uint8)
    cfg = OrbConfig(n_features=400, n_levels=1, max_kps=512)
    kps = extractor.extract(torch.from_numpy(rich.astype(np.float32)), cfg)
    v = kps.valid.numpy()
    xy = kps.xy.numpy()[v]
    ang = np.degrees(kps.angle.numpy()[v]) % 360.0
    resp = kps.response.numpy()[v]
    ours = kps.desc.numpy()[v]
    cv_kps = [cv2.KeyPoint(float(x), float(y), 31.0, float(a), float(r), 0)
              for (x, y), a, r in zip(xy, ang, resp)]
    orb = cv2.ORB_create(nfeatures=1000, nlevels=1, edgeThreshold=19,
                         patchSize=31, fastThreshold=20)
    out_kps, cv_desc = orb.compute(rich, cv_kps)
    coords = {(round(k.pt[0], 1), round(k.pt[1], 1)): i
              for i, k in enumerate(out_kps)}
    n_cmp, bits = 0, 0
    for j, (x, y) in enumerate(xy):
        i = coords.get((round(float(x), 1), round(float(y), 1)))
        if i is None:
            continue
        ours_bytes = np.frombuffer(np.ascontiguousarray(ours[j]).tobytes(),
                                   np.uint8)
        bits += np.unpackbits(ours_bytes ^ cv_desc[i]).sum()
        n_cmp += 1
    assert n_cmp > 100
    assert bits / n_cmp < 8.0, bits / n_cmp
