"""PyTorch port vs the JAX package (and OpenCV, which the JAX package
calls): lens undistortion.

`data/undistort.py` rebuilds OpenCV's undistortion stage by stage. Each
stage is held against OpenCV's own function here, so a mismatch points to
one stage, and `undistort_image` against the JAX package's, which calls
OpenCV. What the port reaches on this OpenCV:

- the new camera matrices (getOptimalNewCameraMatrix alpha 0,
  fisheye.estimateNewCameraMatrixForUndistortRectify balance 0): equal;
- the CV_16SC2 maps of initUndistortRectifyMap: equal; its CV_32FC1 maps
  and fisheye.initUndistortRectifyMap's: equal on all but at most 2e-4 of
  the entries, those within one float32 step or 1e-14 pixel of 0 (OpenCV's
  vector path fuses its float64 multiply-adds, which rounds a last bit
  elsewhere);
- remap on CV_16SC2 maps (fixed point) and on float maps (OpenCV 5's
  float32 lerps), with pixels outside and straddling the border: equal;
- `undistort_image`, both branches, three coefficient sets each, at 83x61
  and 128x96: the new K and every pixel equal to the JAX package's.
The acceptance bar is looser (K within 1e-6 relative, pixels equal on
99.9% and within one grey level); the tests hold what was reached.
"""

import numpy as np
import pytest
import torch

import cv2

from gaussiangrasper_torch.data import undistort as tu
from gaussiangrasper_torch.data.dataparsers.base import ParsedCamera as TPC
from gaussiangrasper_torch.data.dataparsers.zoo import resolve_parser as t_resolve
from gaussiangrasper_torch.data.manager import FullImageDatamanager as TDM
from gaussiangrasper_torch.data.manager import undistort_image as t_undistort
from gaussiangrasper_tpu.data.dataparsers.base import ParsedCamera as JPC
from gaussiangrasper_tpu.data.dataparsers.zoo import resolve_parser as j_resolve
from gaussiangrasper_tpu.data.manager import FullImageDatamanager as JDM
from gaussiangrasper_tpu.data.manager import undistort_image as j_undistort
from tests.test_torch_data import _colmap_scene

SIZES = [(83, 61), (128, 96)]
# (k1, k2, p1, p2, k3, k4) as the parsers store them; a fisheye view's
# k1..k4 are entries 0, 1, 4, 5
COEFFS = {
    "perspective": {"mild": [-0.08, 0.02, 5e-4, -5e-4, 0.0, 0.0],
                    "strong_barrel": [-0.35, 0.12, 0.0, 0.0, -0.02, 0.0],
                    "tangential": [0.0, 0.0, 4e-3, -3e-3, 0.0, 0.0]},
    "fisheye": {"mild": [0.05, 0.01, 0.0, 0.0, -3e-3, 1e-3],
                "strong_barrel": [-0.2, 0.05, 0.0, 0.0, -0.01, 2e-3],
                "tangential": [0.0, 0.0, 0.0, 0.0, 0.01, 0.0]},
}
CASES = [(t, c, s) for t in COEFFS for c in COEFFS[t] for s in SIZES]


def camera(kind, coeffs, size):
    w, h = size
    return dict(fx=0.9 * w, fy=0.93 * w, cx=w / 2 + 1.3, cy=h / 2 - 0.7, width=w, height=h,
                camera_to_world=np.eye(4)[:3], distortion=np.array(COEFFS[kind][coeffs]),
                camera_type=kind)


def kmat(cam):
    return np.array([[cam["fx"], 0, cam["cx"]], [0, cam["fy"], cam["cy"]], [0, 0, 1]])


@pytest.mark.parametrize("kind,coeffs,size", CASES)
def test_undistort_image_matches_jax(kind, coeffs, size):
    w, h = size
    img = np.random.default_rng(w + len(coeffs)).integers(0, 256, (h, w, 3), dtype=np.uint8)
    cam = camera(kind, coeffs, size)
    want, jcam = j_undistort(img, JPC(**cam))
    got, tcam = t_undistort(img, TPC(**cam))
    for n in ("fx", "fy", "cx", "cy"):
        assert getattr(tcam, n) == getattr(jcam, n), n
    assert not tcam.distortion.any() and tcam.camera_type == kind
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    # a grey frame takes the same path
    np.testing.assert_array_equal(t_undistort(img[..., 1], TPC(**cam))[0],
                                  j_undistort(img[..., 1], JPC(**cam))[0])


@pytest.mark.parametrize("coeffs", list(COEFFS["perspective"]))
@pytest.mark.parametrize("size", SIZES)
def test_perspective_stages_match_opencv(coeffs, size):
    w, h = size
    cam = camera("perspective", coeffs, size)
    k, d = kmat(cam), cam["distortion"][:5]
    newk, _ = cv2.getOptimalNewCameraMatrix(k, d, size, 0)
    mine = tu.optimal_new_camera_matrix(k, d, size)
    np.testing.assert_array_equal(mine, newk)
    u, v = tu.rectify_map(k, d, newk, w, h)
    m16, f16 = cv2.initUndistortRectifyMap(k, d, np.eye(3), newk, size, cv2.CV_16SC2)
    iu, iv = tu.fixed_point(u).numpy(), tu.fixed_point(v).numpy()
    np.testing.assert_array_equal(iu >> 5, m16[..., 0])
    np.testing.assert_array_equal(iv >> 5, m16[..., 1])
    np.testing.assert_array_equal((iv & 31) * 32 + (iu & 31), f16)
    mx, my = cv2.initUndistortRectifyMap(k, d, np.eye(3), newk, size, cv2.CV_32FC1)
    for got, want in ((u.numpy().astype(np.float32), mx), (v.numpy().astype(np.float32), my)):
        assert np.mean(got != want) <= 5e-4
        np.testing.assert_allclose(got, want, rtol=2.0 ** -23, atol=1e-10)


@pytest.mark.parametrize("coeffs", list(COEFFS["fisheye"]))
@pytest.mark.parametrize("size", SIZES)
def test_fisheye_stages_match_opencv(coeffs, size):
    w, h = size
    cam = camera("fisheye", coeffs, size)
    k, d = kmat(cam), cam["distortion"][[0, 1, 4, 5]]
    newk = cv2.fisheye.estimateNewCameraMatrixForUndistortRectify(k, d, size, np.eye(3),
                                                                  balance=0.0)
    np.testing.assert_array_equal(tu.fisheye_new_camera_matrix(k, d, size), newk)
    mx, my = cv2.fisheye.initUndistortRectifyMap(k, d, np.eye(3), newk, size, cv2.CV_32FC1)
    gx, gy = tu.fisheye_rectify_map(k, d, newk, w, h)
    for got, want in ((gx.numpy(), mx), (gy.numpy(), my)):
        assert np.mean(got != want) <= 5e-4
        np.testing.assert_allclose(got, want, rtol=2.0 ** -23, atol=1e-10)


@pytest.mark.parametrize("seed", [0, 1])
def test_remap_matches_opencv_across_the_border(seed):
    """Random maps from 3 pixels outside to 2 past the far edge: taps
    outside the image count 0, whole footprints or part of them. Coarse
    (1/16 pixel) maps put many sums on a half, where the rounding shows."""
    rng = np.random.default_rng(seed)
    h, w = 37, 53
    img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    fine = (rng.uniform(-3, w + 2, (h, w)), rng.uniform(-3, h + 2, (h, w)))
    coarse = (rng.integers(-48, (w + 2) * 16, (h, w)) / 16,
              rng.integers(-48, (h + 2) * 16, (h, w)) / 16)
    for mx, my in (fine, coarse):
        mx, my = mx.astype(np.float32), my.astype(np.float32)
        want = cv2.remap(img, mx, my, interpolation=cv2.INTER_LINEAR)
        got = tu.remap_float(torch.from_numpy(img), torch.from_numpy(mx), torch.from_numpy(my))
        np.testing.assert_array_equal(got.numpy(), want)
        m16, f16 = cv2.convertMaps(mx, my, cv2.CV_16SC2)
        want = cv2.remap(img, m16, f16, interpolation=cv2.INTER_LINEAR)
        iu = torch.from_numpy(m16[..., 0].astype(np.int64) * 32 + (f16 & 31))
        iv = torch.from_numpy(m16[..., 1].astype(np.int64) * 32 + (f16 >> 5))
        np.testing.assert_array_equal(tu.remap_fixed(torch.from_numpy(img), iu, iv).numpy(), want)


def test_remap_float_rounds_like_fused_lerps():
    """Footprints where plain float32 lerps round to another grey level than
    fused multiply-adds: OpenCV takes the fused result, and so does
    remap_float."""
    f32, rng = np.float32, np.random.default_rng(11)
    n = 2_000_000
    a, b = rng.uniform(0, 1, n).astype(f32), rng.uniform(0, 1, n).astype(f32)
    p = rng.integers(0, 256, (4, n)).astype(f32)
    t0 = p[0] + a * (p[1] - p[0])
    t1 = p[2] + a * (p[3] - p[2])
    plain = np.rint(t0 + b * (t1 - t0))
    ta, tb, tp = torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(p)
    f0 = tu._fma32(ta, tp[1] - tp[0], tp[0])
    f1 = tu._fma32(ta, tp[3] - tp[2], tp[2])
    fused = torch.round(tu._fma32(tb, f1 - f0, f0)).numpy()
    cases = np.nonzero(plain != fused)[0]
    assert len(cases) >= 3
    for i in cases[:20]:
        img = np.zeros((3, 3), np.uint8)
        img[:2, :2] = p[:, i].reshape(2, 2)
        mx, my = np.array([[a[i]]], f32), np.array([[b[i]]], f32)
        want = cv2.remap(img, mx, my, interpolation=cv2.INTER_LINEAR)
        got = tu.remap_float(torch.from_numpy(img[..., None]), torch.from_numpy(mx),
                             torch.from_numpy(my))
        assert int(got[0, 0, 0]) == int(want[0, 0]) == int(fused[i]) != int(plain[i])


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    from gaussiangrasper_tpu.data.synthetic import generate_tabletop

    return generate_tabletop(tmp_path_factory.mktemp("tabletop") / "scene", width=64, height=48,
                             n_views=4, feature_downscale=2, seed_points=400)


@pytest.mark.parametrize("model,params", [
    ("OPENCV", [50.0, 52.0, 31.5, 24.0, -0.12, 0.03, 1e-3, -8e-4]),
    ("OPENCV_FISHEYE", [40.0, 41.0, 31.5, 24.0, 0.06, -0.01, 4e-3, -1e-3]),
])
def test_datamanager_undistorts_like_jax(scene, model, params, tmp_path):
    """A distorted COLMAP capture through both packages' datamanager: equal
    images and cameras; depth, normal and masks as the dataset loads them."""
    root = _colmap_scene(scene, tmp_path / "colmap", model=model, params=np.array(params))
    jdm = JDM(j_resolve(root).parse())
    tdm = TDM(t_resolve(root).parse(), device="cpu")
    raw = TDM(t_resolve(root).parse(), cache_all=False, device="cpu").dataset
    for i in range(len(jdm)):
        jd, td = jdm._load(i), tdm.view_data(i)
        np.testing.assert_array_equal(td["image"], jd["image"])
        jc, tc = jdm.cameras[i], tdm.cameras[i]
        assert (tc.fx, tc.fy, tc.cx, tc.cy, tc.camera_type) == (jc.fx, jc.fy, jc.cx, jc.cy,
                                                                jc.camera_type)
        assert not tc.distortion.any() and tc.fx != float(params[0])
        assert float(tdm.camera(i).fx) == np.float32(jc.fx)
        orig = raw.get_data(i)
        assert not np.array_equal(td["image"], orig["image"])
        for key in ("depth", "normal", "valid_mask"):
            np.testing.assert_array_equal(td[key], orig[key], err_msg=key)
            np.testing.assert_array_equal(td[key], jd[key], err_msg=key)
        np.testing.assert_array_equal(
            td["sam_mask"], np.where(orig["valid_mask"], orig["sam_mask"], -1))
