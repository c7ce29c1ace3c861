"""PyTorch port vs the JAX package: scripts/segment.py.

- `cv_segment.bilateral_filter` bit-equal to `cv2.bilateralFilter(img, 9,
  50, 50)` on a tabletop frame, seeded noise and odd sizes (the border).
- `cv_segment.kmeans_pp`'s labels equal to `cv2.kmeans` with
  KMEANS_PP_CENTERS at K 3 and 8 over two seeds (`cv2.setRNGSeed(s)`
  against `OpenCVRNG(s)`), two calls continuing one stream, and duplicated
  points that reach OpenCV's empty-cluster repair.
- `cv_segment.connected_components` equal to `cv2.connectedComponents` on
  random masks, and components whose first blocks share a block row.
- `classic_instance_masks`, `main` (the .npy files of a two-image capture)
  and the SAM glue (one stub's fixed outputs behind transformers'
  interface for the JAX glue and behind the port's SamModel /
  SamProcessor interface) equal to the JAX functions; `--backend sam`
  without transformers and without a snapshot exits in the JAX message's
  form, naming the paths searched (tests/test_torch_foundation.py holds
  SAM itself).
"""

import sys

import cv2
import numpy as np
import pytest
import torch
from PIL import Image

from gaussiangrasper_torch.data.synthetic import generate_tabletop
from gaussiangrasper_torch.scripts import segment as tseg
from gaussiangrasper_torch.utils import cv_segment as cs
from gaussiangrasper_torch.utils.image_io import read_image

CRITERIA = (cv2.TERM_CRITERIA_EPS + cv2.TERM_CRITERIA_MAX_ITER, 10, 1.0)


@pytest.fixture(scope="module")
def frames(tmp_path_factory):
    """Two 96x96 tabletop frames (uint8 RGB)."""
    scene = generate_tabletop(tmp_path_factory.mktemp("seg") / "scene", width=96, height=96,
                              n_views=2, seed_points=64)
    return [read_image(p)[..., :3] for p in sorted((scene / "images").iterdir())]


def _noise(h, w, seed):
    return np.random.default_rng(seed).integers(0, 256, (h, w, 3), dtype=np.uint8)


def _cv_kmeans(z, k, seed):
    cv2.setRNGSeed(seed)
    return cv2.kmeans(z, k, None, CRITERIA, 3, cv2.KMEANS_PP_CENTERS)[1].ravel()


@pytest.mark.parametrize("case", ["tabletop", "noise_64x80", "odd_37x53", "odd_9x13"])
def test_bilateral_filter_matches_cv2(frames, case):
    img = {"tabletop": lambda: frames[0], "noise_64x80": lambda: _noise(64, 80, 1),
           "odd_37x53": lambda: _noise(37, 53, 2), "odd_9x13": lambda: _noise(9, 13, 3)}[case]()
    got = cs.bilateral_filter(img, 9, 50, 50, device="cpu").numpy()
    np.testing.assert_array_equal(got, cv2.bilateralFilter(img, 9, 50, 50))


def test_opencv_rng_zero_seed_is_a_fresh_thread():
    """cv::RNG maps a zero seed to 0xffffffff, a fresh thread's state: the
    k-means after cv2.setRNGSeed(0) is the one from OpenCVRNG() as well."""
    assert cs.OpenCVRNG(0).state == cs.OpenCVRNG().state == 0xFFFFFFFF
    z = _noise(20, 30, 6).reshape(-1, 3).astype(np.float32)
    want = _cv_kmeans(z, 4, 0)
    np.testing.assert_array_equal(cs.kmeans_pp(z, 4, rng=cs.OpenCVRNG(0), device="cpu"), want)
    np.testing.assert_array_equal(cs.kmeans_pp(z, 4, rng=cs.OpenCVRNG(), device="cpu"), want)


@pytest.mark.parametrize("k", [3, 8])
@pytest.mark.parametrize("seed", [1, 12345])
def test_kmeans_matches_cv2(frames, k, seed):
    z = cv2.bilateralFilter(frames[1], 9, 50, 50).reshape(-1, 3).astype(np.float32)
    want = _cv_kmeans(z, k, seed)
    got = cs.kmeans_pp(z, k, 10, 1.0, 3, rng=cs.OpenCVRNG(seed), device="cpu")
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)


def test_kmeans_successive_calls_continue_one_stream():
    rng = np.random.default_rng(4)
    zs = [rng.integers(0, 256, (3000, 3)).astype(np.float32) for _ in range(2)]
    cv2.setRNGSeed(7)
    want = [cv2.kmeans(z, 5, None, CRITERIA, 3, cv2.KMEANS_PP_CENTERS)[1].ravel() for z in zs]
    gen = cs.OpenCVRNG(7)
    for z, w in zip(zs, want):
        np.testing.assert_array_equal(cs.kmeans_pp(z, 5, rng=gen, device="cpu"), w)


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_kmeans_empty_cluster_repair_matches_cv2(monkeypatch, seed):
    """Seven distinct colours (four of 50 copies each) into 8 clusters: the
    seeding picks a duplicate, a cluster comes out empty, and OpenCV moves
    the largest cluster's farthest point into it."""
    rng = np.random.default_rng(3)
    z = np.concatenate([np.repeat(rng.integers(0, 256, (4, 3)), 50, axis=0),
                        rng.integers(0, 256, (3, 3))]).astype(np.float32)
    rng.shuffle(z)
    repairs = []
    update = cs._update_centers

    def counted(zh, labels, k):
        repairs.append(int((np.bincount(labels, minlength=k) == 0).sum()))
        return update(zh, labels, k)

    monkeypatch.setattr(cs, "_update_centers", counted)
    got = cs.kmeans_pp(z, 8, rng=cs.OpenCVRNG(seed), device="cpu")
    assert sum(repairs) > 0
    np.testing.assert_array_equal(got, _cv_kmeans(z, 8, seed))


def test_connected_components_matches_cv2():
    rng = np.random.default_rng(5)
    masks = [(rng.random((40, 50)) < p).astype(np.uint8) for p in (0.2, 0.4, 0.55) * 20]
    masks.append((rng.random((128, 96)) < 0.45).astype(np.uint8))
    masks.append(np.zeros((6, 7), np.uint8))
    for m in masks:
        num, lab = cv2.connectedComponents(m)
        got_num, got = cs.connected_components(m)
        assert got_num == num and got.dtype == np.int32
        np.testing.assert_array_equal(got, lab)


def test_connected_components_number_by_first_block():
    """A pixel at (1, 0) and one at (0, 5) share block row 0: the one in
    block column 0 is component 1, though the other comes first in raster
    order; likewise (3, 2) before (2, 6) in block row 1."""
    m = np.zeros((5, 9), np.uint8)
    m[1, 0] = m[0, 5] = m[3, 2] = m[2, 6] = 1
    num, lab = cs.connected_components(m)
    assert num == 5
    assert (lab[1, 0], lab[0, 5], lab[3, 2], lab[2, 6]) == (1, 2, 3, 4)
    np.testing.assert_array_equal(lab, cv2.connectedComponents(m)[1])


@pytest.mark.parametrize("n_colors,min_area,seed", [(8, 200, 0), (3, 50, 11)])
def test_classic_instance_masks_match_jax(frames, n_colors, min_area, seed):
    from gaussiangrasper_tpu.scripts import segment as jseg

    for img in frames:
        cv2.setRNGSeed(seed)
        want = jseg.classic_instance_masks(img, n_colors, min_area)
        got = tseg.classic_instance_masks(img, n_colors, min_area, rng=cs.OpenCVRNG(seed),
                                          device="cpu")
        assert got.dtype == np.int32 and got.max() >= 1
        np.testing.assert_array_equal(got, want)


def test_main_matches_jax(frames, tmp_path, monkeypatch, capsys):
    """Both CLIs on a two-image capture from a fresh generator: the same
    .npy files and the same lines."""
    from gaussiangrasper_tpu.scripts import segment as jseg

    dirs = []
    for name in ("jax", "port"):
        d = tmp_path / name
        (d / "images").mkdir(parents=True)
        for i, img in enumerate(frames):
            Image.fromarray(img).save(d / "images" / f"frame_{i:05d}.png")
        dirs.append(d)
    cv2.setRNGSeed(0)  # a fresh thread's state, 0xffffffff
    jseg.main(["--data", str(dirs[0])])
    jax_out = capsys.readouterr().out
    monkeypatch.setattr(cs, "DEFAULT_RNG", cs.OpenCVRNG())
    tseg.main(["--data", str(dirs[1]), "--device", "cpu"])
    assert capsys.readouterr().out == jax_out
    for sub in ("masks", "boundary_mask"):
        names = sorted(p.name for p in (dirs[0] / sub).iterdir())
        assert names == sorted(p.name for p in (dirs[1] / sub).iterdir()) and len(names) == 2
        for n in names:
            a, b = np.load(dirs[0] / sub / n), np.load(dirs[1] / sub / n)
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(b, a)


def _sam_stub(h, w):
    """transformers' SamModel / SamProcessor interface over fixed outputs:
    overlapping masks with distinct first scores, one under min_area."""
    import torch

    n_points = len(np.mgrid[0:h:max(h // 8, 1), 0:w:max(w // 8, 1)][0].ravel())
    pred = torch.zeros((1, n_points, 3, h, w))
    scores = torch.zeros((1, n_points, 3))
    pred[0, 0, 0, :, : w // 2] = 5.0   # left half, best score: drawn last
    scores[0, 0, 0] = 0.9
    pred[0, 1, 0, :2, :2] = 5.0        # under min_area
    scores[0, 1, 0] = 0.5
    pred[0, 2, 0, h // 4:, w // 4:] = 5.0  # overlaps the left half, lower score
    scores[0, 2, 0] = 0.7
    scores[0, 2, 1] = 0.99             # not the first score: ignored
    pred[0, 3, 0, : h // 3, 3 * w // 4:] = 5.0
    scores[0, 3, 0] = 0.1

    class Out:
        pred_masks, iou_scores = pred, scores

    class Model:
        def __call__(self, **inputs):
            return Out()

    class ImageProcessor:
        def post_process_masks(self, masks, orig, reshaped):
            return [masks[0] > 0]

    class Processor:
        image_processor = ImageProcessor()

        def __call__(self, img, input_points, return_tensors):
            assert len(input_points[0]) == n_points
            return {"original_sizes": torch.tensor([[h, w]]),
                    "reshaped_input_sizes": torch.tensor([[h, w]])}

    return Model(), Processor()


def _port_sam_stub(h, w):
    """The same fixed outputs behind the port's SamModel / SamProcessor
    interface (masks already at the image's size)."""
    model, processor = _sam_stub(h, w)
    out = model()

    class Model:
        def __call__(self, pixel_values, input_points):
            return out.pred_masks, out.iou_scores

    class Processor:
        def __call__(self, img, points, device):
            assert len(points) == out.pred_masks.shape[1]
            return {"pixel_values": None, "input_points": None,
                    "original_sizes": torch.tensor([[h, w]]),
                    "reshaped_input_sizes": torch.tensor([[h, w]])}

        def post_process_masks(self, masks, orig, reshaped):
            return [masks[0] > 0]

    return Model(), Processor()


def test_sam_glue_matches_jax():
    from gaussiangrasper_tpu.scripts import segment as jseg

    h, w = 32, 48
    img = np.zeros((h, w, 3), np.uint8)
    want = jseg.sam_instance_masks(img, "stub", 50, *_sam_stub(h, w))
    got = tseg.sam_instance_masks(img, "stub", 50, *_port_sam_stub(h, w), device="cpu")
    assert set(np.unique(got)) == {-1, 0, 1, 2}
    np.testing.assert_array_equal(got, want)


def test_sam_backend_without_transformers_exits_with_jax_message(frames, tmp_path, monkeypatch):
    from gaussiangrasper_tpu.scripts import segment as jseg

    (tmp_path / "images").mkdir()
    Image.fromarray(frames[0]).save(tmp_path / "images" / "a.png")
    monkeypatch.setitem(sys.modules, "transformers", None)  # import fails, nothing fetched
    monkeypatch.setenv("HF_HUB_CACHE", str(tmp_path / "hub"))  # the port finds no snapshot
    monkeypatch.delenv("HF_HOME", raising=False)
    monkeypatch.setenv("HOME", str(tmp_path))
    messages = []
    for seg, extra in ((jseg, []), (tseg, ["--device", "cpu"])):
        with pytest.raises(SystemExit) as e:
            seg.main(["--data", str(tmp_path), "--backend", "sam", *extra])
        messages.append(str(e.value))
    assert messages[0].startswith("SAM backend unavailable (ModuleNotFoundError")
    tail = "; use --backend classic or pre-cache the weights"
    assert messages[0].endswith(tail) and messages[1].endswith(tail)
    assert messages[1].startswith("SAM backend unavailable (SnapshotNotFound: no snapshot of "
                                  f"facebook/sam-vit-base at {tmp_path / 'hub'}")
