"""The grasp request's voxel labelling on the host (`ops/voxel_cluster.py`)
against `scipy.ndimage.label` with a 3x3x3 structure, on seeded layouts:
blobs with strays, two multi-voxel components of equal point count in both
raster orders, points exactly on voxel faces, float32 and float64 points.

Each voxel's root is the index of the first voxel, in raster order, of its
scipy component (scipy numbers components in that order), and
`grasp.largest_cluster` is the reference's mask: the largest component by
points, ties to scipy's lowest label. `voxel_cluster.voxel_keys`, the
port's axis-major voxelization, equals the row-major reference here bit
for bit. On the CPU the kernels' counter stays at 0. The layouts are shared with the card's cases in
tests/test_torch_gpu.py, so this file imports no JAX.
"""

import numpy as np
import pytest
import torch
from scipy import ndimage

from gaussiangrasper_torch.ops import voxel_cluster as vc
from gaussiangrasper_torch.scripts import grasp
from gaussiangrasper_torch.utils.profiler import PROFILER


def _component_points(rng, voxels, per_voxel, voxel):
    """`per_voxel` points inside each of `voxels` (integer coordinates), off
    its faces."""
    v = np.repeat(np.asarray(voxels, np.float64), per_voxel, axis=0)
    return (v + rng.uniform(0.2, 0.8, v.shape)) * voxel


def layout(name: str):
    """(points (N, 3) float64, voxel) of a named layout."""
    rng = np.random.default_rng(sum(map(ord, name)))
    if name == "blobs":
        return np.concatenate([rng.normal(0.0, 0.1, (900, 3)), rng.normal(0.6, 0.05, (400, 3)),
                               rng.uniform(-1.0, 1.0, (300, 3))]), 0.04
    if name.startswith("tie"):
        # a line of 6 voxels along x and one of 4 along z, 12 points each: equal counts.
        # "tie_long_first" puts the long line's lowest voxel first in raster order, with the
        # short line's voxels between its own (a root left at a component's last voxel would
        # hand the tie to the short line); "tie_short_first" the short line's
        x0, xs = (0, 2) if name == "tie_long_first" else (1, 0)
        long = [(x0 + i, 0, 0) for i in range(6)]
        short = [(xs, 3, z) for z in range(4)]
        pts = np.concatenate([_component_points(rng, long, 2, 0.05),
                              _component_points(rng, short, 3, 0.05)])
        return pts[rng.permutation(len(pts))], 0.05
    if name == "faces":
        # coordinates k * voxel, where floor(k * voxel / voxel) may land on either side
        k = rng.integers(-12, 13, (600, 3))
        return np.concatenate([k * 0.1, rng.normal(0.0, 0.2, (200, 3))]), 0.1
    raise KeyError(name)


LAYOUTS = ["blobs", "tie_long_first", "tie_short_first", "faces"]


def voxel_keys(points: np.ndarray, voxel: float):
    """(keys, inverse, dims) as `grasp.largest_cluster` voxelizes the points."""
    idx = np.floor(points / voxel).astype(np.int64)
    idx -= idx.min(0)
    dims = idx.max(0) + 1
    keys, inverse = np.unique(np.ravel_multi_index(idx.T, dims), return_inverse=True)
    return keys, inverse, dims


def scipy_labels(points: np.ndarray, voxel: float):
    """(each point's scipy label, each occupied voxel's label)."""
    idx = np.floor(points / voxel).astype(np.int64)
    idx -= idx.min(0)
    grid = np.zeros(idx.max(0) + 1, bool)
    grid[tuple(idx.T)] = True
    labels, _ = ndimage.label(grid, structure=np.ones((3, 3, 3), int))
    keys, _, _ = voxel_keys(points, voxel)
    return labels[tuple(idx.T)], labels.reshape(-1)[keys]


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("name", LAYOUTS)
def test_host_roots_are_scipy_components_first_voxels(name, dtype):
    points, voxel = layout(name)
    points = points.astype(dtype)
    keys, _, dims = voxel_keys(points, voxel)
    _, of_voxel = scipy_labels(points, voxel)
    first = {}
    for i, lab in enumerate(of_voxel):
        first.setdefault(lab, i)
    assert list(first) == sorted(first)  # scipy numbers components in raster order
    roots = vc.roots_host(keys, dims)
    np.testing.assert_array_equal(roots, [first[lab] for lab in of_voxel])
    assert 1 < len(first) < len(keys)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("name", LAYOUTS)
def test_largest_cluster_is_scipys_largest(name, dtype):
    points, voxel = layout(name)
    points = points.astype(dtype)
    of_point, _ = scipy_labels(points, voxel)
    sizes = np.bincount(of_point)
    sizes[0] = 0
    want = of_point == np.argmax(sizes)
    got = grasp.largest_cluster(points, voxel)
    assert got.dtype == bool
    np.testing.assert_array_equal(got, want)
    if name.startswith("tie"):
        # 12 points each: the first component in raster order wins, the long line (6
        # voxels) or the short one (4)
        assert got.sum() == 12 and sorted(sizes)[-2:] == [12, 12]
        voxels = np.unique(np.floor(points[got] / voxel), axis=0)
        assert len(voxels) == (6 if name == "tie_long_first" else 4)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("name", LAYOUTS)
def test_voxel_keys_equal_the_reference(name, dtype):
    """The port's axis-major voxelization against the row-major one above:
    the same keys, inverse and dims, bit for bit."""
    points, voxel = layout(name)
    points = points.astype(dtype)
    got, want = vc.voxel_keys(points, voxel), voxel_keys(points, voxel)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert got[0].dtype == np.int64


@pytest.mark.parametrize("case", ["empty", "two_columns", "integer"])
def test_voxel_keys_rejects_bad_points(case):
    points = {"empty": np.zeros((0, 3)), "two_columns": np.zeros((4, 2)),
              "integer": np.zeros((4, 3), np.int64)}[case]
    with pytest.raises(ValueError):
        vc.voxel_keys(points, 0.02)


def test_cpu_counts_no_kernel_voxels():
    points, voxel = layout("blobs")
    PROFILER.reset()
    try:
        with torch.profiler.profile():
            grasp.largest_cluster(points, voxel)
        assert PROFILER.counter("grasp/voxels") == len(voxel_keys(points, voxel)[0])
        assert PROFILER.counter("grasp/voxels_kernel") == 0
    finally:
        PROFILER.reset()


@pytest.mark.parametrize("case", ["unsorted", "repeated", "int32", "outside", "dims",
                                  "inverse_range", "inverse_dtype"])
def test_largest_component_rejects_bad_inputs(case):
    keys, inverse, dims = np.array([1, 5, 9], np.int64), np.array([0, 2, 1, 1]), (2, 2, 3)
    if case == "unsorted":
        keys = keys[[0, 2, 1]]
    elif case == "repeated":
        keys = np.array([1, 5, 5], np.int64)
    elif case == "int32":
        keys = keys.astype(np.int32)
    elif case == "outside":
        keys = np.array([1, 5, 12], np.int64)
    elif case == "dims":
        dims = (2, 0, 3)
    elif case == "inverse_range":
        inverse = np.array([0, 3])
    else:
        inverse = inverse.astype(np.int32)
    with pytest.raises(ValueError):
        vc.largest_component(keys, inverse, dims)


def test_largest_cluster_of_no_points():
    assert grasp.largest_cluster(np.zeros((0, 3)), 0.02).shape == (0,)
