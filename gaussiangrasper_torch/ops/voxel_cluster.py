"""26-connected components of occupied voxels: the labelling behind the grasp
request's largest cluster (`scripts/grasp.largest_cluster`).

`voxel_keys` voxelizes the points on the host. The voxels come as their linear keys in C order of a grid `dims` (int64,
strictly increasing, as `np.unique` gives them). Each voxel's root is the
index, into the keys, of the lowest voxel of its component in raster
order: the component that `scipy.ndimage.label` (3x3x3 structure) numbers
first has the smallest root. Two paths give these roots, equal entry for
entry:

- `roots_cuda`: the kernels of `csrc/voxel_cluster.cu` on keys on the card
  (a lock-free union-find, one thread a voxel and forward neighbour);
- `roots_host`: the union-find on the host, in Python, each link taking
  the larger root under the smaller.

`largest_component` picks the path by device as the port's default does:
the kernels where a card is present, else the host. While the port's
spans are on, it counts the voxels the kernels label in
`grasp/voxels_kernel`."""

from __future__ import annotations

import ctypes
from typing import Sequence

import numpy as np
import torch

from gaussiangrasper_torch._build import launch
from gaussiangrasper_torch.utils.profiler import PROFILER

_MAX_VOXELS = 2 ** 31 - 256  # the kernels index voxels, and count blocks, by int


def voxel_keys(points: np.ndarray, voxel: float) -> tuple:
    """(keys, inverse, dims) of the points' occupied voxels:
    `np.floor(points / voxel)` in the points' own dtype, shifted so that each
    axis starts at 0, the int64 linear keys in C order of the grid `dims`,
    sorted and unique, and each point's index into them."""
    if points.ndim != 2 or points.shape[1] != 3 or len(points) == 0 \
            or points.dtype.kind != "f":
        raise ValueError(f"voxel_keys takes (N >= 1, 3) float points; got {points.dtype} "
                         f"of shape {points.shape}")
    # axis-major (3, N), so that the per-axis min and max reduce contiguous rows
    idx = np.floor(np.ascontiguousarray(points.T) / voxel).astype(np.int64)
    idx -= idx.min(1, keepdims=True)
    dims = idx.max(1) + 1
    keys, inverse = np.unique(np.ravel_multi_index(idx, dims), return_inverse=True)
    return keys, inverse, dims


def _dims(keys, dims: Sequence[int]) -> tuple:
    """(d0, d1, d2) as ints, after checking what both paths take: 1-d int64
    keys, at most _MAX_VOXELS of them, and a grid of at most 2^63 - 1 cells."""
    dims = tuple(int(d) for d in dims)
    if len(dims) != 3 or min(dims) < 1 or np.prod(dims, dtype=object) > np.iinfo(np.int64).max \
            or keys.ndim != 1 or keys.dtype not in (np.int64, torch.int64) \
            or keys.shape[0] > _MAX_VOXELS:
        raise ValueError(f"voxel keys are 1-d int64 linear indices (at most {_MAX_VOXELS}) into "
                         f"a 3-d grid of at most 2^63 - 1 cells; got {keys.dtype} keys of shape "
                         f"{tuple(keys.shape)}, dims {dims}")
    return dims


def _check_keys(keys: np.ndarray, dims: Sequence[int]) -> tuple:
    """`_dims`, and the keys strictly increasing inside the grid, on the host."""
    dims = _dims(keys, dims)
    if len(keys) and (keys[0] < 0 or keys[-1] >= np.prod(dims, dtype=object)
                      or not (np.diff(keys) > 0).all()):
        raise ValueError(f"voxel keys are strictly increasing and inside the grid {dims}; got "
                         f"{len(keys)} keys in [{keys.min()}, {keys.max()}]")
    return dims


def roots_host(keys: np.ndarray, dims: Sequence[int]) -> np.ndarray:
    """Each voxel's root (int64), by a union-find on the host."""
    dims = _check_keys(keys, dims)
    parent = np.arange(len(keys))

    def find(a):
        while parent[a] != a:
            parent[a] = parent[parent[a]]
            a = parent[a]
        return a

    occ3 = np.stack(np.unravel_index(keys, dims), -1)
    occ_set = {tuple(v): i for i, v in enumerate(occ3)}
    for i, v in enumerate(occ3):
        for dz in (-1, 0, 1):
            for dy in (-1, 0, 1):
                for dx in (-1, 0, 1):
                    if dx == dy == dz == 0:
                        continue
                    j = occ_set.get((v[0] + dx, v[1] + dy, v[2] + dz))
                    if j is not None:
                        ra, rb = find(i), find(j)
                        if ra != rb:
                            parent[max(ra, rb)] = min(ra, rb)
    return np.array([find(i) for i in range(len(keys))], dtype=np.int64)


def roots_cuda(keys: torch.Tensor, dims: Sequence[int]) -> torch.Tensor:
    """Each voxel's root (int32, on the keys' card), by the kernels. The keys
    are strictly increasing, as `largest_component` checks them on the host
    (keys out of order give wrong roots, never a read out of bounds)."""
    if not (keys.is_cuda and keys.is_contiguous()):
        raise ValueError(f"roots_cuda takes contiguous keys on a card; got {keys.device}")
    d0, d1, d2 = _dims(keys, dims)
    n = keys.shape[0]
    scratch = torch.empty(2, n, dtype=torch.int32, device=keys.device)
    if n == 0:
        return scratch[1]
    launch("voxel_cluster", "ggt_voxel_cluster",
           [ctypes.c_void_p, ctypes.c_int] + [ctypes.c_longlong] * 3 + [ctypes.c_void_p] * 2,
           keys.data_ptr(), n, d0, d1, d2, scratch[0].data_ptr(), scratch[1].data_ptr(),
           device=keys.device)
    return scratch[1]


def largest_component(keys: np.ndarray, inverse: np.ndarray, dims: Sequence[int]) -> np.ndarray:
    """Mask of the points in the largest component, a component's size
    being its count of points; `inverse` maps each point to its voxel's
    index into `keys`. Ties go to the smallest root, the first maximum of
    the sizes."""
    _check_keys(keys, dims)
    inverse = np.asarray(inverse).reshape(-1)
    if inverse.dtype != np.int64 or (len(inverse) and (inverse.min() < 0
                                                       or inverse.max() >= len(keys))):
        raise ValueError(f"inverse is int64 indices into the {len(keys)} keys; got "
                         f"{inverse.dtype} in [{inverse.min(initial=0)}, {inverse.max(initial=0)}]")
    if len(inverse) == 0:
        return np.zeros(0, bool)
    if not torch.cuda.is_available():
        labels = roots_host(keys, dims)[inverse]
        return labels == np.bincount(labels).argmax()
    PROFILER.count("grasp/voxels_kernel", len(keys))
    up = torch.from_numpy(np.concatenate([keys, inverse])).to("cuda")  # one copy up
    labels = roots_cuda(up[:len(keys)], dims)[up[len(keys):]]
    sizes = torch.bincount(labels, minlength=len(keys))
    return (labels == sizes.argmax()).cpu().numpy()
