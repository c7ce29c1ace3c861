"""`ops/pixel_gather.gather_pixels` on the CPU: its dispatch (the plain
advanced index on the CPU, the kernels' dtype check where the rule says
cuda, a raise for another device), the row counters, and the kernels'
wrappers' checks, which run before any launch. tests/test_torch_gpu.py
holds the kernels against the plain path on a card: efd-train-800's
padded batch, seeded rows with hot pixels, F 32, 6 and 3, an empty
gather."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from gaussiangrasper_torch.ops import pixel_gather as pg
from gaussiangrasper_torch.utils.profiler import PROFILER


def strided_case():
    """A (48, 64, 39) image, its channels [3, 35) as the map (the composited
    image's feature slice: pixel stride 39), and 3000 seeded int32 pixels."""
    gen = torch.Generator().manual_seed(7)
    img = torch.rand(48, 64, 39, generator=gen)
    idx = torch.stack([torch.randint(0, 48, (3000,), generator=gen),
                       torch.randint(0, 64, (3000,), generator=gen)], 1).to(torch.int32)
    return img, idx


def test_plain_path_equals_the_advanced_index():
    """The CPU's dispatch: the wrapper runs the plain advanced index, forward
    and gradient (one thread, so index_put sums a pixel's rows in one
    order)."""
    img, idx = strided_case()
    g_out = torch.randn(idx.shape[0], 32, generator=torch.Generator().manual_seed(9))
    outs = {}
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        for path in ("wrapper", "index"):
            leaf = img.clone().requires_grad_(True)
            fea = leaf[..., 3:35]
            out = pg.gather_pixels(fea, idx) if path == "wrapper" else fea[idx[:, 0], idx[:, 1]]
            (grad,) = torch.autograd.grad(out, leaf, g_out)
            outs[path] = (out.detach(), grad)
    finally:
        torch.set_num_threads(prev)
    (o, g), (o_want, g_want) = outs["wrapper"], outs["index"]
    assert torch.equal(o, o_want) and torch.equal(g, g_want)


def test_device_rule_raises_for_another_device():
    fea = torch.zeros(4, 4, 3, device="meta")
    idx = torch.zeros(2, 2, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="gather_pixels"):
        pg.gather_pixels(fea, idx)


def test_kernel_path_raises_for_a_map_not_float32(monkeypatch):
    """The device alone picks the kernels: a float64 map where the rule says
    cuda reaches the kernels' check and raises before any launch, where it
    would otherwise fall back to the plain index."""
    monkeypatch.setattr(pg, "use_kernel", lambda device, name: True)
    fea = torch.zeros(4, 5, 3, dtype=torch.float64)
    with pytest.raises(ValueError, match="float32"):
        pg.gather_pixels(fea, torch.zeros(2, 2, dtype=torch.int32))


def test_float64_and_int64_take_the_plain_path():
    gen = torch.Generator().manual_seed(4)
    fea = torch.rand(8, 9, 5, dtype=torch.float64, generator=gen)
    idx = torch.tensor([[0, 0], [7, 8], [-1, -2], [0, 0]])
    assert torch.equal(pg.gather_pixels(fea, idx), fea[idx[:, 0], idx[:, 1]])


def test_counters_count_rows_only_while_the_spans_are_on():
    img, idx = strided_case()
    fea = img[..., 3:35]
    PROFILER.reset()
    try:
        pg.gather_pixels(fea, idx)
        assert PROFILER.counter("efd/gather_rows") == 0
        with torch.profiler.profile():
            pg.gather_pixels(fea, idx)
            pg.gather_pixels(fea, idx[:10])
        assert PROFILER.counter("efd/gather_rows") == idx.shape[0] + 10
        assert PROFILER.counter("efd/gather_rows_kernel") == 0  # CPU tensors: the plain path
        pg.gather_pixels(fea, idx)
        assert PROFILER.counter("efd/gather_rows") == idx.shape[0] + 10
    finally:
        PROFILER.reset()


def test_train_loss_counts_its_fused_gather():
    """`train_loss` reads its 2 G P + S rows in one call, counted in
    `efd/gather_rows` while a profiler records."""
    PROFILER.reset()
    try:
        with torch.profiler.profile():
            _one_train_loss()
        assert PROFILER.counter("efd/gather_rows") == 2 * 2 * 4 + 6
        assert PROFILER.counter("efd/gather_rows_kernel") == 0
    finally:
        PROFILER.reset()


def _one_train_loss():
    from gaussiangrasper_torch.core.cameras import Camera
    from gaussiangrasper_torch.models.efd import FeaUp
    from gaussiangrasper_torch.models.gaussian_field import init_random, random_draws
    from gaussiangrasper_torch.models.model import GaussianSplatConfig, train_loss
    from gaussiangrasper_torch.ops.rasterize import RasterizeConfig

    w, h = 32, 24
    cfg = GaussianSplatConfig(feature_dim=8, raster=RasterizeConfig(tile_size=16,
                                                                    max_gaussians_per_tile=256))
    field, alive = init_random(random_draws(np.random.default_rng(0), 200, feature_dim=8),
                               extent=1.0, init_scale=0.05, init_opacity=0.3)
    field = field._replace(means=field.means + torch.tensor([0.0, 0.0, -3.0]))
    cam = Camera.create(40.0, 40.0, w / 2, h / 2, np.eye(4, dtype=np.float32)[:3], w, h)
    rng = np.random.default_rng(1)
    batch = {
        "image": rng.random((h, w, 3), np.float32), "depth": np.full((h, w), 3.0, np.float32),
        "normal": np.tile(np.array([0.0, 0.0, 1.0], np.float32), (h, w, 1)),
        "valid_mask": np.ones((h, w), bool),
        "pair_a": rng.integers(0, h, (2, 4, 2)).astype(np.int32),
        "pair_b": rng.integers(0, h, (2, 4, 2)).astype(np.int32),
        "pair_valid": np.ones((2, 4), bool), "group_valid": np.ones(2, bool),
        "points": rng.integers(0, h, (6, 2)).astype(np.int32), "point_valid": np.ones(6, bool),
        "gt_clip": rng.standard_normal((6, 512)).astype(np.float32),
    }
    batch = {k: torch.as_tensor(v) for k, v in batch.items()}
    fea_up = {k: v.detach() for k, v in FeaUp(in_dim=8).state_dict().items()}
    state = {"field": field, "fea_up": fea_up}
    total, _ = train_loss(state, alive, cam, batch, 4000, cfg)
    assert torch.isfinite(total)


def test_kernel_wrappers_check_before_any_launch():
    fea = torch.zeros(4, 5, 3)
    with pytest.raises(ValueError, match="int32"):
        pg.pixel_gather_fwd_cuda(fea, torch.zeros(2, 2, dtype=torch.int64))
    with pytest.raises(ValueError, match="float32"):
        pg.pixel_gather_fwd_cuda(fea.double(), torch.zeros(2, 2, dtype=torch.int32))
    with pytest.raises(ValueError, match=r"\(N, 2\)"):
        pg.pixel_gather_fwd_cuda(fea, torch.zeros(2, 3, dtype=torch.int32))
    with pytest.raises(ValueError, match="g_out"):
        pg.pixel_gather_bwd_cuda(torch.zeros(2, 2, dtype=torch.int32), torch.zeros(3, 3), 4, 5)
    # nothing to gather: no launch, so these run on the CPU
    assert pg.pixel_gather_fwd_cuda(fea, torch.zeros(0, 2, dtype=torch.int32)).shape == (0, 3)
    g = pg.pixel_gather_bwd_cuda(torch.zeros(0, 2, dtype=torch.int32), torch.zeros(0, 3), 4, 5)
    assert g.shape == (4, 5, 3) and not g.any()
