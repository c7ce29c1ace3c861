"""The port's CUDA kernels against their plain PyTorch versions, on a card.

These tests need a CUDA card and skip elsewhere. They import neither JAX
nor the JAX package, so they run on a machine that has only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu.py -q

(`--noconftest`: tests/conftest.py configures JAX.) chip_smoke.py holds the
same kernels to the same bounds at full width.
"""

import numpy as np
import pytest
import torch

from gaussiangrasper_torch.core.cameras import Camera
from gaussiangrasper_torch.models.gaussian_field import init_random, random_draws
from gaussiangrasper_torch.models.model import GaussianSplatConfig, render, render_inputs
from gaussiangrasper_torch.ops import rasterize_cuda as rc
from gaussiangrasper_torch.ops.rasterize import bin_gaussians

W, H, STEP = 128, 96, 4000


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _scene(device, n=3000, opacity=0.1):
    field, alive = init_random(random_draws(np.random.default_rng(0), n), extent=2.0,
                               init_scale=0.05, init_opacity=opacity, device=device)
    field = field._replace(means=field.means + torch.tensor([0.0, 0.0, -3.0], device=device))
    cam = Camera.create(150.0, 150.0, W / 2, H / 2, np.eye(4, dtype=np.float32)[:3], W, H,
                        device=device)
    return field, alive, cam


@pytest.mark.gpu
@pytest.mark.parametrize("opacity", [0.1, 0.95])  # 0.95 saturates: the cut engages
@pytest.mark.parametrize("channels", rc.KERNEL_CHANNELS)
def test_k1_kernel_matches_plain(cuda_device, channels, opacity):
    field, alive, cam = _scene(cuda_device, opacity=opacity)
    cfg = GaussianSplatConfig()
    proj, colors, opac, bg = render_inputs(field, alive, cam, STEP, cfg)
    bins = bin_gaussians(proj, W, H, cfg.raster, opacities=opac)
    starts, counts = rc.stream_bounds(bins.pair_gidx, bins.pair_starts, bins.tile_count,
                                      cfg.raster.max_gaussians_per_tile)
    args = (bins.pair_gidx.contiguous(), starts, counts,
            rc.pack_attrs(proj.xys, proj.conics, opac, colors[:, :channels]),
            bg[:channels].contiguous(), -(-W // 32), 32)
    before = rc.composite_pairs_fwd.launches
    got = rc.composite_pairs_fwd(*args)
    want = rc.composite_pairs_fwd_plain(*args)
    torch.cuda.synchronize()
    assert rc.composite_pairs_fwd.launches == before + 1
    for name, a, b in zip(("out", "alpha", "logt"), got, want):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=0, msg=name)
    torch.testing.assert_close(got[3], want[3], atol=0, rtol=0)
    if opacity > 0.5:
        assert (got[3] < counts[:, None].float()).any()  # some pixel was cut


@pytest.mark.gpu
def test_render_on_card_matches_cpu(cuda_device):
    cfg = GaussianSplatConfig()
    with torch.no_grad():
        gpu = render(*_scene(cuda_device), STEP, cfg)
        cpu = render(*_scene("cpu"), STEP, cfg)
    for k in ("rgb", "feature", "depth", "normal", "alpha"):
        torch.testing.assert_close(gpu[k].cpu(), cpu[k], atol=1e-4, rtol=1e-4, msg=k)


@pytest.mark.gpu
def test_cuda_tensor_with_unsupported_channels_raises(cuda_device):
    x = torch.zeros(1, 6 + 5, device=cuda_device)
    one = torch.ones(1, dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError, match="built for C"):
        rc.composite_pairs_fwd(one - 1, one - 1, one, x, torch.zeros(5, device=cuda_device), 1, 32)
