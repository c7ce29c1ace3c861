"""The port's CUDA kernels against their plain PyTorch versions, on a card.

These tests need a CUDA card and skip elsewhere. They import neither JAX
nor the JAX package, so they run on a machine that has only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu.py -q

(`--noconftest`: tests/conftest.py configures JAX.) chip_smoke.py holds the
same kernels to the same bounds at full width.
"""

import dataclasses

import numpy as np
import pytest
import torch

from gaussiangrasper_torch.core.cameras import Camera
from gaussiangrasper_torch.engine import optimizers as optim
from gaussiangrasper_torch.engine.train_state import init_train_state, train_step
from gaussiangrasper_torch.models.efd import FeaUp
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


def _k1_args(device, channels, opacity):
    field, alive, cam = _scene(device, opacity=opacity)
    cfg = GaussianSplatConfig()
    proj, colors, opac, bg = render_inputs(field, alive, cam, STEP, cfg)
    bins = bin_gaussians(proj, W, H, cfg.raster, opacities=opac)
    starts, counts = rc.stream_bounds(bins.pair_gidx, bins.pair_starts, bins.tile_count,
                                      cfg.raster.max_gaussians_per_tile)
    return (bins.pair_gidx.contiguous(), starts, counts,
            rc.pack_attrs(proj.xys, proj.conics, opac, colors[:, :channels]),
            bg[:channels].contiguous(), -(-W // 32), 32)


@pytest.mark.gpu
@pytest.mark.parametrize("opacity", [0.1, 0.95])  # 0.95 saturates: the cut engages
@pytest.mark.parametrize("channels", rc.KERNEL_CHANNELS)
def test_k1_kernel_matches_plain(cuda_device, channels, opacity):
    args = _k1_args(cuda_device, channels, opacity)
    counts = args[2]
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
@pytest.mark.parametrize("opacity", [0.1, 0.95])
@pytest.mark.parametrize("channels", rc.KERNEL_CHANNELS)
def test_k2_kernel_matches_plain(cuda_device, channels, opacity):
    """Per-Gaussian sums of K2's rows against the plain version, each column
    group within 1e-4 of its max |value| (float atomics sum in another order)."""
    args = _k1_args(cuda_device, channels, opacity)
    _, alpha, logt, ncomp = rc.composite_pairs_fwd(*args)
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    g_out = torch.randn(*alpha.shape, channels, generator=gen, device=cuda_device)
    g_alpha = torch.randn(alpha.shape, generator=gen, device=cuda_device)
    bargs = args[:5] + (g_out, g_alpha, logt, ncomp) + args[5:]
    before = rc.composite_pairs_bwd.launches
    got = rc.composite_pairs_bwd(*bargs)
    want = rc.composite_pairs_bwd_plain(*bargs)
    torch.cuda.synchronize()
    assert rc.composite_pairs_bwd.launches == before + 1
    n = args[3].shape[0]
    gidx = args[0].long()
    got = torch.zeros(n, 6 + channels, device=cuda_device).index_add_(0, gidx, got)
    want = torch.zeros(n, 6 + channels, device=cuda_device).index_add_(0, gidx, want)
    for lo, hi in ((0, 2), (2, 5), (5, 6), (6, 6 + channels)):
        scale = float(want[:, lo:hi].abs().max())
        assert scale > 0
        assert float((got[:, lo:hi] - want[:, lo:hi]).abs().max()) <= 1e-4 * scale, (lo, hi)


@pytest.mark.gpu
def test_train_step_on_card_matches_cpu(cuda_device):
    """One train step on the card against the CPU path: losses within 1e-3
    relative, parameters within 2 lr of their group (Adam with eps 1e-15
    moves near-zero-gradient entries by +-lr on a sign rounding can flip)."""
    cfg = GaussianSplatConfig()
    rng = np.random.default_rng(1)
    batch = {
        "image": rng.random((H, W, 3), np.float32), "depth": np.full((H, W), 3.0, np.float32),
        "normal": np.tile(np.array([0.0, 0.0, 1.0], np.float32), (H, W, 1)),
        "valid_mask": rng.random((H, W)) > 0.1,
        "pair_a": rng.integers(0, H, (4, 16, 2)).astype(np.int32),
        "pair_b": rng.integers(0, H, (4, 16, 2)).astype(np.int32),
        "pair_valid": np.ones((4, 16), bool), "group_valid": np.ones(4, bool),
        "points": rng.integers(0, H, (32, 2)).astype(np.int32), "point_valid": np.ones(32, bool),
        "gt_clip": rng.standard_normal((32, 512)).astype(np.float32),
    }
    fea = {k: v.detach() for k, v in FeaUp().state_dict().items()}
    out = {}
    for dev in (cuda_device, torch.device("cpu")):
        field, alive, cam = _scene(dev)
        state = init_train_state(field, alive, {k: v.to(dev) for k, v in fea.items()})
        state = dataclasses.replace(state, step=STEP + 9)
        out[dev.type] = train_step(state, cam, {k: torch.as_tensor(v, device=dev)
                                                for k, v in batch.items()}, cfg)
    (gs, gm), (cs, cm) = out["cuda"], out["cpu"]
    for k, v in cm.items():
        torch.testing.assert_close(gm[k].cpu().float(), v.float(), atol=1e-5, rtol=1e-3, msg=k)
    for leaf, group in optim.FIELD_GROUP_OF.items():
        lim = 2.0 * optim.DEFAULT_GROUPS[group].lr_init
        torch.testing.assert_close(getattr(gs.field, leaf).cpu(), getattr(cs.field, leaf),
                                   atol=lim, rtol=0, msg=leaf)


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
