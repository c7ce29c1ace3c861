"""The port's CUDA kernels against their plain PyTorch versions, on a card.

These tests need a CUDA card and skip elsewhere. They import neither JAX
nor the JAX package, so they run on a machine that has only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu.py -q

(`--noconftest`: tests/conftest.py configures JAX.) chip_smoke.py holds the
same kernels to the same bounds at full width.
"""

import dataclasses
import json
from unittest import mock

import numpy as np
import pytest
import torch

from gaussiangrasper_torch import _build
from gaussiangrasper_torch.core.cameras import Camera
from gaussiangrasper_torch.engine import optimizers as optim
from gaussiangrasper_torch.engine.train_state import init_train_state, train_step
from gaussiangrasper_torch.models.efd import FeaUp
from gaussiangrasper_torch.models.gaussian_field import init_random, random_draws
from gaussiangrasper_torch.models.model import GaussianSplatConfig, render, render_inputs
from gaussiangrasper_torch.ops import rasterize_cuda as rc
from gaussiangrasper_torch.ops.rasterize import RasterizeConfig, bin_gaussians
from gaussiangrasper_torch.probes import kernels as pk

W, H, STEP = 128, 96, 4000
# the compositor kernels' C entries, as the launch counter (`_build.launches`) keys them
K1, K2, K3, K4, K5, K6 = ("ggt_composite_pairs_fwd", "ggt_composite_pairs_bwd",
                          "ggt_composite_tables_fwd", "ggt_composite_tables_bwd",
                          "ggt_composite_pairs_fwd2", "ggt_composite_pairs_bwd2")
GATHER = ("ggt_pixel_gather_fwd", "ggt_pixel_gather_bwd")


def launched_since(before, *entries) -> tuple:
    """The launches of each C entry counted since `before`, a copy of
    `_build.launches`."""
    return tuple(_build.launches[e] - before[e] for e in entries)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _scene(device, n=3000, opacity=0.1, w=W, h=H):
    field, alive = init_random(random_draws(np.random.default_rng(0), n), extent=2.0,
                               init_scale=0.05, init_opacity=opacity, device=device)
    field = field._replace(means=field.means + torch.tensor([0.0, 0.0, -3.0], device=device))
    cam = Camera.create(150.0, 150.0, w / 2, h / 2, np.eye(4, dtype=np.float32)[:3], w, h,
                        device=device)
    return field, alive, cam


def _k1_args(device, channels, opacity, w=W, h=H):
    field, alive, cam = _scene(device, opacity=opacity, w=w, h=h)
    cfg = GaussianSplatConfig()
    proj, colors, opac, bg = render_inputs(field, alive, cam, STEP, cfg)
    bins = bin_gaussians(proj, w, h, cfg.raster, opacities=opac, build_table=False,
                         keep_pairs=True)
    starts, counts = rc.stream_bounds(bins.pair_gidx, bins.pair_starts, bins.tile_count,
                                      cfg.raster.max_gaussians_per_tile)
    return (bins.pair_gidx.contiguous(), starts, counts,
            rc.pack_attrs(proj.xys, proj.conics, opac, colors[:, :channels]),
            bg[:channels].contiguous(), -(-w // 32), 32)


def _per_gaussian(args, gpairs):
    return torch.zeros(args[3].shape[0], args[3].shape[1], device=gpairs.device).index_add_(
        0, args[0].long(), gpairs)


def _assert_grads_close(got, want, channels):
    for lo, hi in ((0, 2), (2, 5), (5, 6), (6, 6 + channels)):
        scale = float(want[:, lo:hi].abs().max())
        assert scale > 0
        assert float((got[:, lo:hi] - want[:, lo:hi]).abs().max()) <= 1e-4 * scale, (lo, hi)


@pytest.mark.gpu
@pytest.mark.parametrize("opacity", [0.1, 0.95])  # 0.95 saturates: the cut engages
@pytest.mark.parametrize("channels", rc.KERNEL_CHANNELS)
def test_k1_kernel_matches_plain(cuda_device, channels, opacity):
    args = _k1_args(cuda_device, channels, opacity)
    counts = args[2]
    before = _build.launches.copy()
    got = rc.composite_pairs_fwd(*args)
    want = rc.composite_pairs_fwd_plain(*args)
    torch.cuda.synchronize()
    assert launched_since(before, K1) == (1,)
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
    before = _build.launches.copy()
    got = rc.composite_pairs_bwd(*bargs)
    want = rc.composite_pairs_bwd_plain(*bargs)
    torch.cuda.synchronize()
    assert launched_since(before, K2) == (1,)
    _assert_grads_close(_per_gaussian(args, got), _per_gaussian(args, want), channels)


# counts around K2's 8-row sub-chunks and 32-row batches, one tile each (13 tiles of 32 px,
# 3 a row of the image: an odd count)
STRADDLE_COUNTS = (0, 1, 7, 8, 9, 31, 32, 33, 63, 64, 65, 129, 200)


def _straddle_args(device, channels, opaque, ts=32):
    """A synthetic stream, one row per Gaussian, centred in its tile. With
    `opaque`, splats far wider than a tile at opacity 0.999: every pixel of
    a tile with two rows or more composites its first row and is cut at the
    second."""
    rng = np.random.default_rng(3)
    tw = 3
    rows = []
    for t, n in enumerate(STRADDLE_COUNTS):
        xy = rng.uniform(0, ts, (n, 2)) + ((t % tw) * ts, (t // tw) * ts)
        inv = 1.0 / rng.uniform(*((600.0, 900.0) if opaque else (2.0, 10.0)), (n, 1)) ** 2
        conic = np.concatenate([inv, rng.uniform(-0.2, 0.2, (n, 1)) * inv, inv], 1)
        opac = np.full((n, 1), 0.999) if opaque else rng.uniform(0.02, 0.3, (n, 1))
        rows.append(np.concatenate([xy, conic, opac, rng.uniform(-1, 1, (n, channels))], 1))
    attrs = torch.as_tensor(np.concatenate(rows).astype(np.float32), device=device)
    counts = torch.tensor(STRADDLE_COUNTS, dtype=torch.int32, device=device)
    starts = (torch.cumsum(counts, 0) - counts).int().contiguous()
    gidx = torch.arange(attrs.shape[0], dtype=torch.int32, device=device)
    bg = torch.linspace(0.1, 0.9, channels, device=device)
    return gidx, starts, counts, attrs, bg, tw, ts


def _bwd_args(args, seed):
    """K2's arguments: K1's logt and ncomp on `args`, seeded g_out and g_alpha."""
    _, alpha, logt, ncomp = rc.composite_pairs_fwd(*args)
    gen = torch.Generator(device=alpha.device).manual_seed(seed)
    g_out = torch.randn(*alpha.shape, args[3].shape[1] - 6, generator=gen, device=alpha.device)
    g_alpha = torch.randn(alpha.shape, generator=gen, device=alpha.device)
    return args[:5] + (g_out, g_alpha, logt, ncomp) + args[5:]


@pytest.mark.gpu
@pytest.mark.parametrize("opaque", [False, True])
@pytest.mark.parametrize("channels", rc.KERNEL_CHANNELS)
def test_k2_and_k6_on_counts_around_sub_chunks_and_batches(cuda_device, channels, opaque):
    """K2 and K6 (13 tiles: an odd count) against the plain version, K2's
    criterion, on tiles of 0 to 200 rows; opaque: every walk is one row."""
    bargs = _bwd_args(_straddle_args(cuda_device, channels, opaque), seed=4)
    counts, ncomp = bargs[2], bargs[8]
    if opaque:
        assert bool((ncomp[counts >= 2] == 1).all())
    else:  # some pixel of each tile walks all its rows
        walked = torch.minimum(ncomp, counts[:, None].float()).amax(1)
        assert torch.equal(walked, counts.float())
    before = _build.launches.copy()
    got = rc.composite_pairs_bwd(*bargs)
    got2 = rc.composite_pairs_bwd(*bargs, two_tile=True)
    want = rc.composite_pairs_bwd_plain(*bargs)
    torch.cuda.synchronize()
    assert launched_since(before, K2, K6) == (1, 1)
    _assert_grads_close(got, want, channels)  # one row per Gaussian: rows are the sums
    _assert_grads_close(got2, want, channels)


@pytest.mark.gpu
@pytest.mark.parametrize("channels", rc.KERNEL_CHANNELS)
def test_k4_on_a_table_whose_k_is_not_a_multiple_of_the_sub_chunk(cuda_device, channels):
    """K4 on the straddle tiles packed into a (13, 203, 6 + C) table."""
    gidx, starts, counts, attrs, bg, tw, ts = _straddle_args(cuda_device, channels, False)
    kt = 203
    tables = torch.zeros(counts.shape[0], kt, attrs.shape[1], device=cuda_device)
    for t, (s, n) in enumerate(zip(starts.tolist(), counts.tolist())):
        tables[t, :n] = attrs[s: s + n]
    _, alpha, logt, ncomp = rc.composite_tables_fwd(counts, tables, bg, tw, ts)
    gen = torch.Generator(device=cuda_device).manual_seed(6)
    g_out = torch.randn(*alpha.shape, channels, generator=gen, device=cuda_device)
    g_alpha = torch.randn(alpha.shape, generator=gen, device=cuda_device)
    bargs = (counts, tables, bg, g_out, g_alpha, logt, ncomp, tw, ts)
    before = _build.launches.copy()
    got = rc.composite_tables_bwd(*bargs)
    want = rc.composite_tables_bwd_plain(*bargs)
    torch.cuda.synchronize()
    assert launched_since(before, K4) == (1,)
    _assert_grads_close(got.reshape(-1, attrs.shape[1]), want.reshape(-1, attrs.shape[1]),
                        channels)


@pytest.mark.gpu
@pytest.mark.parametrize("starts", [[13], [0, 3, 77, 1001, 4096 - 128]])
def test_p2_bit_equal_to_plain(cuda_device, starts):
    """P2's pieces at row 0, at offsets not a multiple of 8, at rows - 128."""
    src = torch.randn(4096, 128, generator=torch.Generator(device=cuda_device).manual_seed(8),
                      device=cuda_device)
    s = torch.tensor(starts, dtype=torch.int32, device=cuda_device)
    before = _build.launches.copy()
    got = pk.read_at(src, s)
    torch.cuda.synchronize()
    assert launched_since(before, "ggt_probe_read_at") == (1,)
    assert got.shape == (len(starts), 128, 128)
    assert torch.equal(got, pk.read_at_plain(src, s))


# an odd tile count (5 x 3 at tile 32): the last cluster's second CTA has no tile
ODD_W, ODD_H = 160, 96


@pytest.mark.gpu
@pytest.mark.parametrize("opacity", [0.1, 0.95])
@pytest.mark.parametrize("channels", rc.KERNEL_CHANNELS)
def test_k5_bit_equal_to_k1(cuda_device, channels, opacity):
    args = _k1_args(cuda_device, channels, opacity, ODD_W, ODD_H)
    assert args[1].shape[0] % 2 == 1
    before = _build.launches.copy()
    got = rc.composite_pairs_fwd(*args, two_tile=True)
    want = rc.composite_pairs_fwd(*args)
    torch.cuda.synchronize()
    assert launched_since(before, K1, K5) == (1, 1)
    assert got[0].shape == want[0].shape == (args[1].shape[0], 32 * 32, channels)
    for name, a, b in zip(("out", "alpha", "logt", "ncomp"), got, want):
        assert torch.equal(a, b), name


@pytest.mark.gpu
@pytest.mark.parametrize("channels", rc.KERNEL_CHANNELS)
def test_k6_matches_k2_and_plain(cuda_device, channels):
    """K2's criterion: per-Gaussian sums within 1e-4 of each column group's
    max, against K2 and against the plain version."""
    args = _k1_args(cuda_device, channels, 0.95, ODD_W, ODD_H)
    _, alpha, logt, ncomp = rc.composite_pairs_fwd(*args)
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    g_out = torch.randn(*alpha.shape, channels, generator=gen, device=cuda_device)
    g_alpha = torch.randn(alpha.shape, generator=gen, device=cuda_device)
    bargs = args[:5] + (g_out, g_alpha, logt, ncomp) + args[5:]
    before = _build.launches.copy()
    got = _per_gaussian(args, rc.composite_pairs_bwd(*bargs, two_tile=True))
    k2 = _per_gaussian(args, rc.composite_pairs_bwd(*bargs))
    plain = _per_gaussian(args, rc.composite_pairs_bwd_plain(*bargs))
    torch.cuda.synchronize()
    assert launched_since(before, K6) == (1,)
    _assert_grads_close(got, k2, channels)
    _assert_grads_close(got, plain, channels)


@pytest.mark.gpu
def test_train_step_tp2_loss_equals_tp1(cuda_device, monkeypatch):
    """One train step through K5 / K6 and one through K1 / K2 from the same
    state: K5 is bit-equal to K1, so the loss is the same."""
    cfg = GaussianSplatConfig()
    field, alive, cam = _scene(cuda_device, w=ODD_W, h=ODD_H)
    fea = {k: v.detach().to(cuda_device) for k, v in FeaUp().state_dict().items()}
    state = dataclasses.replace(init_train_state(field, alive, fea), step=STEP + 9)
    rng = np.random.default_rng(2)
    batch = {
        "image": rng.random((ODD_H, ODD_W, 3), np.float32),
        "depth": np.full((ODD_H, ODD_W), 3.0, np.float32),
        "normal": np.tile(np.array([0.0, 0.0, 1.0], np.float32), (ODD_H, ODD_W, 1)),
        "valid_mask": rng.random((ODD_H, ODD_W)) > 0.1,
        "pair_a": rng.integers(0, ODD_H, (4, 16, 2)).astype(np.int32),
        "pair_b": rng.integers(0, ODD_H, (4, 16, 2)).astype(np.int32),
        "pair_valid": np.ones((4, 16), bool), "group_valid": np.ones(4, bool),
        "points": rng.integers(0, ODD_H, (32, 2)).astype(np.int32),
        "point_valid": np.ones(32, bool),
        "gt_clip": rng.standard_normal((32, 512)).astype(np.float32),
    }
    batch = {k: torch.as_tensor(v, device=cuda_device) for k, v in batch.items()}
    losses = {}
    for tp in (1, 2):
        monkeypatch.setattr(rc, "TP", tp)
        before = _build.launches.copy()
        _, m = train_step(state, cam, batch, cfg)
        losses[tp] = float(m["loss"])
        assert launched_since(before, K5, K6) == ((1, 1) if tp == 2 else (0, 0))
    assert np.isfinite(losses[1])
    assert abs(losses[2] - losses[1]) <= 1e-6 * abs(losses[1])


def _train_step_card_vs_cpu(cuda_device, cfg):
    """One train step from one state on the card and on the CPU path:
    losses within 1e-3 relative, parameters within 2 lr of their group
    (Adam with eps 1e-15 moves near-zero-gradient entries by +-lr on a sign
    rounding can flip). Returns the CPU step's metrics."""
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
        before = _build.launches.copy()
        out[dev.type] = train_step(state, cam, {k: torch.as_tensor(v, device=dev)
                                                for k, v in batch.items()}, cfg)
        # the EFD loss's pixel gather through its kernels on the card
        assert launched_since(before, *GATHER) == ((1, 1) if dev.type == "cuda" else (0, 0))
    (gs, gm), (cs, cm) = out[cuda_device.type], out["cpu"]
    for k, v in cm.items():
        torch.testing.assert_close(gm[k].cpu().float(), v.float(), atol=1e-5, rtol=1e-3, msg=k)
    for leaf, group in optim.FIELD_GROUP_OF.items():
        lim = 2.0 * optim.DEFAULT_GROUPS[group].lr_init
        torch.testing.assert_close(getattr(gs.field, leaf).cpu(), getattr(cs.field, leaf),
                                   atol=lim, rtol=0, msg=leaf)
    for a, b in zip(gs.stats, cs.stats):
        torch.testing.assert_close(a.cpu(), b, atol=1e-6, rtol=1e-3)
    return cm


@pytest.mark.gpu
def test_train_step_on_card_matches_cpu(cuda_device):
    m = _train_step_card_vs_cpu(cuda_device, GaussianSplatConfig())
    assert int(m["overflow"]) == int(m["pair_overflow"]) == 0


# the 12 tiles of _scene hold 258..605 pairs (4914 in all): K 512 clips
# the three busiest, and B = 12 * 384 = 4608 ends the stream inside its
# last tile (overflow 158, pair_overflow 306 on the CPU path)
CLIPPED_RASTER = RasterizeConfig(max_gaussians_per_tile=512, pair_budget_per_tile=384)


@pytest.mark.gpu
def test_train_step_with_pairs_dropped_on_card_matches_cpu(cuda_device):
    """The same step on a stream clipped by both K and B (the regime of a
    run past its capacity): overflow and pair_overflow positive, the card's
    equal to the CPU path's, and the step held as above."""
    m = _train_step_card_vs_cpu(cuda_device, GaussianSplatConfig(raster=CLIPPED_RASTER))
    assert int(m["overflow"]) > 0 and int(m["pair_overflow"]) > 0


@pytest.mark.gpu
def test_render_on_card_matches_cpu(cuda_device):
    cfg = GaussianSplatConfig()
    with torch.no_grad():
        gpu = render(*_scene(cuda_device), STEP, cfg)
        cpu = render(*_scene("cpu"), STEP, cfg)
    for k in ("rgb", "feature", "depth", "normal", "alpha"):
        torch.testing.assert_close(gpu[k].cpu(), cpu[k], atol=1e-4, rtol=1e-4, msg=k)


def _widen(args, channels):
    """The stream args with `channels` colour channels (chip_smoke.py's)."""
    import chip_smoke

    return chip_smoke.widen_inputs(args, channels)


def _assert_pieces_agree(pieces):
    """alpha, logt and ncomp bit-equal across the channel pieces' launches."""
    assert len(pieces) > 1
    for p in pieces[1:]:
        for name, a, b in zip(("alpha", "logt", "ncomp"), p, pieces[0]):
            assert torch.equal(a, b), name


@pytest.mark.gpu
@pytest.mark.parametrize("channels", [71, 122])
def test_chunked_widths_match_plain(cuda_device, channels):
    """C 71 (F 64) and 122 (F 115, the widest the JAX package takes): K1,
    K5, K2 and K6 in pieces of at most 39 channels against the plain
    versions with their criteria, each piece's alpha / logt / ncomp
    bit-equal to the first's; C 123 raises and names the limit."""
    args = _widen(_k1_args(cuda_device, 39, 0.95), channels)
    gidx, starts, counts, attrs, bg, tw, ts = args
    want = rc.composite_pairs_fwd_plain(*args)
    for two_tile in (False, True):
        _, pieces = rc.fwd_pieces(lambda a, b: rc._kernel_fwd(gidx, starts, counts, a, b, tw,
                                                              ts, two_tile),
                                  rc.KERNEL_CHANNELS, attrs, bg)
        assert len(pieces) == len(rc.channel_pieces(channels))
        _assert_pieces_agree(pieces)
        before = _build.launches.copy()
        got = rc.composite_pairs_fwd(*args, two_tile=two_tile)
        assert launched_since(before, K5 if two_tile else K1) == (len(pieces),)
        assert got[0].shape == want[0].shape
        _assert_fwd_close(got, want)
    bargs = _bwd_args(args, seed=7)
    plain = _per_gaussian(args, rc.composite_pairs_bwd_plain(*bargs))
    for two_tile in (False, True):
        before = _build.launches.copy()
        got = rc.composite_pairs_bwd(*bargs, two_tile=two_tile)
        assert launched_since(before, K6 if two_tile else K2) == (len(rc.channel_pieces(channels)),)
        assert got.shape == (gidx.shape[0], 6 + channels)
        _assert_grads_close(_per_gaussian(args, got), plain, channels)
    wide = _widen(args, 123)
    with pytest.raises(ValueError, match="C <= 122"):
        rc.composite_pairs_fwd(*wide)


def _table_args(device, channels, opacity, w=W, h=H):
    """K3's inputs (counts, tables, bg, tw, ts), K1's on the stream of the
    same sort, tile_gidx and N."""
    field, alive, cam = _scene(device, opacity=opacity, w=w, h=h)
    cfg = GaussianSplatConfig()
    proj, colors, opac, bg = render_inputs(field, alive, cam, STEP, cfg)
    bins = bin_gaussians(proj, w, h, cfg.raster, opacities=opac, keep_pairs=True)
    assert int(bins.overflow) == 0 and int(bins.pair_overflow) == 0
    k = bins.tile_gidx.shape[1]
    colors = colors[:, :channels]
    tables = rc.gather_tables(bins.tile_gidx, proj.xys, proj.conics, opac, colors)
    counts = torch.clamp(bins.tile_count, max=k).int().contiguous()
    starts, kcounts = rc.stream_bounds(bins.pair_gidx, bins.pair_starts, bins.tile_count, k)
    bg = bg[:channels].contiguous()
    tw = -(-w // 32)
    k1 = (bins.pair_gidx.contiguous(), starts, kcounts,
          rc.pack_attrs(proj.xys, proj.conics, opac, colors), bg, tw, 32)
    return (counts, tables, bg, tw, 32), k1, bins.tile_gidx, proj.xys.shape[0]


@pytest.mark.gpu
@pytest.mark.parametrize("opacity", [0.1, 0.95])
@pytest.mark.parametrize("channels", rc.KERNEL_CHANNELS)
def test_k3_matches_plain_and_is_bit_equal_to_k1(cuda_device, channels, opacity):
    targs, k1, _, _ = _table_args(cuda_device, channels, opacity)
    before = _build.launches.copy()
    got = rc.composite_tables_fwd(*targs)
    want = rc.composite_tables_fwd_plain(*targs)
    k1_out = rc.composite_pairs_fwd(*k1)
    torch.cuda.synchronize()
    assert launched_since(before, K3) == (1,)
    for name, a, b in zip(("out", "alpha", "logt"), got, want):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=0, msg=name)
    torch.testing.assert_close(got[3], want[3], atol=0, rtol=0)
    for name, a, b in zip(("out", "alpha", "logt", "ncomp"), got, k1_out):
        assert torch.equal(a, b), name


@pytest.mark.gpu
@pytest.mark.parametrize("channels", rc.KERNEL_CHANNELS)
def test_k4_matches_plain_and_k2(cuda_device, channels):
    """K2's criterion on the per-Gaussian sums, against the plain version
    and against K2 on the stream of the same sort."""
    targs, k1, tile_gidx, n = _table_args(cuda_device, channels, 0.95)
    _, alpha, logt, ncomp = rc.composite_tables_fwd(*targs)
    gen = torch.Generator(device=cuda_device).manual_seed(2)
    g_out = torch.randn(*alpha.shape, channels, generator=gen, device=cuda_device)
    g_alpha = torch.randn(alpha.shape, generator=gen, device=cuda_device)
    bargs = targs[:3] + (g_out, g_alpha, logt, ncomp) + targs[3:]
    before = _build.launches.copy()
    got = rc.scatter_table(tile_gidx, n, rc.composite_tables_bwd(*bargs))
    plain = rc.scatter_table(tile_gidx, n, rc.composite_tables_bwd_plain(*bargs))
    k2 = _per_gaussian(k1, rc.composite_pairs_bwd(*(k1[:5] + (g_out, g_alpha, logt, ncomp)
                                                    + k1[5:])))
    torch.cuda.synchronize()
    assert launched_since(before, K4) == (1,)
    _assert_grads_close(got, plain, channels)
    _assert_grads_close(got, k2, channels)


@pytest.mark.gpu
def test_k3_probe_width_and_small_tiles(cuda_device):
    """C = 7 at 8x8 px tiles (the kernel probe's stage 2) and C = 39 at
    16x16 (stage 3), against the plain version."""
    from gaussiangrasper_torch.probes.kernel_probe import tiny_tile_inputs

    for shape in (dict(), dict(t=16, k=256, ts=16, c=39)):
        inputs = tiny_tile_inputs(seed=1, device=cuda_device, **shape)
        ts = shape.get("ts", 8)
        tables = torch.cat([inputs[1], inputs[2], inputs[3][..., None], inputs[4]], -1).contiguous()
        got = rc.composite_tables_fwd(inputs[0], tables, inputs[5], 2, ts)
        want = rc.composite_tables_fwd_plain(inputs[0], tables, inputs[5], 2, ts)
        torch.cuda.synchronize()
        for a, b in zip(got, want):
            torch.testing.assert_close(a, b, atol=1e-4, rtol=0)


@pytest.mark.gpu
def test_probes_match_plain(cuda_device):
    x = torch.arange(8 * 128, dtype=torch.float32, device=cuda_device).reshape(8, 128) - 300.5
    assert torch.equal(pk.affine(x), pk.affine_plain(x))
    src = torch.randn(4096, 128, device=cuda_device)
    starts = torch.tensor([3, 77, 1001, 0, 3968], dtype=torch.int32, device=cuda_device)
    assert torch.equal(pk.read_at(src, starts), pk.read_at_plain(src, starts))
    vals = torch.randn(4, 128, 128, device=cuda_device)
    starts = torch.tensor([0, 100, 200, 150], dtype=torch.int32, device=cuda_device)
    before = _build.launches.copy()
    got = pk.write_at(vals, starts, 512)
    want = pk.write_at_plain(vals, starts, 512)
    covered = pk.covered_rows(starts, 512).to(cuda_device)
    torch.cuda.synchronize()
    assert torch.equal(got[covered], want[covered])
    assert launched_since(before, "ggt_probe_affine", "ggt_probe_read_at",
                          "ggt_probe_write_at") == (0, 0, 1)


def _p3_case(device, shape):
    """(vals, starts, rows) of P3: the probe's 3 blocks into 512 rows, the
    large shape of chip_smoke.py, or 300 blocks at 22 shared starts (0 and
    rows - 128 among them) into 1000 rows, so that many blocks share a
    start and the last CTA's rows are cut."""
    import chip_smoke

    if shape == "large":
        return chip_smoke.p3_large_inputs(device)
    if shape == "probe":
        starts, rows = [0, 100, 200], 512
    else:
        rng = np.random.default_rng(4)
        rows = 1000
        starts = rng.choice(np.r_[0, rows - 128, rng.integers(0, rows - 127, 20)], 300).tolist()
    vals = torch.randn(len(starts), 128, 128, generator=torch.Generator(device).manual_seed(1),
                       device=device)
    return vals, torch.tensor(starts, dtype=torch.int32, device=device), rows


@pytest.mark.gpu
@pytest.mark.parametrize("shape", ["probe", "large", "shared_starts"])
def test_p1_p3_exact_at_probe_and_large_shapes(cuda_device, shape):
    """P1 on (8, 128) / 2^26 floats and P3 (`_p3_case`) equal to their
    plain versions bit for bit, P3 on every covered row, one launch each."""
    import chip_smoke

    n = chip_smoke.P1_LARGE if shape == "large" else 8 * 128
    x = torch.randn(n, generator=torch.Generator(cuda_device).manual_seed(2), device=cuda_device)
    vals, starts, rows = _p3_case(cuda_device, shape)
    before = _build.launches.copy()
    got_x = pk.affine(x)
    got = pk.write_at(vals, starts, rows)
    torch.cuda.synchronize()
    assert launched_since(before, "ggt_probe_affine", "ggt_probe_write_at") == (1, 1)
    assert torch.equal(got_x, pk.affine_plain(x))
    covered = pk.covered_rows(starts, rows).to(cuda_device)
    assert torch.equal(got[covered], pk.write_at_plain(vals, starts, rows)[covered])


@pytest.mark.gpu
def test_chunked_table_widths_match_plain(cuda_device):
    """K3 and K4 at C 71 in pieces against the plain versions, K3's pieces'
    alpha / logt / ncomp bit-equal; C 123 raises."""
    args = _widen(_k1_args(cuda_device, 39, 0.95), 71)
    targs = _table_of(args, int(args[2].max()))
    counts, tables, bg, tw, ts = targs
    _, pieces = rc.fwd_pieces(lambda t, b: rc._kernel_table_fwd(counts, t, b, tw, ts),
                           rc.TABLE_FWD_CHANNELS, tables, bg)
    _assert_pieces_agree(pieces)
    got = rc.composite_tables_fwd(*targs)
    _assert_fwd_close(got, rc.composite_tables_fwd_plain(*targs))
    bargs = _bwd_args(args, seed=7)
    tbargs = targs[:3] + bargs[5:7] + got[2:] + targs[3:]
    before = _build.launches.copy()
    gattr = rc.composite_tables_bwd(*tbargs)
    plain = rc.composite_tables_bwd_plain(*tbargs)
    torch.cuda.synchronize()
    assert launched_since(before, K4) == (2,)
    _assert_grads_close(gattr.reshape(-1, 6 + 71), plain.reshape(-1, 6 + 71), 71)
    with pytest.raises(ValueError, match="C <= 122"):
        rc.composite_tables_fwd(counts, torch.zeros(*tables.shape[:2], 6 + 123, device=cuda_device),
                                torch.zeros(123, device=cuda_device), tw, ts)


def _table_of(args, kt):
    """The stream args' rows packed into a (T, kt, 6 + C) table (chip_smoke.py's)."""
    import chip_smoke

    return chip_smoke.stream_table(args, kt)


def _assert_fwd_close(got, want):
    for name, a, b in zip(("out", "alpha", "logt"), got, want):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=0, msg=name)
    torch.testing.assert_close(got[3], want[3], atol=0, rtol=0, msg="ncomp")


@pytest.mark.gpu
@pytest.mark.parametrize("ts", [12, 16, 32])  # 12: pixel-row warps, the last one half idle
@pytest.mark.parametrize("opaque", [False, True])
@pytest.mark.parametrize("channels", [3, 7, 39])
def test_k1_k3_k5_on_counts_around_sub_chunks_and_batches(cuda_device, channels, opaque, ts):
    """K1 against the plain version (max abs 1e-4, ncomp exact) on 13
    tiles (an odd count for K5) of 0 to 200 rows, around the forward's
    8-row sub-chunks and 128-row batches, at low opacity and with every
    walk one row (opaque); K3 on the same rows packed into a table of K 203
    and K3 and K5 bit-equal to K1. C 7 runs K1 / K5 through the padding to
    39 and K3 unpadded."""
    args = _straddle_args(cuda_device, channels, opaque, ts)
    counts = args[2]
    before = _build.launches.copy()
    got = rc.composite_pairs_fwd(*args)
    got5 = rc.composite_pairs_fwd(*args, two_tile=True)
    got3 = rc.composite_tables_fwd(*_table_of(args, 203))
    want = rc.composite_pairs_fwd_plain(*args)
    torch.cuda.synchronize()
    assert launched_since(before, K1, K5, K3) == (1, 1, 1)
    if opaque:
        assert bool((got[3][counts >= 2] == 1).all())
    _assert_fwd_close(got, want)
    for name, a, b3, b5 in zip(("out", "alpha", "logt", "ncomp"), got, got3, got5):
        assert torch.equal(b5, a), name
        assert torch.equal(b3, a), name  # each 8-channel n tile is its own product
    _assert_fwd_close(got3, want)


@pytest.mark.gpu
@pytest.mark.parametrize("feature_dim", [8, 16])
def test_padded_widths_match_plain(cuda_device, feature_dim):
    """F 8 and 16 (C 15 and 23): K1, K2, K4 and K6 through the zero padding
    to the C 39 kernels against the plain versions, with their criteria."""
    channels = 3 + feature_dim + 4
    args = _k1_args(cuda_device, channels, 0.95)
    _assert_fwd_close(rc.composite_pairs_fwd(*args), rc.composite_pairs_fwd_plain(*args))
    bargs = _bwd_args(args, seed=7)
    want = _per_gaussian(args, rc.composite_pairs_bwd_plain(*bargs))
    for two_tile in (False, True):
        got = rc.composite_pairs_bwd(*bargs, two_tile=two_tile)
        assert got.shape == (args[0].shape[0], 6 + channels)
        _assert_grads_close(_per_gaussian(args, got), want, channels)
    targs = _table_of(args, int(args[2].max()))
    _, _, logt, ncomp = rc.composite_tables_fwd(*targs)
    tbargs = targs[:3] + bargs[5:7] + (logt, ncomp) + targs[3:]
    got = rc.composite_tables_bwd(*tbargs)
    plain = rc.composite_tables_bwd_plain(*tbargs)
    torch.cuda.synchronize()
    assert got.shape == targs[1].shape
    _assert_grads_close(got.reshape(-1, 6 + channels), plain.reshape(-1, 6 + channels), channels)


def _train_cli_two_steps(tmp_path, feature_dim):
    """`ggt-torch-train --feature-dim <feature_dim>` for two steps on the
    card: (trainer, losses, K1 and K2 launches)."""
    from gaussiangrasper_torch.data.synthetic import generate_tabletop
    from gaussiangrasper_torch.engine import train_state
    from gaussiangrasper_torch.scripts import train

    scene = generate_tabletop(tmp_path / "scene", width=64, height=48, n_views=4,
                              feature_downscale=2)
    losses = []
    step = train_state.train_step

    def recorded(*a, **k):
        out = step(*a, **k)
        losses.append(float(out[1]["loss"]))
        return out

    before = _build.launches.copy()
    train_state.train_step = recorded
    try:
        trainer = train.main(["--data", str(scene), "--output-dir", str(tmp_path / "out"),
                              "--max-iterations", "2", "--capacity", "4096", "--feature-dim",
                              str(feature_dim), "--sh-degree", "1", "--max-tiles-per-gaussian",
                              "16"])
    finally:
        train_state.train_step = step
    torch.cuda.synchronize()
    return trainer, losses, launched_since(before, K1, K2)


@pytest.mark.gpu
def test_train_cli_feature_dim_16(cuda_device, tmp_path):
    """`ggt-torch-train --feature-dim 16` (C 23) trains on the card: two
    steps through K1 / K2 with the padding, finite losses."""
    trainer, losses, launches = _train_cli_two_steps(tmp_path, 16)
    assert trainer.config.model.num_channels == 23
    assert len(losses) == 2 and all(np.isfinite(losses))
    assert launches == (2, 2)


@pytest.mark.gpu
def test_train_cli_feature_dim_64(cuda_device, tmp_path):
    """`ggt-torch-train --feature-dim 64` (C 71) trains on the card: two
    steps, each K1 and K2 launched once a channel piece (39 + 32), finite
    losses."""
    trainer, losses, launches = _train_cli_two_steps(tmp_path, 64)
    assert trainer.config.model.num_channels == 71
    assert len(losses) == 2 and all(np.isfinite(losses))
    assert launches == (4, 4)


def _tf32(x):
    """float32 rounded to TF32 as `cvt.rna.tf32.f32` rounds it (to nearest,
    ties away from zero)."""
    return ((x.contiguous().view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def _tf32_truncated(x):
    """float32 as the tensor core reads it for a TF32 operand: the 13 low
    mantissa bits dropped."""
    return (x.contiguous().view(torch.int32) & -0x2000).view(torch.float32)


def _round_toward_zero(x):
    """float64 to float32, rounded toward zero."""
    y = x.to(torch.float32)
    away = y.to(torch.float64).abs() > x.abs()
    return torch.where(away, torch.nextafter(y, torch.zeros_like(y)), y)


def tensor_core_fwd(args, rounding: str):
    """K1's four outputs with the colour sums taken in groups of 8 walk
    rows, as mma.sync m16n8k8 takes them in 3xTF32: W (pixels x 8 rows) and
    Colour (8 rows x C) split into hi = tf32(x) and lo = x - hi (read
    truncated to TF32), then lo hi, hi lo and hi hi in mma_3xtf32_split's
    order, each product's 8 terms added exactly and the sum rounded once.
    `rounding`: "rz", each product added to the running accumulator and
    rounded toward zero, as the tensor core rounds its sums; "rn", the same
    rounded to nearest; "group", the three products of a group into a
    zeroed sum rounded toward zero, that sum then added to the running
    accumulator in IEEE float32 (to nearest). The kernel's groups are each
    warp's kept rows, 8 at a time; consecutive walk rows stand in for them.
    The plain forward supplies the weights (its colour product patched)."""
    rnd = _round_toward_zero if rounding in ("rz", "group") else (lambda x: x.to(torch.float32))
    einsum, pending, acc = torch.einsum, [], []

    def flush():
        w, c = torch.stack([p[0] for p in pending], -1), torch.stack([p[1] for p in pending], 1)
        pending.clear()
        wh, ch = _tf32(w), _tf32(c)
        wl, cl = _tf32_truncated(w - wh), _tf32_truncated(c - ch)
        zero = torch.zeros(w.shape[:2] + c.shape[-1:], device=w.device)
        run = acc.pop() if acc else zero
        d = zero if rounding == "group" else run
        for a, b in ((wl, ch), (wh, cl), (wh, ch)):
            d = rnd(d.double() + einsum("tpk,tkc->tpc", a.double(), b.double()))
        acc.append(run + d if rounding == "group" else d)

    def patched(equation, *operands):
        if equation != "tp,tc->tpc":
            return einsum(equation, *operands)
        w, c = operands
        pending.append((w, c))
        if len(pending) == 8:
            flush()
        return torch.zeros(w.shape + c.shape[-1:], device=w.device)

    with mock.patch.object(torch, "einsum", patched):
        out, alpha, logt, ncomp = rc.composite_pairs_fwd_plain(*args)  # out: T_final bg alone
    if pending:
        flush()
    return (acc[0] + out if acc else out), alpha, logt, ncomp


def dense_tile_args(device):
    """chip_smoke.py's dense tiles (2048 live rows a pixel, |out| ~4)."""
    import chip_smoke

    return chip_smoke.dense_tile_inputs(device)


def precision_reading(x, want):
    """max and mean |x - want|, and the share of the error's mass that
    lowers |out| (1: all toward zero, -1: all away)."""
    d = (x - want).double()
    toward_zero = float((d * torch.sign(want)).sum() / d.abs().sum().clamp(min=1e-300))
    return {"max_abs": float(d.abs().max()), "mean_abs": float(d.abs().mean()),
            "toward_zero": -toward_zero}


def _full_width_args(device):
    """chip_smoke.py's full-width K1 inputs: bench.py's field of 200k
    Gaussians at 800x800, C 39."""
    import chip_smoke

    field, alive = chip_smoke.bench_field(chip_smoke.N_FULL, seed=0, device=device)
    cam = chip_smoke.bench_camera(chip_smoke.WIDTH, chip_smoke.HEIGHT, device)
    with torch.no_grad():
        return chip_smoke.k1_inputs(field, alive, cam, GaussianSplatConfig())


@pytest.mark.gpu
@pytest.mark.parametrize("inputs", ["saturated", "full_width"])
def test_k1_colour_sums_err_as_the_tensor_cores_round(cuda_device, inputs):
    """K1's out against the plain version on the card at C 39, background
    0 (so out is the colour sum alone): within chip_smoke.py's 1e-4, and
    the difference is that of K1's sums as they are now taken, each group's
    products truncated into a zeroed sum that is added in IEEE f32
    (`tensor_core_fwd`'s "group"): far less, and far less biased, than the
    first tensor-core design's truncated running sums (the emulation "rz",
    whose error nearly all lowers |out|). Prints the readings as one JSON
    line."""
    args = _k1_args(cuda_device, 39, 0.95) if inputs == "saturated" else _full_width_args(cuda_device)
    args = args[:4] + (torch.zeros_like(args[4]),) + args[5:]
    with torch.no_grad():
        got = rc.composite_pairs_fwd(*args)[0]
        want = rc.composite_pairs_fwd_plain(*args)[0]
        emul = {r: tensor_core_fwd(args, r)[0] for r in ("rz", "rn", "group")}
    torch.cuda.synchronize()
    readings = {"kernel": precision_reading(got, want),
                **{f"emulated_{r}": precision_reading(x, want) for r, x in emul.items()},
                "kernel_vs_emulated_group_max_abs": float((got - emul["group"]).abs().max()),
                "max_abs_out": float(want.abs().max())}
    print("k1_precision", inputs, json.dumps(readings))
    assert readings["kernel"]["max_abs"] <= 1e-4
    assert readings["emulated_rz"]["toward_zero"] > 0.5
    assert abs(readings["emulated_rn"]["toward_zero"]) < 0.5
    assert readings["kernel"]["mean_abs"] <= 0.5 * readings["emulated_rz"]["mean_abs"]
    assert readings["kernel"]["toward_zero"] < 0.9


@pytest.mark.gpu
def test_k1_colour_sums_on_a_dense_tile(cuda_device):
    """K1's out against the plain version on two dense tiles (2048 live
    rows a pixel, |out| ~4, background 0: `dense_tile_args`), where a
    truncating sum's error grows with the rows: within chip_smoke.py's
    1e-4; K3 on the same rows and K5 bit-equal to K1. Prints the readings,
    with the emulations of `tensor_core_fwd`, as one JSON line."""
    args = dense_tile_args(cuda_device)
    with torch.no_grad():
        got = rc.composite_pairs_fwd(*args)
        want = rc.composite_pairs_fwd_plain(*args, count_live=True)
        k5 = rc.composite_pairs_fwd(*args, two_tile=True)
        k3 = rc.composite_tables_fwd(*_table_of(args, 2048))
        emul = {r: tensor_core_fwd(args, r)[0] for r in ("rz", "rn", "group")}
    torch.cuda.synchronize()
    readings = {"kernel": precision_reading(got[0], want[0]),
                **{f"emulated_{r}": precision_reading(x, want[0]) for r, x in emul.items()},
                "max_abs_out": float(want[0].abs().max()), "min_abs_out": float(want[0].abs().min()),
                "live_rows": [int(want[4].min()), int(want[4].max())]}
    print("k1_precision dense_tile", json.dumps(readings))
    assert int(want[4].min()) == 2048 and 3.5 < readings["min_abs_out"]
    assert readings["max_abs_out"] < 4.5
    assert readings["kernel"]["max_abs"] <= 1e-4
    assert abs(readings["emulated_rn"]["toward_zero"]) < 0.5
    for other in (k5, k3):
        for name, a, b in zip(("out", "alpha", "logt", "ncomp"), other, got):
            assert torch.equal(a, b), name


@pytest.fixture
def trained_run(cuda_device, tmp_path):
    """A 64x48 tabletop run trained two steps on the card (tile 16 and K
    1024, tests/test_e2e_tabletop.py's raster setting, which the CPU path
    runs in seconds), its moved-object capture, the object's points (taken
    1.2x about the sphere's centre, so the seeds on its surface fall inside
    their hull) and the move."""
    from gaussiangrasper_torch.data.synthetic import SPHERES, generate_tabletop, move_object
    from gaussiangrasper_torch.engine.trainer import TrainerConfig, make_trainer
    from gaussiangrasper_torch.ops.rasterize import RasterizeConfig

    kw = dict(width=64, height=48, n_views=4, feature_downscale=2)
    scene = generate_tabletop(tmp_path / "scene", **kw)
    after, obj = move_object(tmp_path / "after", **kw)
    centre = SPHERES[1][0]
    np.save(tmp_path / "obj.npy", centre + 1.2 * (obj - centre))
    move = np.eye(4)
    move[:3, 3] = (-0.55, 0.45, 0.0)
    np.save(tmp_path / "move.npy", move)
    model = GaussianSplatConfig(feature_dim=16, sh_degree=1, raster=RasterizeConfig(
        tile_size=16, max_gaussians_per_tile=1024, tile_chunk=4, max_tiles_per_gaussian=16))
    trainer = make_trainer(TrainerConfig(data=scene, output_dir=tmp_path / "out", max_iterations=2,
                                         capacity=4096, model=model), device=cuda_device)
    trainer.setup()
    trainer.train()
    return tmp_path, trainer.config.run_dir, after


@pytest.mark.gpu
def test_update_cli_on_the_card_matches_cpu(cuda_device, trained_run):
    """`ggt-torch-update` for 3 fine-tune iterations on the card and on the
    CPU path from one saved state: one K1 and one K2 launch a step on the
    card, the same Gaussians moved, losses within 1e-3 relative, the densify
    stats (K2's xy gradient norms summed) within test_torch_edit's 1e-3
    relative, every group's Adam first moments within K2's criterion (1e-4
    of the leaf's max) and every parameter within a hundredth of its
    group's Adam step (lr). On an H100 the run reads 1.5e-5, 2e-6 and
    1.8e-4 lr; a K2 whose colour gradients are 1% too large fails the
    moments' bound, one that drops the opacity gradient the loss's (`-s`
    prints the readings)."""
    import shutil

    from gaussiangrasper_torch.engine import checkpoint as ckpt
    from gaussiangrasper_torch.engine import train_state
    from gaussiangrasper_torch.scripts import update

    root, run, after = trained_run
    step = train_state.train_step
    runs = {}
    for dev in ("cuda", "cpu"):
        run_dev = root / f"run_{dev}"
        shutil.copytree(run, run_dev)
        losses = []

        def recorded(*a, **k):
            out = step(*a, **k)
            losses.append(float(out[1]["loss"]))
            return out

        before = _build.launches.copy()
        train_state.train_step = recorded
        try:
            update.main(["--run-dir", str(run_dev), "--edit-object", str(root / "obj.npy"),
                         "--transform-npy", str(root / "move.npy"), "--after-data", str(after),
                         "--max-iterations", "3", "--device", dev])
        finally:
            train_state.train_step = step
        launches = launched_since(before, K1, K2)
        ckpts = run_dev / "edit" / "checkpoints"
        runs[dev] = (losses, launches, ckpt.load_checkpoint(ckpts / "step_000000000.pt"),
                     ckpt.load_checkpoint(ckpts / "step_009999999.pt"))
    (gl, glaunch, g0, gs), (cl, claunch, c0, cs) = runs["cuda"], runs["cpu"]
    readings = {"loss_rel": max(abs(a - b) / abs(b) for a, b in zip(gl, cl))}
    for name, a, b in zip(cs.stats._fields, gs.stats, cs.stats):
        readings[f"stats_{name}_rel"] = float(((a - b).abs() / (b.abs() + 1e-6)).max())
    for name in cs.opt:
        for i, (a, b) in enumerate(zip(optim.leaves(gs.opt[name].mu),
                                       optim.leaves(cs.opt[name].mu))):
            top = b.abs().max().clamp_min(1e-30)
            readings[f"mu_{name}{i}_of_max"] = float((a - b).abs().max() / top)
    for leaf, group in optim.FIELD_GROUP_OF.items():
        lr = optim.DEFAULT_GROUPS[group].lr_init
        d = (getattr(gs.field, leaf) - getattr(cs.field, leaf)).abs().max() / lr
        readings[f"param_{leaf}_over_lr"] = float(d)
    print("update_on_the_card", json.dumps(readings))
    assert glaunch == (3, 3) and claunch == (0, 0)
    assert len(gl) == 3 and all(np.isfinite(gl))
    assert readings["loss_rel"] <= 1e-3, (gl, cl)
    for leaf in ("means", "quats"):
        torch.testing.assert_close(getattr(g0.field, leaf), getattr(c0.field, leaf), atol=1e-6,
                                   rtol=0)
    assert torch.equal(gs.alive, cs.alive)
    for name, a, b in zip(cs.stats._fields, gs.stats, cs.stats):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-3, msg=name)
    for name in cs.opt:
        for a, b in zip(optim.leaves(gs.opt[name].mu), optim.leaves(cs.opt[name].mu)):
            assert float((a - b).abs().max()) <= 1e-4 * float(b.abs().max()), name
    for leaf in optim.FIELD_GROUP_OF:
        assert readings[f"param_{leaf}_over_lr"] <= 1e-2, leaf


@pytest.mark.gpu
def test_export_clis_on_the_card(cuda_device, trained_run):
    """`ggt-torch-export` on the card writes the bytes the CPU path writes;
    `export_pointcloud` renders each view through K1 once."""
    from gaussiangrasper_torch.scripts import export_ply, export_pointcloud

    root, run, _ = trained_run
    card = export_ply.main(["--run-dir", str(run), "--output", str(root / "card.ply")])
    host = export_ply.main(["--run-dir", str(run), "--output", str(root / "cpu.ply"),
                            "--device", "cpu"])
    assert card.read_bytes() == host.read_bytes()
    before = _build.launches.copy()
    export_pointcloud.main(["--run-dir", str(run), "--num-views", "3", "--mesh",
                            "--tsdf-resolution", "32"])
    assert launched_since(before, K1) == (3,)
    data = (run / "pointcloud_mesh.ply").read_bytes()
    assert data.startswith(b"ply\n") and b"element face " in data


@pytest.mark.gpu
@pytest.mark.parametrize("kind,coeffs", [
    ("perspective", [-0.08, 0.02, 5e-4, -5e-4, 0.0, 0.0]),
    ("perspective", [-0.35, 0.12, 0.0, 0.0, -0.02, 0.0]),
    ("fisheye", [0.05, 0.01, 0.0, 0.0, -3e-3, 1e-3]),
])
@pytest.mark.parametrize("size", [(83, 61), (800, 800)])
def test_undistort_on_the_card_matches_cpu(cuda_device, kind, coeffs, size):
    """`undistort_image` on the card against the CPU path from the same
    bytes: every map is float64 arithmetic of single IEEE operations, so
    the perspective branch (fixed-point remap) is bit-equal; the fisheye
    branch's atan may round a last bit otherwise on the card, which can
    move a float32 map entry by one step: there at most 1e-3 of the pixels
    may differ, by one grey level."""
    from gaussiangrasper_torch.data.dataparsers.base import ParsedCamera
    from gaussiangrasper_torch.data.manager import undistort_image

    w, h = size
    img = np.random.default_rng(w).integers(0, 256, (h, w, 3), dtype=np.uint8)
    cam = ParsedCamera(0.9 * w, 0.93 * w, w / 2 + 1.3, h / 2 - 0.7, w, h, np.eye(4)[:3],
                       np.array(coeffs), kind)
    card, card_cam = undistort_image(img, cam, cuda_device)
    host, host_cam = undistort_image(img, cam, "cpu")
    assert (card_cam.fx, card_cam.fy, card_cam.cx, card_cam.cy) == \
        (host_cam.fx, host_cam.fy, host_cam.cx, host_cam.cy)
    diff = np.abs(card.astype(int) - host.astype(int))
    print("undistort_card_vs_cpu", kind, size, json.dumps(
        {"differing_share": float((diff > 0).mean()), "max_diff": int(diff.max())}))
    if kind == "perspective":
        np.testing.assert_array_equal(card, host)
    else:
        assert (diff > 0).mean() <= 1e-3 and diff.max() <= 1


@pytest.mark.gpu
def test_four_way_split_matches_rasterize_projected(cuda_device):
    """The tile-sharded compositor split four ways in one process (the
    shard half and the band half four times each, torch.cat for the
    all-gathers) through K1 / K2 at mid size: image and alpha bit-equal to
    `rasterize_projected`'s, the per-Gaussian gradients within K2's
    criterion (1e-4 of each group's max); four K1 and four K2 launches."""
    from gaussiangrasper_torch.ops.rasterize import rasterize_projected
    from gaussiangrasper_torch.parallel.tile_shard import composite_tile_split

    w, h = 400, 300
    field, alive, cam = _scene(cuda_device, w=w, h=h)
    cfg = GaussianSplatConfig()
    proj, colors, opac, bg = render_inputs(field, alive, cam, STEP, cfg)
    rng = np.random.default_rng(3)
    g_img = torch.as_tensor(rng.standard_normal((h, w, colors.shape[1]), np.float32),
                            device=cuda_device)

    def run(composite):
        leaves = [x.detach().clone().requires_grad_(True) for x in (proj.xys, proj.conics, opac,
                                                                   colors)]
        out = composite(proj._replace(xys=leaves[0], conics=leaves[1]), leaves[3], leaves[2])
        loss = (out["image"] * g_img).sum() + 0.5 * out["alpha"].sum()
        return out, torch.autograd.grad(loss, leaves)

    before = _build.launches.copy()
    split, g_split = run(lambda p, c, o: composite_tile_split(p, c, o, bg, w, h, cfg.raster, d=4))
    torch.cuda.synchronize()
    launches = launched_since(before, K1, K2)
    whole, g_whole = run(lambda p, c, o: rasterize_projected(p, c, o, bg, w, h, cfg.raster))
    assert launches == (4, 4)
    assert torch.equal(split["image"], whole["image"]) and torch.equal(split["alpha"], whole["alpha"])
    assert int(split["bins"].gather_overflow) == int(split["bins"].merge_overflow) == 0
    got = torch.cat([g_split[0], g_split[1], g_split[2][:, None], g_split[3]], 1)
    want = torch.cat([g_whole[0], g_whole[1], g_whole[2][:, None], g_whole[3]], 1)
    _assert_grads_close(got, want, colors.shape[1])


@pytest.mark.gpu
def test_train_cli_mesh_one_rank(cuda_device, tmp_path):
    """`ggt-torch-train --mesh 1,1 --tile-shard on`: a real NCCL world of
    one rank trains two steps through the band path (one K1 and one K2
    launch a step) and closes its world."""
    from gaussiangrasper_torch.data.synthetic import generate_tabletop
    from gaussiangrasper_torch.scripts import train

    scene = generate_tabletop(tmp_path / "scene", width=64, height=48, n_views=4,
                              feature_downscale=2)
    before = _build.launches.copy()
    trainer = train.main(["--data", str(scene), "--output-dir", str(tmp_path / "out"),
                          "--max-iterations", "2", "--capacity", "4096", "--mesh", "1,1",
                          "--tile-shard", "on"])
    torch.cuda.synchronize()
    assert launched_since(before, K1, K2) == (2, 2)
    assert trainer.state.step == 2 and not torch.distributed.is_initialized()
    assert all(bool(torch.isfinite(x).all()) for x in trainer.state.field)
    assert (tmp_path / "out" / "gaussian-splatting" / "checkpoints" / "step_000000002.pt").exists()


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["rgb", "depth", "normal"])
def test_viewer_frame_on_the_card_matches_cpu(cuda_device, mode):
    """The viewer's frame of one pose over the same field on the card (K1)
    and on the CPU (its plain version): the float frames within K1's
    criterion, 1e-4, and their JPEGs (quality 85) within a few grey levels
    (a pixel rounded to the next level moves its 8 x 8 block's
    coefficients by at most one quantum)."""
    import types

    from gaussiangrasper_torch.scripts import viewer
    from gaussiangrasper_torch.utils.image_io import read_jpeg

    cfg = GaussianSplatConfig()
    pose = dict(eye=[0.3, -0.2, 0.0], center=[0.0, 0.0, -3.0], up=[0.0, 1.0, 0.0])
    frames, floats = {}, {}
    for dev in (cuda_device, torch.device("cpu")):
        field, alive, _ = _scene(dev)
        state = types.SimpleNamespace(field=field, alive=alive, step=STEP)
        srv = viewer.make_server(lambda: state, cfg, 0, W, H)
        try:
            frames[dev.type] = read_jpeg(srv.render_pose(**pose, mode=mode)).astype(np.int64)
        finally:
            srv.server_close()
        cam = Camera.create(0.7 * W, 0.7 * W, W / 2, H / 2, viewer.look_at(**pose), W, H,
                            device=dev)
        with torch.no_grad():
            floats[dev.type] = viewer.frame_rgb(render(field, alive, cam, STEP, cfg), mode)
    err = np.abs(floats["cuda"] - floats["cpu"]).max()
    diff = np.abs(frames["cuda"] - frames["cpu"])
    print("viewer_card_vs_cpu", mode, json.dumps({"float_max_abs": float(err),
                                                  "jpeg_max_abs": int(diff.max()),
                                                  "jpeg_mean_abs": float(diff.mean())}))
    assert err <= 1e-4
    assert diff.max() <= 8 and diff.mean() <= 0.1
    assert frames["cuda"].std() > 0


@pytest.mark.gpu
@pytest.mark.parametrize("grey", [False, True])
def test_equirect_on_the_card_matches_cpu(cuda_device, grey):
    """equirect_to_perspective on the card against the CPU path, bit for
    bit, on a seeded 1024x512 panorama at the 8-crop pattern (the seam and
    both pole rows among them) and at the crop size process_data picks."""
    from gaussiangrasper_torch.data import equirect

    pano = np.random.default_rng(3).integers(0, 256, (512, 1024, 3), dtype=np.uint8)
    if grey:
        pano = pano[..., 0].copy()
    fov, pairs = equirect.sampling_pattern(8)
    on_card = torch.as_tensor(pano, device=cuda_device)
    for i, (yaw, pitch) in enumerate(pairs + [(180.0, 0.0), (-179.5, 89.0)]):
        size = equirect.crop_resolution(pano.shape[:2], 8) if i == 0 else (61, 83)
        card = equirect.equirect_to_perspective(on_card, fov, yaw, pitch, size)
        assert card.device.type == "cuda"
        host = equirect.equirect_to_perspective(pano, fov, yaw, pitch, size)
        assert torch.equal(card.cpu(), host), (yaw, pitch)


# --- the ray-marched zoo (plain torch ops, no kernel of its own) ---------------

ZOO_TINY = dict(num_coarse=8, num_fine=8, hidden=16, hash_levels=4, log2_hashmap_size=8,
                tensorf_resolution=16, far=4.0)
ZOO_CASES = [("vanilla", {}), ("nerfacto", {"use_proposal": True, "num_proposal_samples": (8, 8)}),
             ("mipnerf", {}), ("instant-ngp", {}), ("tensorf", {}), ("neus", {}),
             ("neus-facto", {}), ("nerfacto", {"num_semantic_classes": 5}),
             ("nerfacto", {"num_appearance_embeds": 3}), ("vanilla", {"deformation": True})]


ZOO_NUDGES = (1, -1, 2, -2, 3, -3, 4, -4)  # chip_smoke.py's: the CPU float32 spread's runs


def _zoo_run(field, cfg, coords, draws, device, dtype, nudge=0):
    """render_rays forward and backward, the ray origins and the draws moved
    by `nudge` ulps."""
    import copy

    from gaussiangrasper_torch._device import full_f32
    from gaussiangrasper_torch.core.rays import generate_rays
    from gaussiangrasper_torch.models.nerf import render_rays

    f = copy.deepcopy(field).to(device=device, dtype=dtype)
    c2w = np.concatenate([np.eye(3), [[0.1], [-0.2], [1.5]]], 1)
    cam = Camera.create(12.0, 12.0, 8.0, 6.0, c2w, 16, 12, device=device)
    cam = dataclasses.replace(cam, camera_to_world=cam.camera_to_world.to(dtype))
    extra = {}
    if cfg.deformation:
        extra["times"] = torch.tensor(0.3, dtype=dtype, device=device)
    rb = generate_rays(cam, coords.to(device))
    d = {k: torch.tensor(v, dtype=dtype, device=device) for k, v in draws.items()}
    for _ in range(abs(nudge)):
        def up(x):
            return torch.nextafter(x, torch.full_like(x, nudge * float("inf")))
        rb = rb._replace(origins=up(rb.origins))
        d = {k: up(v) for k, v in d.items()}
    with full_f32():
        out = render_rays(f, rb, d, cfg, **extra)
        sum(torch.sum(v * (1.0 + 0.1 * i)) for i, (k, v) in enumerate(sorted(out.items()))
            if v.is_floating_point()).backward()
    return ({k: v.detach().double().cpu().numpy() for k, v in out.items()},
            {n: p.grad.double().cpu().numpy() for n, p in f.named_parameters() if p.grad is not None})


@pytest.mark.gpu
@pytest.mark.parametrize("case", ZOO_CASES, ids=lambda c: "-".join([c[0], *c[1]]))
def test_nerf_field_on_the_card_matches_cpu(cuda_device, case):
    """render_rays forward and backward of 32 rays at tiny widths, card
    against CPU from one field and one set of draws: float64 within 1e-8 of
    each output's / leaf's largest entry; float32 outputs within 1e-5 plus 4x
    the CPU's own float32 spread, each gradient leaf within 1e-4 of its
    largest entry plus 10x its CPU float32 spread: its largest error against
    float64 over the CPU float32 runs with the origins and draws moved by
    ZOO_NUDGES ulps and without (chip_smoke.py's nerf_zoo criteria)."""
    from gaussiangrasper_torch.models.nerf import NerfConfig, draw_shapes, init_nerf

    field_name, kw = case
    cfg = NerfConfig(field=field_name, **ZOO_TINY, **kw)
    field = init_nerf(cfg, seed=1)
    rng = np.random.default_rng(2)
    coords = torch.tensor(np.stack([rng.integers(0, 12, 32), rng.integers(0, 16, 32)], -1))
    draws = {k: rng.random(s) for k, s in draw_shapes(cfg, 32).items()}
    runs = {(d, dt): _zoo_run(field, cfg, coords, draws, d, dt)
            for d in ("cpu", cuda_device) for dt in (torch.float32, torch.float64)}
    (o32, g32), (o64, g64) = runs[("cpu", torch.float32)], runs[("cpu", torch.float64)]
    (c32, cg32), (c64, cg64) = runs[(cuda_device, torch.float32)], runs[(cuda_device, torch.float64)]
    for k in o64:
        scale = max(np.abs(o64[k]).max(), 1e-30)
        assert np.abs(c64[k] - o64[k]).max() <= 1e-8 * scale, k
        assert np.all(np.abs(c32[k] - o32[k]) <= 1e-5 + 4 * np.abs(o32[k] - o64[k])), k
    nudged = [g32] + [_zoo_run(field, cfg, coords, draws, "cpu", torch.float32, n)[1]
                      for n in ZOO_NUDGES]
    scales = {n: max(np.abs(g64[n]).max(), 1e-30) for n in g64}
    for n in g64:
        spread = max(np.abs(g[n] - g64[n]).max() for g in nudged) / scales[n]
        assert np.abs(cg64[n] - g64[n]).max() <= 1e-8 * scales[n], n
        assert np.abs(cg32[n] - g32[n]).max() / scales[n] <= 1e-4 + 10 * spread, n


@pytest.mark.gpu
def test_nerf_step_on_the_card_matches_cpu(cuda_device):
    """One nerfacto `nerf_step` (tiny widths, 64 rays) on the card and on the
    CPU from one field, batch and draws: metrics within 1e-5, parameters
    within 2 lr. Then a second step on the same batch and draws: its
    metrics, which see the first update, within 1e-5 too, and its loss
    below the first step's on both (the update descends)."""
    from gaussiangrasper_torch.engine import nerf_trainer as nt
    from gaussiangrasper_torch.models.nerf import NerfConfig, draw_shapes, init_nerf

    cfg = NerfConfig(field="nerfacto", use_proposal=True, num_proposal_samples=(8, 8), **ZOO_TINY)
    rng = np.random.default_rng(3)
    coords = np.stack([rng.integers(0, 12, 64), rng.integers(0, 16, 64)], -1)
    target = rng.random((64, 3)).astype(np.float32)
    depth = rng.uniform(0, 3, 64).astype(np.float32)
    draws = {k: rng.random(s).astype(np.float32) for k, s in draw_shapes(cfg, 64).items()}
    c2w = np.concatenate([np.eye(3), [[0.1], [-0.2], [1.5]]], 1)
    fields, metrics, second = {}, {}, {}
    for dev in ("cpu", cuda_device):
        f = init_nerf(cfg, seed=4, device=dev)
        opt = nt.init_adam(f)
        cam = Camera.create(12.0, 12.0, 8.0, 6.0, c2w, 16, 12, device=dev)

        def step():
            m = nt.nerf_step(f, opt, cam, torch.tensor(coords, device=dev),
                             torch.tensor(target, device=dev), torch.tensor(depth, device=dev),
                             torch.full((64,), -1, device=dev), torch.tensor(0.0, device=dev), 0,
                             None, draws, cfg, 5e-3,
                             nt.loss_weights(nt.NerfTrainerConfig(model=cfg)))
            return {k: float(v) for k, v in m.items()}

        metrics[str(dev)] = step()
        fields[str(dev)] = {n: p.detach().cpu().clone() for n, p in f.state_dict().items()}
        second[str(dev)] = step()
    for k, v in metrics["cpu"].items():
        assert metrics["cuda"][k] == pytest.approx(v, abs=1e-5, rel=1e-5), k
        assert second["cuda"][k] == pytest.approx(second["cpu"][k], abs=1e-5, rel=1e-5), k
    for dev in ("cpu", "cuda"):
        assert second[dev]["loss"] < metrics[dev]["loss"], dev
    for n, a in fields["cpu"].items():
        assert (fields["cuda"][n] - a).abs().max() <= 2 * 5e-3, n


# tests/test_torch_nerf.py's GRIDS (that file imports JAX): tiny_cfg's grid, the registered
# methods' grids (nerfacto, -big, -huge, the proposal fields) and a one-level grid
HASH_GRIDS = [dict(num_levels=4, log2_hashmap_size=8), dict(num_levels=12, log2_hashmap_size=17),
              dict(num_levels=16, log2_hashmap_size=19), dict(num_levels=16, log2_hashmap_size=21),
              dict(num_levels=5, log2_hashmap_size=15, max_res=256),
              dict(num_levels=1, log2_hashmap_size=4)]


def _hash_grid_id(g):
    return f"L{g['num_levels']}H{g['log2_hashmap_size']}"


def _hash_points(seed=11):
    """(8219, 3) float32 points: 4096 in one 1/64-wide box (at resolution 16
    one cell, so thousands of lookups on each of its 8 rows, a warp's 32 on
    one row), then those again shuffled among 4096 uniform ones (a warp's
    equal rows on scattered lanes), and the 27 points of {0, 0.5, 1}^3."""
    rng = np.random.default_rng(seed)
    packed = 0.4 + rng.random((4096, 3)) / 64
    mixed = np.concatenate([packed, rng.random((4096, 3))])[rng.permutation(8192)]
    edges = np.stack(np.meshgrid(*[[0.0, 0.5, 1.0]] * 3, indexing="ij"), -1).reshape(-1, 3)
    return np.concatenate([packed, mixed, edges]).astype(np.float32)


def _hash_grid_on(device, grid, seed=12):
    from gaussiangrasper_torch.models import encodings as enc

    g = enc.HashGrid(**grid).to(device)
    with torch.no_grad():
        g.table.uniform_(-1.0, 1.0, generator=torch.Generator(device).manual_seed(seed))
    return g


@pytest.mark.gpu
@pytest.mark.parametrize("x_grad", [False, True], ids=["x-fixed", "x-grad"])
@pytest.mark.parametrize("grid", HASH_GRIDS, ids=_hash_grid_id)
def test_hash_grid_kernel_matches_plain(cuda_device, grid, x_grad):
    """`hash_grid_encode` through the kernels against the plain path on the
    card, one table U(-1, 1): outputs bit-equal (the same products, summed
    in the order of torch's CUDA sum over the corner axis), the table
    gradient and dL/dx within 1e-4 of each one's largest entry
    (test_nerf_field_on_the_card_matches_cpu's bound, without its spread
    term; the kernel sums them by float atomics in another order). dL/dx
    only where x takes a gradient, and then from the same backward launch."""
    from gaussiangrasper_torch.models import encodings as enc

    g = _hash_grid_on(cuda_device, grid)
    x = torch.tensor(_hash_points(), device=cuda_device)
    cot = torch.randn(x.shape[0], 2 * grid["num_levels"], device=cuda_device,
                      generator=torch.Generator(cuda_device).manual_seed(13))
    grads = {}
    for path in ("kernel", "plain"):
        g.table.grad = None
        xp = x.clone().requires_grad_(x_grad)
        before = _build.launches.copy()
        if path == "kernel":
            out = enc.hash_grid_encode(g, xp)
            assert launched_since(before, "ggt_hash_grid_fwd") == (1,)
        else:
            out = enc.encode_plain(g.table, g.resolutions, xp)
        (out * cot).sum().backward()
        assert launched_since(before, "ggt_hash_grid_bwd") == (int(path == "kernel"),)
        grads[path] = (out.detach(), g.table.grad, xp.grad)
    (ok, gtk, gxk), (op, gtp, gxp) = grads["kernel"], grads["plain"]
    assert torch.equal(ok, op)
    scale = float(gtp.abs().max())
    assert scale > 0 and float((gtk - gtp).abs().max()) <= 1e-4 * scale
    if x_grad:
        scale = float(gxp.abs().max())
        assert scale > 0 and float((gxk - gxp).abs().max()) <= 1e-4 * scale
    else:
        assert gxk is None and gxp is None


@pytest.mark.gpu
@pytest.mark.parametrize("inner", ["x", "x-and-table"])
@pytest.mark.parametrize("grid", [HASH_GRIDS[0], HASH_GRIDS[2]], ids=_hash_grid_id)
def test_hash_grid_kernel_double_backward(cuda_device, grid, inner):
    """A gradient taken with create_graph through the kernel path (of x
    alone, as neus-facto's SDF gradient, or of x and the table), then
    differentiated again: the inner gradients, the table's and x's within
    1e-4 of the plain path's largest entries, with the double backward
    kernel launched once and no plain op in its place."""
    from gaussiangrasper_torch.models import encodings as enc

    g = _hash_grid_on(cuda_device, grid)
    x = torch.tensor(_hash_points(), device=cuda_device)
    w = torch.randn(x.shape[0], 2 * grid["num_levels"], device=cuda_device,
                    generator=torch.Generator(cuda_device).manual_seed(14))
    got = {}
    for path in ("kernel", "plain"):
        g.table.grad = None
        xp = x.clone().requires_grad_(True)
        before = _build.launches.copy()
        out = enc.hash_grid_encode(g, xp) if path == "kernel" else \
            enc.encode_plain(g.table, g.resolutions, xp)
        wrt = [xp] if inner == "x" else [xp, g.table]
        grads = torch.autograd.grad((torch.sin(out) * w).sum(), wrt, create_graph=True)
        loss = (grads[0] ** 2).sum()
        if inner != "x":
            loss = loss + (grads[1] ** 3).sum()
        loss.backward()
        assert launched_since(before, "ggt_hash_grid_bwd2") == (int(path == "kernel"),)
        got[path] = [gr.detach() for gr in grads] + [g.table.grad, xp.grad]
    for k, p in zip(got["kernel"], got["plain"]):
        scale = float(p.abs().max())
        assert scale > 0 and float((k - p).abs().max()) <= 1e-4 * scale


@pytest.mark.gpu
def test_lpips_on_the_card_matches_cpu(cuda_device, tmp_path, monkeypatch):
    """LPIPS with seeded random VGG16 weights, card against CPU within 1e-5."""
    from gaussiangrasper_torch.utils import perceptual

    path = tmp_path / "vgg16.npz"
    np.savez(path, **perceptual.random_weights(1))
    monkeypatch.setenv("GGT_VGG16_WEIGHTS", str(path))
    perceptual.reset_cache()
    try:
        rng = np.random.default_rng(5)
        a = rng.random((96, 128, 3)).astype(np.float32)
        b = np.clip(a + rng.normal(0, 0.1, a.shape), 0, 1).astype(np.float32)
        card, cpu = perceptual.lpips(a, b, device=cuda_device), perceptual.lpips(a, b, device="cpu")
        assert cpu > 0 and abs(card - cpu) <= 1e-5, (card, cpu)
    finally:
        perceptual.reset_cache()


@pytest.mark.gpu
@pytest.mark.parametrize("stage", ["filter", "kmeans", "masks"])
def test_segment_on_the_card_matches_cpu(cuda_device, tmp_path, stage):
    """The classic segmentation backend at 800x800 on a tabletop frame: the
    bilateral filter, the k-means labels (K 8, one generator state on both)
    and the instance masks on the card bit-equal to the CPU path. Every
    card op is a single IEEE operation, and the order-dependent sums run
    on the host either way."""
    import time

    from gaussiangrasper_torch.data.synthetic import generate_tabletop
    from gaussiangrasper_torch.scripts.segment import classic_instance_masks
    from gaussiangrasper_torch.utils import cv_segment as cs
    from gaussiangrasper_torch.utils.image_io import read_image

    scene = generate_tabletop(tmp_path / "scene", width=800, height=800, n_views=1,
                              seed_points=64)
    img = read_image(next((scene / "images").iterdir()))[..., :3]
    filtered = cs.bilateral_filter(img, device="cpu")
    seconds = {}

    def timed(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        seconds[name] = time.perf_counter() - t0
        return out

    if stage == "filter":
        card = timed("cuda", lambda: cs.bilateral_filter(img, device=cuda_device).cpu())
        host = filtered
    elif stage == "kmeans":
        z = filtered.reshape(-1, 3).float()
        card = timed("cuda", lambda: cs.kmeans_pp(z, 8, rng=cs.OpenCVRNG(3), device=cuda_device))
        host = timed("cpu", lambda: cs.kmeans_pp(z, 8, rng=cs.OpenCVRNG(3), device="cpu"))
    else:
        card = timed("cuda", lambda: classic_instance_masks(img, rng=cs.OpenCVRNG(),
                                                            device=cuda_device))
        host = timed("cpu", lambda: classic_instance_masks(img, rng=cs.OpenCVRNG(), device="cpu"))
        assert host.max() >= 1
    print("segment_card_vs_cpu", stage, json.dumps(seconds))
    np.testing.assert_array_equal(np.asarray(card), np.asarray(host))


def _voxel_layout(name: str):
    """tests/test_torch_voxel_cluster.py's layouts, and three of the card's
    own: a one-voxel-wide chain of 2,000 voxels (diagonal neighbours, so
    deep unions), a full 32^3 block (every neighbour present), and a blob
    with strays tens of metres out (prod(dims) past 2^31)."""
    from test_torch_voxel_cluster import layout

    if name == "chain":
        i = np.arange(2000, dtype=np.float64)
        return (np.stack([i, i, i], 1) + 0.5) * 0.02, 0.02
    if name == "block32":
        g = np.stack(np.meshgrid(*[np.arange(32)] * 3, indexing="ij"), -1).reshape(-1, 3)
        return (g + 0.5) * 0.02, 0.02
    if name == "wide":
        rng = np.random.default_rng(31)
        return np.concatenate([rng.normal(0.0, 0.1, (3000, 3)),
                               rng.uniform(-30.0, 30.0, (200, 3))]), 0.02
    return layout(name)


VOXEL_CASES = [(n, d) for n in ("blobs", "tie_long_first", "tie_short_first", "faces")
               for d in ("float32", "float64")] + [(n, "float64") for n in ("chain", "block32",
                                                                            "wide")]


@pytest.mark.gpu
@pytest.mark.parametrize("name,dtype", VOXEL_CASES, ids=lambda v: v)
def test_voxel_cluster_kernel_roots_equal_host_roots(cuda_device, name, dtype):
    """csrc/voxel_cluster.cu's roots equal the host union-find's, entry for
    entry, on five launches (the unions meet in another order each time),
    and `largest_component`'s mask on the card equals the host path's."""
    from gaussiangrasper_torch.ops import voxel_cluster as vc
    from test_torch_voxel_cluster import voxel_keys

    points, voxel = _voxel_layout(name)
    keys, inverse, dims = voxel_keys(points.astype(dtype), voxel)
    if name == "wide":
        assert np.prod(dims, dtype=object) > 2 ** 31
    want = vc.roots_host(keys, dims)
    keys_t = torch.as_tensor(keys, device=cuda_device)
    before = _build.launches.copy()
    for _ in range(5):
        np.testing.assert_array_equal(vc.roots_cuda(keys_t, dims).cpu().numpy(), want)
    assert launched_since(before, "ggt_voxel_cluster") == (5,)
    card = vc.largest_component(keys, inverse, dims)
    assert launched_since(before, "ggt_voxel_cluster") == (6,)
    with mock.patch("torch.cuda.is_available", return_value=False):
        host = vc.largest_component(keys, inverse, dims)
    np.testing.assert_array_equal(card, host)
    assert 0 < card.sum()


@pytest.mark.gpu
def test_grasp_request_on_the_card_matches_cpu(cuda_device):
    """`grasp_request` on a served state on the card (the kernels label the
    voxels) against the same state on the CPU (the host union-find): equal
    selection and cluster indices, the pose and score within 1e-5 (the axis
    a line: up to sign). The threshold lies in the widest gap between the
    CPU's scores about their median, so no score sits near it."""
    from gaussiangrasper_torch.engine.weights import state_from_numpy
    from gaussiangrasper_torch.scripts import grasp

    rng = np.random.default_rng(21)
    f32 = np.float32
    blobs = [rng.normal(c, 0.03, (3000, 3)) for c in ([0, 0, -3], [0.4, 0, -3], [0, 0.4, -3])]
    means = np.concatenate(blobs + [rng.uniform(-1, 1, (3000, 3)) + [0, 0, -3]]).astype(f32)
    n = len(means)
    q = rng.standard_normal((n, 4)).astype(f32)
    arrays = {"means": means, "log_scales": rng.normal(-4, 0.5, (n, 3)).astype(f32),
              "quats": q / np.linalg.norm(q, axis=1, keepdims=True),
              "opacity_logits": rng.normal(0, 1, n).astype(f32),
              "sh_coeffs": rng.normal(0, 0.3, (n, 16, 3)).astype(f32),
              "features": rng.normal(0, 1, (n, 32)).astype(f32)}
    fea = {"w0": rng.normal(0, 0.2, (32, 128)).astype(f32), "b0": np.zeros(128, f32),
           "w1": rng.normal(0, 0.1, (128, 512)).astype(f32), "b1": np.zeros(512, f32)}
    alive = rng.random(n) > 0.05
    state = state_from_numpy(arrays, alive, fea, step=4000)
    query = torch.as_tensor(rng.standard_normal(512).astype(f32))
    canon = torch.as_tensor(rng.standard_normal((3, 512)).astype(f32))
    rel = grasp.gaussian_relevancy(state.fea_up.state_dict(), state.field.features, query,
                                   canon).numpy()
    s = np.sort(rel[alive])[len(rel) // 2 - 200:len(rel) // 2 + 200]
    g = int(np.argmax(np.diff(s)))
    thr = float(s[g] + s[g + 1]) / 2
    with mock.patch("torch.cuda.is_available", return_value=False):
        want = grasp.grasp_request(state, query, canon, thr, 0.02)
    got = grasp.grasp_request(state.to(cuda_device), query.to(cuda_device), canon.to(cuda_device),
                              thr, 0.02)
    for k in ("selected", "cluster"):
        np.testing.assert_array_equal(got[k], want[k])
    assert got["num_gaussians"] == want["num_gaussians"]
    assert 0 < len(got["cluster"]) < len(got["selected"])
    for k in ("position", "approach", "width", "score"):
        np.testing.assert_allclose(got[k], want[k], atol=1e-5, rtol=0)
    a, b = np.asarray(got["axis"]), np.asarray(want["axis"])
    assert min(np.abs(a - b).max(), np.abs(a + b).max()) <= 1e-5


# (image H, W, C, the map's channels [lo, hi) of the image, rows; None: efd-train-800's batch)
GATHER_CASES = {"padded": (800, 800, 39, 3, 35, None), "random": (96, 128, 39, 3, 35, 20_000),
                "f3": (96, 128, 39, 0, 3, 20_000), "f6": (96, 128, 39, 3, 9, 20_000)}


def _gather_rows(h, w, n, seed=31):
    """(N, 2) int32 rows: chip_smoke.py's `gather_rows` where n is None
    (efd-train-800's 52,200, 44,800 of them the sampler's padding at (0,
    0)), else n seeded pixels, a quarter of them drawn from 16 pixels (runs
    of equal pixels within and across warps)."""
    import chip_smoke

    if n is None:
        return chip_smoke.gather_rows(seed)
    rng = np.random.default_rng(seed)
    rows = np.stack([rng.integers(0, h, n), rng.integers(0, w, n)], 1)
    hot = rng.random(n) < 0.25
    rows[hot] = rows[rng.integers(0, 16, int(hot.sum()))]
    return rows.astype(np.int32)


def _assert_scatter_close(got, idx, g_out, w):
    """got (H, W, F) against the float64 sum of g_out's rows into their
    pixels: within 1e-6 of the sum of the terms' magnitudes at each entry,
    the scale of any summation order's rounding (the kernel sums a pixel's
    rows in warps, then by float atomics in an order that varies; the plain
    path walks them one by one)."""
    key = idx[:, 0].long() * w + idx[:, 1].long()
    f = g_out.shape[1]
    ref = torch.zeros(got.shape[0] * w, f, dtype=torch.float64, device=got.device)
    mass = torch.zeros_like(ref).index_add_(0, key, g_out.double().abs())
    ref.index_add_(0, key, g_out.double())
    err = (got.reshape(-1, f).double() - ref).abs()
    assert bool((err <= 1e-6 * mass).all()), float((err / mass.clamp(min=1e-300)).max())


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(GATHER_CASES))
def test_pixel_gather_kernel_matches_plain(cuda_device, name):
    """`gather_pixels` through the kernels against the plain advanced index
    on the card, both reading the feature slice of one image: the forward
    bit-equal (a copy), each path's gradient as `_assert_scatter_close`
    holds it and zero outside the slice, one launch of each kernel a call;
    efd-train-800's padded batch (44,800 rows at (0, 0)), seeded rows with
    hot pixels at F 32 (the float4 path), F 3 (one channel a lane) and F 6
    (float2)."""
    from gaussiangrasper_torch.ops.pixel_gather import gather_pixels

    h, w, c, lo, hi, n = GATHER_CASES[name]
    gen = torch.Generator(cuda_device).manual_seed(32)
    img = torch.rand(h, w, c, device=cuda_device, generator=gen)
    idx = torch.as_tensor(_gather_rows(h, w, n), device=cuda_device)
    if name == "padded":
        assert int((idx == 0).all(1).sum()) >= 44_800
    g_out = torch.randn(idx.shape[0], hi - lo, device=cuda_device, generator=gen)
    got = {}
    for path in ("kernel", "plain"):
        leaf = img.clone().requires_grad_(True)
        fea = leaf[..., lo:hi]
        before = _build.launches.copy()
        out = gather_pixels(fea, idx) if path == "kernel" else fea[idx[:, 0], idx[:, 1]]
        assert launched_since(before, *GATHER) == ((1, 0) if path == "kernel" else (0, 0))
        (grad,) = torch.autograd.grad(out, leaf, g_out)
        assert launched_since(before, *GATHER) == ((1, 1) if path == "kernel" else (0, 0))
        got[path] = (out, grad)
    assert torch.equal(got["kernel"][0], got["plain"][0])
    for _, grad in got.values():
        assert not grad[..., :lo].any() and not grad[..., hi:].any()
        _assert_scatter_close(grad[..., lo:hi], idx, g_out, w)


@pytest.mark.gpu
def test_pixel_gather_bwd_on_unaligned_rows_and_no_rows(cuda_device):
    """The backward kernel where g_out starts 4 bytes past a float4 edge
    (F 32: the one-channel path) as `_assert_scatter_close` holds it, and
    an empty gather: no launch, a (0, F) output and a zero gradient."""
    from gaussiangrasper_torch.ops import pixel_gather as pg

    h, w, f = 96, 128, 32
    idx = torch.as_tensor(_gather_rows(h, w, 5000), device=cuda_device)
    gen = torch.Generator(cuda_device).manual_seed(33)
    g_out = torch.randn(idx.shape[0] * f + 1, device=cuda_device, generator=gen)[1:].view(-1, f)
    assert g_out.is_contiguous() and g_out.data_ptr() % 16 != 0
    _assert_scatter_close(pg.pixel_gather_bwd_cuda(idx, g_out, h, w), idx, g_out, w)
    leaf = torch.rand(h, w, 39, device=cuda_device).requires_grad_(True)
    before = _build.launches.copy()
    out = pg.gather_pixels(leaf[..., 3:35], idx[:0])
    (grad,) = torch.autograd.grad(out.sum(), leaf)
    assert out.shape == (0, f) and not grad.any()
    assert launched_since(before, *GATHER) == (0, 0)


@pytest.mark.gpu
def test_pixel_gather_raises_for_a_float64_map_on_the_card(cuda_device):
    """On the card the device alone picks the kernels: a float64 map raises
    the kernels' ValueError, and nothing is launched or quietly run by the
    plain index."""
    from gaussiangrasper_torch.ops.pixel_gather import gather_pixels

    fea = torch.rand(8, 9, 5, dtype=torch.float64, device=cuda_device)
    idx = torch.zeros(3, 2, dtype=torch.int32, device=cuda_device)
    before = _build.launches.copy()
    with pytest.raises(ValueError, match="float32"):
        gather_pixels(fea, idx)
    assert launched_since(before, *GATHER) == (0, 0)
