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
from gaussiangrasper_torch.probes import kernels as pk

W, H, STEP = 128, 96, 4000


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
    _assert_grads_close(_per_gaussian(args, got), _per_gaussian(args, want), channels)


# counts around K2's 8-row sub-chunks and 32-row batches, one tile each (13 tiles of 32 px,
# 3 a row of the image: an odd count)
STRADDLE_COUNTS = (0, 1, 7, 8, 9, 31, 32, 33, 63, 64, 65, 129, 200)


def _straddle_args(device, channels, opaque):
    """A synthetic stream, one row per Gaussian, centred in its tile. With
    `opaque`, splats far wider than a tile at opacity 0.999: every pixel of
    a tile with two rows or more composites its first row and is cut at the
    second."""
    rng = np.random.default_rng(3)
    tw, ts = 3, 32
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
    before = (rc.composite_pairs_bwd.launches, rc.composite_pairs_bwd2.launches)
    got = rc.composite_pairs_bwd(*bargs)
    got2 = rc.composite_pairs_bwd2(*bargs)
    want = rc.composite_pairs_bwd_plain(*bargs)
    torch.cuda.synchronize()
    assert (rc.composite_pairs_bwd.launches, rc.composite_pairs_bwd2.launches) == \
        (before[0] + 1, before[1] + 1)
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
    before = rc.composite_tables_bwd.launches
    got = rc.composite_tables_bwd(*bargs)
    want = rc.composite_tables_bwd_plain(*bargs)
    torch.cuda.synchronize()
    assert rc.composite_tables_bwd.launches == before + 1
    _assert_grads_close(got.reshape(-1, attrs.shape[1]), want.reshape(-1, attrs.shape[1]),
                        channels)


@pytest.mark.gpu
@pytest.mark.parametrize("starts", [[13], [0, 3, 77, 1001, 4096 - 128]])
def test_p2_bit_equal_to_plain(cuda_device, starts):
    """P2's pieces at row 0, at offsets not a multiple of 8, at rows - 128."""
    src = torch.randn(4096, 128, generator=torch.Generator(device=cuda_device).manual_seed(8),
                      device=cuda_device)
    s = torch.tensor(starts, dtype=torch.int32, device=cuda_device)
    before = pk.read_at.launches
    got = pk.read_at(src, s)
    torch.cuda.synchronize()
    assert pk.read_at.launches == before + 1
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
    before = (rc.composite_pairs_fwd.launches, rc.composite_pairs_fwd2.launches)
    got = rc.composite_pairs_fwd2(*args)
    want = rc.composite_pairs_fwd(*args)
    torch.cuda.synchronize()
    assert (rc.composite_pairs_fwd.launches, rc.composite_pairs_fwd2.launches) == \
        (before[0] + 1, before[1] + 1)
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
    before = rc.composite_pairs_bwd2.launches
    got = _per_gaussian(args, rc.composite_pairs_bwd2(*bargs))
    k2 = _per_gaussian(args, rc.composite_pairs_bwd(*bargs))
    plain = _per_gaussian(args, rc.composite_pairs_bwd_plain(*bargs))
    torch.cuda.synchronize()
    assert rc.composite_pairs_bwd2.launches == before + 1
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
        launches = (rc.composite_pairs_fwd2.launches, rc.composite_pairs_bwd2.launches)
        _, m = train_step(state, cam, batch, cfg)
        losses[tp] = float(m["loss"])
        moved = (rc.composite_pairs_fwd2.launches - launches[0],
                 rc.composite_pairs_bwd2.launches - launches[1])
        assert moved == ((1, 1) if tp == 2 else (0, 0))
    assert np.isfinite(losses[1])
    assert abs(losses[2] - losses[1]) <= 1e-6 * abs(losses[1])


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
    before = rc.composite_tables_fwd.launches
    got = rc.composite_tables_fwd(*targs)
    want = rc.composite_tables_fwd_plain(*targs)
    k1_out = rc.composite_pairs_fwd(*k1)
    torch.cuda.synchronize()
    assert rc.composite_tables_fwd.launches == before + 1
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
    before = rc.composite_tables_bwd.launches
    got = rc.scatter_table(tile_gidx, n, rc.composite_tables_bwd(*bargs))
    plain = rc.scatter_table(tile_gidx, n, rc.composite_tables_bwd_plain(*bargs))
    k2 = _per_gaussian(k1, rc.composite_pairs_bwd(*(k1[:5] + (g_out, g_alpha, logt, ncomp)
                                                    + k1[5:])))
    torch.cuda.synchronize()
    assert rc.composite_tables_bwd.launches == before + 1
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
    before = (pk.affine.launches, pk.read_at.launches, pk.write_at.launches)
    got = pk.write_at(vals, starts, 512)
    want = pk.write_at_plain(vals, starts, 512)
    covered = pk.covered_rows(starts, 512).to(cuda_device)
    torch.cuda.synchronize()
    assert torch.equal(got[covered], want[covered])
    assert (pk.affine.launches, pk.read_at.launches, pk.write_at.launches) == \
        (before[0], before[1], before[2] + 1)


@pytest.mark.gpu
def test_table_kernels_with_unsupported_channels_raise(cuda_device):
    one = torch.ones(1, dtype=torch.int32, device=cuda_device)
    tables = torch.zeros(1, 1, 6 + 5, device=cuda_device)
    bg = torch.zeros(5, device=cuda_device)
    with pytest.raises(ValueError, match="built for C"):
        rc.composite_tables_fwd(one, tables, bg, 1, 32)
    g = torch.zeros(1, 1024, device=cuda_device)
    with pytest.raises(ValueError, match="built for C"):
        rc.composite_tables_bwd(one, tables, bg, torch.zeros(1, 1024, 5, device=cuda_device), g,
                                g, g, 1, 32)
    tables7 = torch.zeros(1, 1, 6 + 7, device=cuda_device)
    with pytest.raises(ValueError, match="built for C"):  # K3 takes C 7, K4 does not
        rc.composite_tables_bwd(one, tables7, torch.zeros(7, device=cuda_device),
                                torch.zeros(1, 1024, 7, device=cuda_device), g, g, g, 1, 32)
