"""PyTorch port vs the JAX package: the table path (K3 / K4) and the
platform probes (P1-P3).

Inputs are made with numpy from a seed and go through both packages on the
CPU (JAX forced there by conftest; its Pallas kernels run in interpret
mode). Tolerances and their reasons:

- binning: the table and every integer field bit-equal.
- K3's plain version vs `rasterize_pallas._call_fwd` (interpret): out /
  alpha / logt at atol 1e-5 / rtol 1e-4 (float32, a sequential walk vs
  triangular-matmul prefix sums, other exp / log1p rounding).
- K4's plain version vs `_call_bwd` (interpret), row by row: max error
  <= 1e-5 of each column group's max |value| (K2's tolerance in
  tests/test_torch_train.py).
- gradients through `composite_binned`, `rasterize_projected`, `render`
  and `train_loss`: max error <= 1e-4 of the leaf's max |gradient|
  (float32 sums over pixels and slots in another order).
- probes: P1-P3 exact (P3 on the rows some block covers).
"""

import dataclasses
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussiangrasper_torch import _build
from gaussiangrasper_torch.models.efd import params_from_numpy
from gaussiangrasper_torch.models.model import render as t_render
from gaussiangrasper_torch.models.model import train_loss as t_train_loss
from gaussiangrasper_torch.ops import rasterize_cuda as rc
from gaussiangrasper_torch.ops.rasterize import RasterizeConfig, bin_gaussians, rasterize_projected
from gaussiangrasper_torch.probes import copy_probe, kernel_probe
from gaussiangrasper_torch.probes import kernels as pk
from gaussiangrasper_tpu.models.model import render as j_render
from gaussiangrasper_tpu.models.model import train_loss as j_train_loss
from gaussiangrasper_tpu.ops import rasterize_pallas as rp
from gaussiangrasper_tpu.ops.rasterize import RasterizeConfig as JConfig
from gaussiangrasper_tpu.ops.rasterize import bin_gaussians as j_bin
from gaussiangrasper_tpu.ops.rasterize import rasterize_projected as j_rasterize
from tests.test_torch_core import H, W, T, close, make_scene, project_both
from tests.test_torch_rasterize import BIN_CASES, saturated_scene
from tests.test_torch_train import (
    cameras, close_scaled, configs, fea_up_arrays, jfield_of, make_batch, make_field, tfield_of,
)

ROOT = Path(__file__).resolve().parent.parent
TS = 16  # 4 x 3 tiles at 64 x 48: a pile at the centre leaves the corner tiles empty
TW = -(-W // TS)


def _scene_inputs(case):
    spec = BIN_CASES[case]
    scene = make_scene(20 + len(case), spec["n"])
    if spec.get("tie"):
        scene["means"][1::2, 2] = scene["means"][0::2, 2]
    if spec.get("big"):
        scene["scales"] *= 6.0
    jp, tp = project_both(scene)
    return scene, jp, type(tp)(*(T(x) for x in jp)), spec["cfg"]


@pytest.mark.parametrize("keep_pairs", [False, True])
@pytest.mark.parametrize("case", list(BIN_CASES))
def test_bin_gaussians_table_bit_equal(case, keep_pairs):
    """The JAX keywords and defaults: with build_table (the default) the
    table and the integer fields are bit-equal; with keep_pairs the stream
    too, and without it neither package keeps one."""
    scene, jp, tp, cfg = _scene_inputs(case)
    kw = {} if not keep_pairs else dict(keep_pairs=True)  # build_table=True by default
    jb = j_bin(jp, W, H, JConfig(**cfg), opacities=jnp.asarray(scene["opacities"]), **kw)
    tb = bin_gaussians(tp, W, H, RasterizeConfig(**cfg), opacities=T(scene["opacities"]), **kw)
    assert tb.tile_gidx.dtype == torch.int32
    np.testing.assert_array_equal(tb.tile_gidx.numpy(), np.asarray(jb.tile_gidx))
    for name in ("tile_count", "num_tiles_hit", "overflow", "dropped_tiles"):
        np.testing.assert_array_equal(getattr(tb, name).numpy(), np.asarray(getattr(jb, name)),
                                      err_msg=name)
    if keep_pairs:
        valid = min(int(np.asarray(jb.tile_count).sum()), jb.pair_gidx.shape[0])
        np.testing.assert_array_equal(tb.pair_gidx.numpy()[:valid],
                                      np.asarray(jb.pair_gidx)[:valid])
        for name in ("pair_starts", "pair_overflow"):
            np.testing.assert_array_equal(getattr(tb, name).numpy(), np.asarray(getattr(jb, name)))
    else:
        assert tb.pair_gidx is None and jb.pair_gidx is None and tb.pair_overflow is None
    if case == "overflow":
        assert int(tb.overflow) > 0 and (tb.tile_gidx >= 0).sum(1).max() == tb.tile_gidx.shape[1]


def _table_inputs(n_channels, k=150):
    """Table-path inputs on a saturated pile at the image centre, 16 px tiles
    and K = 150 (not a multiple of 128): the corner tiles are empty, the
    central ones walk a full K (count = K, the cut engaged)."""
    scene = saturated_scene()
    n = scene["means"].shape[0]
    scene["colors"] = np.random.default_rng(7).uniform(size=(n, n_channels)).astype(np.float32)
    jp, tp = project_both(scene)
    tp = type(tp)(*(T(x) for x in jp))
    cfg = dict(tile_size=TS, max_gaussians_per_tile=k)
    jb = j_bin(jp, W, H, JConfig(**cfg), opacities=jnp.asarray(scene["opacities"]))
    tb = bin_gaussians(tp, W, H, RasterizeConfig(**cfg), opacities=T(scene["opacities"]))
    counts = np.minimum(np.asarray(jb.tile_count), k).astype(np.int32)
    assert (counts == 0).any() and (counts == k).any()
    bg = np.linspace(0.1, 0.9, n_channels).astype(np.float32)
    leaves = (np.asarray(jp.xys), np.asarray(jp.conics), scene["opacities"], scene["colors"])
    return jb, tb, counts, leaves, bg


def _padded_jax_tables(jb, leaves):
    tables = rp._gather_tables(jb.tile_gidx, *map(jnp.asarray, leaves))
    return rp._pad_k(tables, (-tables.shape[1]) % rp.KC)


@pytest.mark.parametrize("n_channels", [3, 39])
def test_k3_plain_matches_pallas_interpret(n_channels):
    jb, tb, counts, leaves, bg = _table_inputs(n_channels)
    jtables = _padded_jax_tables(jb, leaves)
    ref = rp._call_fwd(jnp.asarray(counts), jtables, jnp.asarray(bg)[None], TW, TS, interpret=True)
    tables = rc.gather_tables(tb.tile_gidx, *map(T, leaves))
    np.testing.assert_array_equal(tables.numpy(), np.asarray(jtables)[:, :150])  # -1: zero rows
    before = _build.launches.copy()
    got = rc.composite_tables_fwd(T(counts), tables, T(bg), TW, TS)
    assert _build.launches == before  # CPU tensors: the plain version
    for name, a, b in zip(("out", "alpha", "logt"), got, ref):
        close(a, b, atol=1e-5, rtol=1e-4, msg=name)
    empty = counts == 0
    close(got[0][torch.as_tensor(empty)], np.broadcast_to(bg, (int(empty.sum()), TS * TS, n_channels)))
    full = torch.as_tensor(counts == 150)
    assert (got[3][full] < 150).any()  # the cut engaged in a full tile


@pytest.mark.parametrize("n_channels", [3, 39])
def test_k4_plain_matches_pallas_interpret(n_channels):
    jb, tb, counts, leaves, bg = _table_inputs(n_channels)
    jtables = _padded_jax_tables(jb, leaves)
    _, _, jlogt = rp._call_fwd(jnp.asarray(counts), jtables, jnp.asarray(bg)[None], TW, TS,
                               interpret=True)
    rng = np.random.default_rng(3)
    t, p = counts.shape[0], TS * TS
    g_out = rng.normal(size=(t, p, n_channels)).astype(np.float32)
    g_alpha = rng.normal(size=(t, p)).astype(np.float32)  # nonzero: sky_alpha_reg's term
    ref = rp._call_bwd(jnp.asarray(counts), jtables, jnp.asarray(bg), jnp.asarray(g_out),
                       jnp.asarray(g_alpha), jlogt, TW, TS, interpret=True)
    ref = np.asarray(ref)[:, :150]
    tables = rc.gather_tables(tb.tile_gidx, *map(T, leaves))
    _, _, logt, ncomp = rc.composite_tables_fwd(T(counts), tables, T(bg), TW, TS)
    before = _build.launches.copy()
    got = rc.composite_tables_bwd(T(counts), tables, T(bg), T(g_out), T(g_alpha), logt, ncomp,
                                  TW, TS)
    assert _build.launches == before
    assert got.shape == tables.shape
    for name, lo, hi in (("dxy", 0, 2), ("dconic", 2, 5), ("dopacity", 5, 6),
                         ("dcolor", 6, 6 + n_channels)):
        close_scaled(got[..., lo:hi], ref[..., lo:hi], 1e-5, msg=name)
    assert float(np.abs(ref).max()) > 0.1
    assert not got[torch.as_tensor(counts == 0)].any()


@pytest.mark.parametrize("n_channels", [3, 39])
def test_composite_binned_matches_jax_vjp(n_channels):
    jb, tb, counts, leaves, bg = _table_inputs(n_channels)
    args = tuple(map(jnp.asarray, leaves)) + (jnp.asarray(bg),)
    (out, alpha), vjp = jax.vjp(
        lambda *a: rp.composite_binned(jb.tile_gidx, jb.tile_count, *a, TW, TS), *args)
    rng = np.random.default_rng(4)
    g_out = rng.normal(size=out.shape).astype(np.float32)
    g_alpha = rng.normal(size=alpha.shape).astype(np.float32)
    jgrads = vjp((jnp.asarray(g_out), jnp.asarray(g_alpha)))

    targs = [T(np.asarray(a)).requires_grad_(True) for a in args]
    tout, talpha = rc.composite_binned(tb.tile_gidx, tb.tile_count, *targs, TW, TS)
    close(tout, out, atol=1e-5, rtol=1e-4, msg="out")
    close(talpha, alpha, atol=1e-5, rtol=1e-4, msg="alpha")
    tgrads = torch.autograd.grad((tout * T(g_out)).sum() + (talpha * T(g_alpha)).sum(), targs)
    for name, a, b in zip(("xys", "conics", "opacities", "colors", "bg"), tgrads, jgrads):
        close_scaled(a, b, 1e-4, msg=name)
        assert float(np.abs(np.asarray(b)).max()) > 0, name


def test_composite_tiles_matches_jax():
    """The kernel probe's stage-2 shapes: 4 tiles of 8x8 px, 128 slots, C 7."""
    inputs = kernel_probe.tiny_tile_inputs(seed=3)
    ref = rp.composite_tiles(*(jnp.asarray(x.numpy()) for x in inputs), tw=2, ts=8)
    got = rc.composite_tiles(*inputs, tw=2, ts=8)
    assert got[0].shape == (4, 64, 7)
    for name, a, b in zip(("out", "alpha"), got, ref):
        close(a, b, atol=1e-5, rtol=1e-4, msg=name)
    assert float(got[1].max()) > 0.5


def test_rasterize_projected_table_bins_matches_jax():
    """`rasterize_projected(bins=<table bins>)` routes to composite_binned:
    image / alpha and the gradients of xys, conics, colours, opacities and
    bg against the JAX function with the Pallas backend; and the image
    equals the pair path's bit for bit (K3's arithmetic is K1's)."""
    scene = make_scene(12, 300)
    jp, tp0 = project_both(scene)
    rng = np.random.default_rng(13)
    wimg = rng.normal(size=(H, W, 3)).astype(np.float32)
    walpha = rng.normal(size=(H, W)).astype(np.float32)
    bg = np.array([0.1, 0.2, 0.3], np.float32)
    leaves = [np.asarray(jp.xys), np.asarray(jp.conics), scene["colors"], scene["opacities"], bg]
    jcfg = JConfig(tile_size=TS, backend="pallas")
    jbins = j_bin(jp, W, H, jcfg, opacities=jnp.asarray(scene["opacities"]))

    def jloss(xys, conics, colors, opac, bgj):
        out = j_rasterize(jp._replace(xys=xys, conics=conics), colors, opac, bgj, W, H, jcfg,
                          bins=jbins)
        return jnp.sum(out["image"] * wimg) + jnp.sum(out["alpha"] * walpha), out

    (_, jout), want = jax.value_and_grad(jloss, argnums=tuple(range(5)), has_aux=True)(
        *map(jnp.asarray, leaves))
    cfg = RasterizeConfig(tile_size=TS)
    tl = [T(x).requires_grad_(True) for x in leaves]
    tp = type(tp0)(*(T(x) for x in jp))._replace(xys=tl[0], conics=tl[1])
    bins = bin_gaussians(tp, W, H, cfg, opacities=tl[3].detach())
    out = rasterize_projected(tp, tl[2], tl[3], tl[4], W, H, cfg, bins=bins)
    assert out["bins"].pair_gidx is None and out["bins"].tile_gidx is not None
    close(out["image"], jout["image"], atol=1e-5, rtol=1e-4, msg="image")
    close(out["alpha"], jout["alpha"], atol=1e-5, rtol=1e-4, msg="alpha")
    loss = (out["image"] * T(wimg)).sum() + (out["alpha"] * T(walpha)).sum()
    for name, g, ref in zip(("xys", "conics", "colors", "opacities", "bg"),
                            torch.autograd.grad(loss, tl), want):
        close_scaled(g, ref, 1e-4, msg=name)
        assert float(np.abs(np.asarray(ref)).max()) > 0, name
    with torch.no_grad():
        pairs = rasterize_projected(tp, tl[2], tl[3], tl[4], W, H, cfg)
    assert int(pairs["bins"].pair_overflow) == 0 and int(bins.overflow) == 0
    assert torch.equal(pairs["image"], out["image"].detach())


def _compositors(jcfg_raster):
    """The same table-path closure in both packages: bin with the table,
    then rasterize_projected(bins=...) (the JAX one on its Pallas backend)."""
    jraster = dataclasses.replace(jcfg_raster, backend="pallas")

    def j_table(proj, colors, opac, bg, w, h, cfg):
        bins = j_bin(proj, w, h, jraster, opacities=opac, build_table=True)
        return j_rasterize(proj, colors, opac, bg, w, h, jraster, bins=bins)

    def t_table(proj, colors, opac, bg, w, h, cfg):
        bins = bin_gaussians(proj, w, h, cfg, opacities=opac.detach(), build_table=True)
        return rasterize_projected(proj, colors, opac, bg, w, h, cfg, bins=bins)

    return j_table, t_table


def test_render_with_table_compositor_matches_jax():
    field, alive = make_field(5)
    jcfg, tcfg = configs()
    jcam, tcam = cameras()
    j_table, t_table = _compositors(jcfg.raster)
    jo = jax.jit(lambda f: j_render(f, jnp.asarray(alive), jcam, 9, jcfg, compositor=j_table))(
        jfield_of(field))
    before = _build.launches.copy()
    with torch.no_grad():
        to = t_render(tfield_of(field), torch.as_tensor(alive), tcam, 9, tcfg, compositor=t_table)
    assert to["bins"].tile_gidx is not None and to["bins"].pair_gidx is None
    assert _build.launches == before
    for k in ("rgb", "feature", "depth", "normal", "alpha"):
        close(to[k], jo[k], atol=1e-5, rtol=1e-4, msg=k)


def test_train_loss_with_table_compositor_matches_jax():
    field, alive = make_field(7)
    batch = make_batch(8)
    fea = fea_up_arrays()
    jcfg, tcfg = configs(sky_alpha_reg=0.3)
    jcam, tcam = cameras()
    j_table, t_table = _compositors(jcfg.raster)
    step = 10

    def f(ms):
        return j_train_loss(ms, jnp.asarray(alive), jcam, {k: jnp.asarray(v) for k, v in batch.items()},
                            step, jcfg, compositor=j_table)

    jms = {"field": jfield_of(field), "fea_up": {k: jnp.asarray(v) for k, v in fea.items()}, "pose": None}
    (jtotal, jaux), jg = jax.jit(jax.value_and_grad(f, has_aux=True))(jms)

    tf = tfield_of(field, grad=True)
    tfea = params_from_numpy(fea)
    total, aux = t_train_loss({"field": tf, "fea_up": tfea}, torch.as_tensor(alive), tcam,
                              {k: torch.as_tensor(v) for k, v in batch.items()}, step, tcfg,
                              compositor=t_table)
    for k, v in jaux["loss_dict"].items():
        close(aux["loss_dict"][k], v, atol=1e-6, rtol=1e-4, msg=k)
    close(total, jtotal, atol=1e-6, rtol=1e-4, msg="total")
    for k in ("overflow", "dropped_tiles", "pair_overflow"):
        assert int(aux[k]) == int(jaux[k]) == 0, k
    grads = torch.autograd.grad(total, list(tf))
    for name, a in zip(tf._fields, grads):
        close_scaled(a, getattr(jg["field"], name), 1e-4, msg=name)


def _dma_probe():
    spec = importlib.util.spec_from_file_location("dma_probe", ROOT / "scripts_dev" / "dma_probe.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_copy_probe_plain_matches_dma_probe():
    """P2 / P3's plain versions against the TPU probe's kernels, which run
    interpreted on the CPU: reads exact, writes exact on the covered rows
    (uncovered rows are unspecified in both)."""
    dma = _dma_probe()
    x = np.arange(dma.ROWS * dma.COLS, dtype=np.float32).reshape(dma.ROWS, dma.COLS)
    offs = np.array([3, 77, 1001, 0], np.int32)
    ref = np.asarray(dma.read_at(jnp.asarray(x), jnp.asarray(offs)))
    got = pk.read_at(T(x), T(offs))
    np.testing.assert_array_equal(got.numpy(), ref)

    starts = np.array([0, 100, 200, 150], np.int32)  # the last block overlaps two earlier ones
    vals = np.random.default_rng(5).normal(size=(4, pk.BLOCK_ROWS, pk.COLS)).astype(np.float32)
    ref = np.asarray(dma.write_at(jnp.asarray(vals), jnp.asarray(starts), rows=512))
    got = pk.write_at(T(vals), T(starts), 512)
    covered = pk.covered_rows(T(starts), 512)
    assert int(covered.sum()) == 328
    np.testing.assert_array_equal(got.numpy()[covered.numpy()], ref[covered.numpy()])
    np.testing.assert_array_equal(got.numpy()[150:278], vals[3])


def test_affine_plain_is_two_x_plus_one():
    x = torch.arange(8 * 128, dtype=torch.float32).reshape(8, 128) - 300.5
    before = _build.launches.copy()
    assert torch.equal(pk.affine(x), x * 2 + 1)
    assert _build.launches == before


@pytest.mark.parametrize("probe", ["kernel_probe", "copy_probe"])
def test_probe_cli_on_cpu(probe, capsys):
    mod = {"kernel_probe": kernel_probe, "copy_probe": copy_probe}[probe]
    assert mod.main(["--device", "cpu"]) == 0
    lines = capsys.readouterr().out
    assert "MISMATCH" not in lines
    want = ("stage1 OK", "stage2 OK", "stage3 OK", "ALL STAGES OK") if probe == "kernel_probe" \
        else ("read aligned: OK", "read UNALIGNED: OK", "write UNALIGNED overlap (later wins): OK")
    for w in want:
        assert w in lines, w


def test_probe_cli_exits_nonzero_on_mismatch(monkeypatch, capsys):
    monkeypatch.setattr(kernel_probe, "affine", lambda x: x * 2)
    assert kernel_probe.main(["--device", "cpu"]) == 1
    assert "stage1 MISMATCH" in capsys.readouterr().out
    monkeypatch.setattr(copy_probe, "read_at", lambda x, s: pk.read_at(x, s) + 1)
    assert copy_probe.main(["--device", "cpu"]) == 1
    assert "read aligned: MISMATCH" in capsys.readouterr().out


def test_table_wrappers_check_inputs():
    tables = torch.zeros(2, 4, 9)
    with pytest.raises(ValueError, match="counts must lie"):
        rc.composite_tables_fwd(torch.tensor([1, 5], dtype=torch.int32), tables, torch.zeros(3),
                                1, 8)
    with pytest.raises(ValueError, match="int32"):
        rc.composite_tables_fwd(torch.tensor([1, 2]), tables, torch.zeros(3), 1, 8)
    with pytest.raises(ValueError, match="starts must lie"):
        pk.write_at(torch.zeros(1, 128, 128), torch.tensor([400], dtype=torch.int32), 512)
    with pytest.raises(ValueError, match="starts must lie"):
        pk.read_at(torch.zeros(256, 128), torch.tensor([-1], dtype=torch.int32))
