"""PyTorch port vs the JAX package: sharded training (parallel/).

The JAX side runs on the 8-device virtual CPU mesh tests/conftest.py
forces; the port's on gloo worlds of 2 and 4 spawned ranks
(tests/test_torch_ranks.py), or in one process where the D-way split of the
tile-sharded compositor stands in for them. Tolerances and their reasons:

- The tile-sharded image and alpha, split in one process or over gloo
  ranks, against the port's unsharded `rasterize_projected`: bit-equal
  (the merged band streams hold each tile's pairs in the single-device
  order, and K1's plain version walks them alike). Their gradients:
  within 1e-5 of each leaf's max |gradient| (the gathered rows' sums
  land in another order); a factor of d would miss by 100%.
- Against the JAX `composite_tile_sharded`: image and alpha at atol 2e-5
  / rtol 1e-4, test_torch_rasterize.py's bound for the port's compositor
  against the JAX one; the stats equal, but `overflow` where the JAX
  package counts its sentinels (F8, below).
- One sharded train step against the JAX one from one state:
  test_torch_train.py's three-step tolerances (metrics atol 1e-6 / rtol
  1e-4; parameters at 2 lr per update; Adam moments and accumulators
  within 1e-4 of their max; stats atol 1e-6 / rtol 1e-3).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tests.test_engine as JE
from gaussiangrasper_torch.engine import checkpoint as tckpt
from gaussiangrasper_torch.engine import optimizers as topt
from gaussiangrasper_torch.engine.train_state import train_step as t_step
from gaussiangrasper_torch.engine.weights import train_state_from_numpy
from gaussiangrasper_torch.models.gaussian_field import FIELD_KEYS
from gaussiangrasper_torch.models.model import GaussianSplatConfig as TConfig
from gaussiangrasper_torch.ops.rasterize import RasterizeConfig as TRC
from gaussiangrasper_torch.ops.rasterize import rasterize_projected as t_rasterize_projected
from gaussiangrasper_torch.parallel import comm
from gaussiangrasper_torch.parallel import mesh as tmesh
from gaussiangrasper_torch.parallel import tile_shard as tts
from gaussiangrasper_torch.scripts import render as t_render_cli
from gaussiangrasper_torch.scripts import train as t_train_cli
from gaussiangrasper_tpu.data.synthetic import generate_tabletop
from gaussiangrasper_tpu.engine.train_state import init_train_state as j_init
from gaussiangrasper_tpu.models.efd import init_mlp
from gaussiangrasper_tpu.ops.rasterize import RasterizeConfig as JRC
from gaussiangrasper_tpu.parallel import make_mesh as j_make_mesh
from gaussiangrasper_tpu.parallel import make_sharded_train_step as j_make_step
from gaussiangrasper_tpu.parallel import shard_train_state as j_shard
from gaussiangrasper_tpu.parallel.tile_shard import composite_tile_sharded as j_composite
from gaussiangrasper_tpu.parallel.tile_shard import derive_gather_budget as j_budget
from tests import test_torch_ranks as torch_ranks
from tests.test_torch_core import close, make_scene, project_both
from tests.test_torch_train import close_scaled, opt_numpy

WORLD_TIMEOUT_S = 240
RASTER = dict(tile_size=16, max_gaussians_per_tile=256)
W, H = 96, 80  # 6 x 5 tiles: ceil(5 / d) * d > 5 at d = 2 and 4, so bands have padding rows


# --- the mesh and the gather budget ---------------------------------------------


def test_mesh_shapes():
    """tests/test_parallel.py::test_mesh_shapes's cases on 8 devices."""
    for dp, gauss in ((2, None), (None, 8), (None, None)):
        want = j_make_mesh(dp=dp, gauss=gauss).shape
        assert dict(zip(("dp", "gauss"), tmesh.mesh_shape(dp, gauss, 8))) == dict(want)
    for fn in (lambda: j_make_mesh(dp=3), lambda: tmesh.mesh_shape(3, None, 8)):
        with pytest.raises(ValueError):
            fn()


@pytest.mark.parametrize("case", ["balanced", "dead", "full", "prefix", "mostly_dead"])
def test_derive_gather_budget_matches_jax(case):
    cap, d = {"full": (1024, 8)}.get(case, (8192, 8))
    alive = {"balanced": np.arange(cap) % 8 < 1, "dead": np.zeros(cap, bool),
             "full": np.ones(cap, bool), "prefix": np.arange(cap) < 1000,
             "mostly_dead": np.arange(cap) % 10 == 0}[case]
    want = j_budget(jnp.asarray(alive), d)
    assert tts.derive_gather_budget(alive, d) == tts.derive_gather_budget(torch.as_tensor(alive), d) \
        == want
    assert want == {"balanced": 256, "dead": 128, "full": 128, "prefix": 1024,
                    "mostly_dead": 128}[case]


# --- the tile-sharded compositor ---------------------------------------------------


@pytest.fixture(scope="module")
def scene():
    """600 Gaussians at 96x80, C 5, projected by both packages; the port's
    unsharded composite and its gradients of `torch_ranks.composite_loss`."""
    s = make_scene(9, 600, width=W, height=H, n_channels=5)
    jp, tp = project_both(s)
    rng = np.random.default_rng(1)
    arrays = {"xys": tp.xys, "conics": tp.conics, "cov2d": tp.cov2d, "depths": tp.depths,
              "radii": tp.radii}
    arrays = {k: v.numpy() for k, v in arrays.items()}
    arrays.update(opacities=s["opacities"], colors=s["colors"], width=W, height=H,
                  background=np.linspace(0, 1, 5, dtype=np.float32),
                  target=rng.random((H, W, 5), np.float32))
    image, alpha, grads = unsharded(arrays, lambda p, c, o, bg: t_rasterize_projected(
        p, c, o, bg, W, H, TRC(**RASTER)))
    return dict(arrays=arrays, jproj=jp, image=image, alpha=alpha, grads=grads)


def leaves_of(arrays):
    from gaussiangrasper_torch.ops.projection import ProjectedGaussians

    t = {k: torch.as_tensor(arrays[k]) for k in ("xys", "conics", "cov2d", "depths", "radii",
                                                  "opacities", "colors")}
    leaves = [t[k].clone().requires_grad_(True) for k in ("xys", "conics", "opacities", "colors")]
    proj = ProjectedGaussians(xys=leaves[0], depths=t["depths"], conics=leaves[1],
                              radii=t["radii"], cov2d=t["cov2d"])
    return proj, leaves


def unsharded(arrays, composite):
    proj, leaves = leaves_of(arrays)
    out = composite(proj, leaves[3], leaves[2], torch.as_tensor(arrays["background"]))
    loss = torch_ranks.composite_loss(out["image"], out["alpha"], torch.as_tensor(arrays["target"]))
    return out["image"].detach(), out["alpha"].detach(), torch.autograd.grad(loss, leaves)


def jax_composite(scene, d, **kw):
    """The JAX composite_tile_sharded on a gauss-d mesh, jitted (eager
    shard_map takes ~20 s here, jitted 2-3 s)."""
    a = scene["arrays"]
    mesh = j_make_mesh(dp=1, gauss=d, devices=jax.devices()[:d])
    fn = jax.jit(lambda p, c, o, bg: j_composite(p, c, o, bg, W, H, JRC(**RASTER), mesh=mesh,
                                                 **kw))
    return fn(scene["jproj"], jnp.asarray(a["colors"]), jnp.asarray(a["opacities"]),
              jnp.asarray(a["background"]))


def check_against_unsharded(scene, image, alpha, grads, msg):
    np.testing.assert_array_equal(image.numpy(), scene["image"].numpy(), err_msg=msg)
    np.testing.assert_array_equal(alpha.numpy(), scene["alpha"].numpy(), err_msg=msg)
    for name, got, want in zip(("xys", "conics", "opacities", "colors"), grads, scene["grads"]):
        close_scaled(got, want.numpy(), 1e-5, msg=f"{msg} {name}")


@pytest.mark.parametrize("d", [2, 4])
@pytest.mark.parametrize("bin_mode", ["merge", "replicated"])
def test_split_matches_unsharded(scene, d, bin_mode):
    """The in-process D-way split: both halves for every shard and band."""
    image, alpha, grads = unsharded(scene["arrays"], lambda p, c, o, bg: tts.composite_tile_split(
        p, c, o, bg, W, H, TRC(**RASTER), d=d, bin_mode=bin_mode))
    check_against_unsharded(scene, image, alpha, grads, f"d {d} {bin_mode}")


def test_split_reports_every_drop(scene):
    """An undersized band budget reports merge_overflow alone; an
    undersized gather budget reports gather_overflow; the JAX package
    reports the same counts."""
    a = scene["arrays"]
    proj, leaves = leaves_of(a)
    bg = torch.as_tensor(a["background"])
    for kw, key in (({"band_pair_budget": 32}, "merge_overflow"),
                    ({"gather_budget": 100}, "gather_overflow")):
        out = tts.composite_tile_split(proj, leaves[3], leaves[2], bg, W, H, TRC(**RASTER), d=2,
                                       **kw)
        bins = out["bins"]._asdict()
        assert bins[key] > 0, key
        assert all(int(v) == 0 for k, v in bins.items() if k in (
            "overflow", "dropped_tiles", "gather_overflow", "merge_overflow") and k != key), bins
        assert not torch.equal(out["image"], scene["image"])
        want = jax_composite(scene, 2, **kw)
        assert int(want["bins"]._asdict()[key]) == int(bins[key])
        close(out["image"], want["image"], atol=2e-5, rtol=1e-4, msg=key)


def test_split_with_one_band_and_the_tile_cap(scene):
    """d = 1 is the unsharded path; with the per-Gaussian tile cap biting,
    dropped_tiles counts as the unsharded binning does."""
    image, alpha, grads = unsharded(scene["arrays"], lambda p, c, o, bg: tts.composite_tile_split(
        p, c, o, bg, W, H, TRC(**RASTER), d=1))
    check_against_unsharded(scene, image, alpha, grads, "d 1")
    proj, leaves = leaves_of(scene["arrays"])
    cfg = TRC(**RASTER, max_tiles_per_gaussian=2)
    bg = torch.as_tensor(scene["arrays"]["background"])
    want = t_rasterize_projected(proj, leaves[3], leaves[2], bg, W, H, cfg)
    got = tts.composite_tile_split(proj, leaves[3], leaves[2], bg, W, H, cfg, d=2)
    assert int(got["bins"].dropped_tiles) == int(want["bins"].dropped_tiles) > 0
    assert torch.equal(got["image"], want["image"])


@pytest.fixture(scope="module")
def states():
    """tests/test_parallel.py's tiny JAX state (64 alive of 128), two
    batches and the train_state_from_numpy payload of the state."""
    key = jax.random.PRNGKey(0)
    field, alive, cam = JE.tiny_setup(key, n=64, cap=128)
    jstate = j_init(jax.random.PRNGKey(1), field, alive, init_mlp(key, JE.F, 512, (32,)))
    rng = np.random.default_rng(5)
    batches = [jax.tree.map(np.asarray, JE.tiny_batch(rng)) for _ in range(2)]
    payload = dict(field_arrays={k: np.array(getattr(jstate.field, k)) for k in FIELD_KEYS},
                   alive=np.array(jstate.alive), fea_up_arrays=jax.tree.map(np.array, jstate.fea_up),
                   opt_arrays=opt_numpy(jstate),
                   stats_arrays={k: np.array(v) for k, v in jstate.stats._asdict().items()},
                   step=int(jstate.step))
    return dict(jstate=jstate, jcam=cam, batches=batches, payload=payload)


STEP_CASES = {"dp2": (2, 1, False), "gauss2_tile": (1, 2, True), "gauss2_full": (1, 2, False),
              "dp2_gauss2_tile": (2, 2, True)}


def step_case(states, dp, tile_shard):
    return dict(state=states["payload"], tile_shard=tile_shard,
                model=dict(feature_dim=JE.F, warmup_length=0),
                raster=dict(tile_size=8, max_gaussians_per_tile=128, tile_chunk=4),
                intrinsics=(30.0, 30.0, JE.W / 2, JE.H / 2), c2w=np.eye(4, dtype=np.float32)[:3],
                size=(JE.W, JE.H),
                batches={k: np.stack([b[k] for b in states["batches"][:dp]])
                         for k in states["batches"][0]})


@pytest.fixture(scope="module")
def gloo(scene, states, tmp_path_factory):
    """The port's gloo worlds: 2 ranks (the compositor at gauss 2, the steps
    at (2, 1), (1, 2) tile-sharded and full-capacity), then 4 ranks (the
    compositor at gauss 4, the step at (2, 2))."""
    from concurrent.futures import ThreadPoolExecutor

    out = tmp_path_factory.mktemp("gloo")

    def run(size):
        jobs = [("composite", 1, size, (scene["arrays"], RASTER, f"composite{size}"))]
        for tag, (dp, gauss, tile) in STEP_CASES.items():
            if dp * gauss == size:
                jobs.append(("step", dp, gauss, (step_case(states, dp, tile), tag)))
        comm.run_world(size, torch_ranks.world, (size, jobs, str(out)), timeout_s=WORLD_TIMEOUT_S)

    with ThreadPoolExecutor(2) as pool:  # the two worlds start side by side
        for f in [pool.submit(run, size) for size in (2, 4)]:
            f.result()
    return out


@pytest.mark.parametrize("d", [2, 4])
def test_sharded_compositor_matches_unsharded_and_jax(scene, gloo, d):
    parts = [torch.load(gloo / f"composite{d}_rank{r}.pt") for r in range(d)]
    for p in parts[1:]:  # every rank holds the whole image
        assert torch.equal(p["image"], parts[0]["image"])
    grads = [torch.cat([p["grads"][i] for p in parts]) for i in range(4)]
    check_against_unsharded(scene, parts[0]["image"], parts[0]["alpha"], grads, f"gauss {d}")

    a = scene["arrays"]
    want = jax_composite(scene, d)
    close(parts[0]["image"], want["image"], atol=2e-5, rtol=1e-4)
    close(parts[0]["alpha"], want["alpha"], atol=2e-5, rtol=1e-4)
    jbins = {k: int(v) for k, v in want["bins"]._asdict().items()}
    got = parts[0]["bins"]
    assert got["gathered_rows"] == jbins["gathered_rows"] == int((a["radii"] > 0).sum())
    for k in ("dropped_tiles", "gather_overflow", "gathered_bytes", "merge_overflow"):
        assert got[k] == jbins[k], k
    # F8: the JAX band stream leaves its sentinels at T - lo, a padding tile
    # row of the last band here, and counts them past K; the port's merged
    # stream holds no sentinel and reports no overflow
    assert got["overflow"] == 0 < jbins["overflow"]


def check_step(got_dir, got_metrics, jstate, jm, updates):
    ts = tckpt.load_checkpoint(tckpt.latest_checkpoint(got_dir))
    assert ts.step == int(jstate.step) == 1
    assert set(got_metrics) == set(jm), (set(got_metrics), set(jm))
    for k, v in jm.items():
        if k == "overflow" and "gathered_rows" in jm:
            # F8: the JAX band stream counts its sentinels past K (see
            # test_sharded_compositor_matches_unsharded_and_jax)
            assert int(got_metrics[k]) == 0 < int(v)
        else:
            close(got_metrics[k], v, atol=1e-6, rtol=1e-4, msg=k)
    np.testing.assert_array_equal(ts.alive.numpy(), np.asarray(jstate.alive))
    for leaf, name in topt.FIELD_GROUP_OF.items():
        n = updates[name]
        assert int(ts.opt[name].count) == int(jstate.opt[name].adam.count) == n, name
        close(getattr(ts.field, leaf), getattr(jstate.field, leaf),
              atol=2.0 * topt.DEFAULT_GROUPS[name].lr_init * n, rtol=0, msg=leaf)
        part = "accum" if n == 0 else "mu"
        want = getattr(jstate.opt[name], part) if n == 0 else jstate.opt[name].adam.mu
        close_scaled(getattr(ts.opt[name], part), np.asarray(want), 1e-4, msg=f"{name} {part}")
    for i in range(2):
        close(ts.fea_up[f"layers.{i}.weight"], np.asarray(jstate.fea_up[f"w{i}"]).T,
              atol=2.0 * 1e-3, rtol=0, msg=f"w{i}")
    for name, a, b in zip(jstate.stats._fields, jstate.stats, ts.stats):
        close(b, np.asarray(a), atol=1e-6, rtol=1e-3, msg=name)
    return ts


UPDATES_AT_STEP_0 = {"xyz": 0, "color": 0, "feature": 0, "opacity": 1, "scaling": 1,
                     "rotation": 1}


@pytest.mark.parametrize("tag", ["dp2", "gauss2_tile", "dp2_gauss2_tile"])
def test_sharded_step_matches_jax(states, gloo, tag):
    dp, gauss, tile = STEP_CASES[tag]
    mesh = j_make_mesh(dp=dp, gauss=gauss, devices=jax.devices()[:dp * gauss])
    jstate = j_shard(jax.tree.map(jnp.copy, states["jstate"]), mesh)
    cams = jax.tree.map(lambda l: jnp.broadcast_to(l, (dp,) + l.shape) if hasattr(l, "shape")
                        else l, states["jcam"])
    batches = jax.tree.map(lambda *ls: jnp.stack([jnp.asarray(x) for x in ls]),
                           *states["batches"][:dp])
    jstate, jm = j_make_step(mesh, JE.small_cfg(), 128, tile_shard=tile)(jstate, cams, batches)
    jstate, jm = jax.tree.map(np.asarray, jstate), jax.tree.map(np.asarray, jm)
    got = torch.load(gloo / f"{tag}_metrics.pt")
    check_step(gloo / tag, got, jstate, jm, UPDATES_AT_STEP_0)


def test_full_capacity_step_matches_one_device(states, gloo):
    """(1, 2) without the tile shard: every gauss rank renders the whole
    image from the gathered field. Its update equals the single-device
    train_step's on the same state and batch (no factor of gauss in the
    gradients)."""
    b = {k: torch.tensor(v) for k, v in states["batches"][0].items()}
    from gaussiangrasper_torch.core.cameras import Camera

    cam = Camera.create(30.0, 30.0, JE.W / 2, JE.H / 2, np.eye(4, dtype=np.float32)[:3], JE.W,
                        JE.H)
    cfg = TConfig(feature_dim=JE.F, warmup_length=0,
                  raster=TRC(tile_size=8, max_gaussians_per_tile=128))
    want, wm = t_step(train_state_from_numpy(**states["payload"]), cam, b, cfg)
    got = tckpt.load_checkpoint(tckpt.latest_checkpoint(gloo / "gauss2_full"))
    gm = torch.load(gloo / "gauss2_full_metrics.pt")
    for k, v in gm.items():
        close(v, wm[k], atol=1e-6, rtol=1e-5, msg=k)
    for name, st in want.opt.items():
        for part in ("mu", "nu", "accum"):
            for a, c in zip(topt.leaves(getattr(got.opt[name], part)), topt.leaves(getattr(st, part))):
                close_scaled(a, c.numpy(), 1e-5, msg=f"{name} {part}")
    for a, c in zip(got.field, want.field):
        close(a, c, atol=1e-6, rtol=0)
    for a, c in zip(got.stats, want.stats):
        close(a, c, atol=1e-7, rtol=1e-5)


# --- the host loop through the train CLI --------------------------------------------


@pytest.fixture(scope="module")
def tabletop(tmp_path_factory):
    return generate_tabletop(tmp_path_factory.mktemp("tabletop") / "scene", width=64, height=48,
                             n_views=4, feature_downscale=2, seed_points=300)


CLI = ["--capacity", "1024", "--feature-dim", "8", "--sh-degree", "1", "--warmup-length", "0",
       "--refine-every", "2", "--device", "cpu"]


def test_train_cli_mesh_refines_saves_and_renders(tabletop, tmp_path, capsys):
    """`--mesh 1,2`: two spawned gloo ranks train 3 steps (a refine after
    step 1, the tile shard on by default), rank 0 saves the whole state,
    and the render CLI reads the run."""
    out = tmp_path / "out"
    t_train_cli.main(["--data", str(tabletop), "--output-dir", str(out), "--experiment-name",
                      "mesh", "--max-iterations", "3", "--steps-per-save", "3", "--mesh", "1,2",
                      *CLI])
    run = out / "mesh"
    state = tckpt.load_checkpoint(run / "checkpoints" / "step_000000003.pt")
    assert state.step == 3 and state.field.capacity == 1024 and int(state.alive.sum()) > 0
    # the refine after step 1 reset the stats: one step has counted since
    assert float(state.stats.vis_counts.max()) == 1.0
    t_render_cli.main(["--run-dir", str(run), "--num-views", "1", "--device", "cpu"])
    metrics = json.loads((run / "renders" / "metrics.json").read_text())
    assert np.isfinite(metrics["results"]["psnr"])
    with pytest.raises(ValueError, match="not divisible by gauss=3"):
        t_train_cli.main(["--data", str(tabletop), "--output-dir", str(out), "--mesh", "1,3",
                          "--max-iterations", "1", *CLI])
