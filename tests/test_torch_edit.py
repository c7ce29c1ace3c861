"""PyTorch port vs the JAX package: the scene-update and grasp tools.

The same seeded numpy inputs go into the JAX function and the port's:
- `rotmat_to_quat` within 1e-6, on random rotations and 180-degree turns;
- `hull_mask` bit-equal to the JAX tool's OpenCV drawing at dilate 0, 7
  and 14, with points off the image and fewer than three points (the
  port imports no cv2);
- `points_inside_convex_hull` equal, `rigid_transform_gaussians` within
  1e-6;
- `gaussian_relevancy` within 1e-5 (float32 products in another order),
  `largest_cluster` equal (a tie included), `propose_grasp` within 1e-5;
- the update CLI on a 32x24 tabletop: one state (with nonzero Adam moments
  and densify stats) saved by each package, 3 fine-tune iterations in each,
  the step-0 checkpoints equal (the moved means / quats within 1e-6), the
  final states within the five-trainer-step tolerances of
  tests/test_torch_trainer.py, the same edit/checkpoints listing.
"""

import json
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussiangrasper_torch.core import transforms as tt
from gaussiangrasper_torch.engine import checkpoint as tckpt
from gaussiangrasper_torch.engine import optimizers as topt
from gaussiangrasper_torch.engine.weights import state_from_numpy
from gaussiangrasper_torch.models.gaussian_field import FIELD_KEYS, field_from_numpy
from gaussiangrasper_torch.scripts import grasp as tgrasp
from gaussiangrasper_torch.scripts import project_hull as thull
from gaussiangrasper_torch.scripts import query as tquery
from gaussiangrasper_torch.scripts import update as tupdate
from gaussiangrasper_tpu.core import transforms as jt
from gaussiangrasper_tpu.data.synthetic import SPHERES, generate_tabletop, move_object
from gaussiangrasper_tpu.engine import checkpoint as jckpt
from gaussiangrasper_tpu.engine import trainer as jtrainer
from gaussiangrasper_tpu.models.gaussian_field import GaussianParams as JParams
from gaussiangrasper_tpu.models.model import GaussianSplatConfig as JConfig
from gaussiangrasper_tpu.ops.rasterize import RasterizeConfig as JRC
from gaussiangrasper_tpu.scripts import grasp as jgrasp
from gaussiangrasper_tpu.scripts import project_hull as jhull
from gaussiangrasper_tpu.scripts import query as jquery
from gaussiangrasper_tpu.scripts import update as jupdate
from tests.test_torch_core import close
from tests.test_torch_train import convert

FT_STEPS = 3  # below warmup_length 300: no refine, no random draw


def random_rotations(rng, n):
    q = rng.standard_normal((n, 4))
    return np.array(jt.quat_to_rotmat(jnp.asarray(q / np.linalg.norm(q, axis=1, keepdims=True),
                                                    jnp.float32)))


@pytest.mark.parametrize("kind", ["random", "half_turns"])
def test_rotmat_to_quat_matches_jax(kind):
    if kind == "random":
        rots = random_rotations(np.random.default_rng(0), 500)
    else:  # 180 degrees about x, y, z and two diagonals: zero w, tied pivots
        rots = np.stack([np.diag([1.0, -1.0, -1.0]), np.diag([-1.0, 1.0, -1.0]),
                         np.diag([-1.0, -1.0, 1.0]), np.eye(3),
                         np.array([[0.0, 1, 0], [1, 0, 0], [0, 0, -1]]),
                         np.array([[-1.0, 0, 0], [0, 0, 1], [0, 1, 0]]),
                         # about (1, -1, 0): the x and y pivots tie and their
                         # candidates differ in sign, so the tie order shows
                         np.array([[0.0, -1, 0], [-1, 0, 0], [0, 0, -1]])]).astype(np.float32)
    want = np.asarray(jt.rotmat_to_quat(jnp.asarray(rots)))
    got = tt.rotmat_to_quat(torch.as_tensor(rots))
    close(got, want, atol=1e-6, rtol=0)
    assert (got[:, 0] >= 0).all()


def hull_cases():
    rng = np.random.default_rng(1)
    w, h = 64, 48
    yield "inside", rng.uniform([2, 2], [w - 2, h - 2], (12, 2)), w, h
    yield "off_image", rng.uniform([-40, -30], [w + 40, h + 30], (9, 2)), w, h
    yield "far_off", np.concatenate([rng.uniform(0, 40, (6, 2)),
                                     [[5e4, 3e4], [-2e5, 40.0], [30.0, -7e4]]]), w, h
    yield "two_points", np.array([[3.2, 4.7], [50.1, 30.4]]), w, h
    yield "collinear", np.array([[1.0, 1.0], [10.0, 10.0], [20.2, 19.8], [5.0, 5.0]]), w, h
    yield "odd_size", rng.normal([17, 11], [9, 7], (40, 2)), 37, 23
    yield "many", rng.normal([32, 24], [20, 15], (500, 2)), w, h


@pytest.mark.parametrize("dilate", [0, 7, 14])
@pytest.mark.parametrize("case", [c[0] for c in hull_cases()])
def test_hull_mask_bit_equal_to_opencv(case, dilate):
    _, uv, w, h = next(c for c in hull_cases() if c[0] == case)
    want = jhull.hull_mask(uv, w, h, dilate=dilate)
    got = thull.hull_mask(uv, w, h, dilate=dilate)
    assert got.shape == want.shape == (h, w) and got.dtype == bool
    np.testing.assert_array_equal(got, want)
    if case != "two_points":
        assert want.any()


def test_hull_module_imports_no_cv2():
    code = ("import sys; import gaussiangrasper_torch.scripts.project_hull as m, numpy as np; "
            "m.hull_mask(np.array([[1.0, 1], [9, 2], [4, 8]]), 12, 10, 3); "
            "print('cv2' in sys.modules)")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "False"


def test_project_points_matches_jax():
    rng = np.random.default_rng(2)
    pts = rng.normal(0, 2, (200, 3))
    w2c = np.eye(4)
    w2c[:3, :3] = random_rotations(rng, 1)[0]
    w2c[:3, 3] = [0.1, -0.2, 3.0]
    args = (w2c, 60.0, 55.0, 32.0, 24.0)
    np.testing.assert_array_equal(thull.project_points(pts, *args),
                                  jhull.project_points(pts, *args))


def random_field(rng, n, sh_k=4, feature_dim=16):
    f32 = np.float32
    q = rng.standard_normal((n, 4)).astype(f32)
    return {"means": rng.normal(0, 0.5, (n, 3)).astype(f32),
            "log_scales": rng.normal(-3, 0.5, (n, 3)).astype(f32),
            "quats": q / np.linalg.norm(q, axis=1, keepdims=True),
            "opacity_logits": rng.normal(0, 1, n).astype(f32),
            "sh_coeffs": rng.normal(0, 0.3, (n, sh_k, 3)).astype(f32),
            "features": rng.normal(0, 1, (n, feature_dim)).astype(f32)}


def test_hull_select_and_rigid_transform_match_jax():
    rng = np.random.default_rng(3)
    arrays = random_field(rng, 400)
    hull = rng.normal([0.2, 0.0, -0.1], 0.3, (300, 3))
    hull[:5] *= 8.0  # outliers the filter drops
    want_mask = jupdate.points_inside_convex_hull(arrays["means"], hull)
    got_mask = tupdate.points_inside_convex_hull(arrays["means"], hull)
    np.testing.assert_array_equal(got_mask, want_mask)
    assert 0 < want_mask.sum() < len(want_mask)

    move = np.eye(4)
    move[:3, :3] = random_rotations(rng, 1)[0]
    move[:3, 3] = [0.3, -0.5, 0.2]
    jf = jupdate.rigid_transform_gaussians(JParams(**{k: jnp.asarray(v) for k, v in arrays.items()}),
                                           want_mask, move)
    tf = tupdate.rigid_transform_gaussians(field_from_numpy(arrays), torch.as_tensor(got_mask),
                                           move)
    for k in FIELD_KEYS:
        close(getattr(tf, k), getattr(jf, k), atol=1e-6, rtol=0, msg=k)
    unmoved = ~want_mask
    np.testing.assert_array_equal(tf.means.numpy()[unmoved], arrays["means"][unmoved])


def test_gaussian_relevancy_matches_jax():
    rng = np.random.default_rng(4)
    arrays = random_field(rng, 300)
    fea_up = {"w0": rng.normal(0, 0.25, (16, 128)).astype(np.float32),
              "b0": rng.normal(0, 0.1, 128).astype(np.float32),
              "w1": rng.normal(0, 0.1, (128, 512)).astype(np.float32),
              "b1": rng.normal(0, 0.1, 512).astype(np.float32)}
    query = rng.standard_normal(512).astype(np.float32)
    canon = rng.standard_normal((3, 512)).astype(np.float32)
    want = jgrasp.gaussian_relevancy({k: jnp.asarray(v) for k, v in fea_up.items()},
                                     jnp.asarray(arrays["features"]), jnp.asarray(query),
                                     jnp.asarray(canon))
    state = state_from_numpy(arrays, np.ones(300, bool), fea_up, step=0)
    got = tgrasp.gaussian_relevancy(state.fea_up.state_dict(), state.field.features,
                                    torch.as_tensor(query), torch.as_tensor(canon))
    close(got, want, atol=1e-5, rtol=0)
    assert float(np.ptp(np.asarray(want))) > 0.05


@pytest.mark.parametrize("layout", ["blobs", "tie"])
def test_largest_cluster_matches_jax(layout):
    rng = np.random.default_rng(5)
    if layout == "blobs":
        pts = np.concatenate([rng.normal(0, 0.02, (200, 3)), rng.normal(1, 0.02, (50, 3)),
                              rng.uniform(-2, 2, (30, 3))])
    else:  # two separated clusters of one voxel each and the same count
        pts = np.concatenate([np.full((7, 3), 0.005), np.full((7, 3), 0.505)])
        pts[:, 0] += rng.uniform(0, 0.01, 14)
    want = jgrasp.largest_cluster(pts, 0.05)
    got = tgrasp.largest_cluster(pts, 0.05)
    np.testing.assert_array_equal(got, want)
    if layout == "tie":
        assert want.sum() == 7


def test_propose_grasp_matches_jax():
    rng = np.random.default_rng(6)
    pts = rng.normal([0.1, 0.2, 0.3], [0.05, 0.02, 0.01], (150, 3))
    normals = rng.normal([0, 0, 1], 0.2, (150, 3))
    normals /= np.linalg.norm(normals, axis=1, keepdims=True)
    opac = rng.uniform(0.1, 1.0, 150)
    want = jgrasp.propose_grasp(pts, normals, opac)
    got = tgrasp.propose_grasp(pts, normals, opac)
    assert set(got) == set(want)
    for k in want:
        close(np.asarray(got[k]), np.asarray(want[k]), atol=1e-5, rtol=0, msg=k)


# --- the update CLI ----------------------------------------------------------


SMALL_MODEL = dict(feature_dim=16, sh_degree=1, num_downscales=0, warmup_length=30,
                   refine_every=50, stop_split_at=300)
SMALL_RASTER = dict(tile_size=16, max_gaussians_per_tile=1024, tile_chunk=4,
                    max_tiles_per_gaussian=16)
WH = (32, 24)


def perturbed(jstate, rng):
    """jstate with step 7 and seeded nonzero Adam moments, accumulators and
    densify stats (all non-negative), so the test sees them carried."""
    def fill(x):
        x = np.asarray(x)
        if np.issubdtype(x.dtype, np.floating):
            return jnp.asarray(rng.uniform(0.0, 1e-3, x.shape).astype(x.dtype))
        return jnp.asarray(x)

    return jstate._replace(step=jnp.asarray(7, jnp.int32), opt=jax.tree.map(fill, jstate.opt),
                           stats=jax.tree.map(fill, jstate.stats))


@pytest.fixture(scope="module")
def updated(tmp_path_factory):
    """One state saved as a JAX run and as a port run; the update CLI of
    each package on it, FT_STEPS fine-tune iterations."""
    root = tmp_path_factory.mktemp("update")
    kw = dict(width=WH[0], height=WH[1], n_views=4, feature_downscale=2)
    scene = generate_tabletop(root / "data" / "scene", **kw)
    after, obj = move_object(root / "data" / "after", **kw)
    # the seeds lie on the sphere, outside the polytope its surface samples
    # span: a slightly larger sample takes them in
    centre = SPHERES[1][0]
    np.save(root / "obj.npy", centre + 1.2 * (obj - centre))
    move = np.eye(4)
    move[:3, 3] = (-0.55, 0.45, 0.0)
    np.save(root / "move.npy", move)

    jcfg = jtrainer.TrainerConfig(data=scene, output_dir=root / "jax", experiment_name="run",
                                  max_iterations=FT_STEPS, steps_per_save=FT_STEPS,
                                  capacity=4096, prefetch=False,
                                  model=JConfig(raster=JRC(**SMALL_RASTER), **SMALL_MODEL))
    jstate = perturbed(jtrainer.make_trainer(jcfg).setup(), np.random.default_rng(8))
    jckpt.save_checkpoint(jcfg.ckpt_dir, jstate)
    trun = root / "torch" / "run"
    (trun / "checkpoints").mkdir(parents=True)
    (trun / "config.json").write_text((jcfg.run_dir / "config.json").read_text())
    tckpt.save_checkpoint(trun / "checkpoints", convert(jstate))

    common = ["--edit-object", str(root / "obj.npy"), "--transform-npy", str(root / "move.npy"),
              "--after-data", str(after), "--max-iterations", str(FT_STEPS)]
    jupdate.main(["--run-dir", str(jcfg.run_dir), *common])
    tupdate.main(["--run-dir", str(trun), *common, "--device", "cpu"])
    return dict(jrun=jcfg.run_dir, trun=trun, jstate=jstate)


def jax_leaves(path, template):
    return jax.tree.map(np.array, jckpt.load_checkpoint(path, template))


def test_update_step0_checkpoint_matches_jax(updated):
    jrun, trun = updated["jrun"], updated["trun"]
    j0 = jax_leaves(jrun / "edit" / "checkpoints" / "step_000000000", updated["jstate"])
    t0 = tckpt.load_checkpoint(trun / "edit" / "checkpoints" / "step_000000000.pt")
    assert t0.step == int(j0.step) == 0
    np.testing.assert_array_equal(t0.alive.numpy(), j0.alive)
    moved = ~np.isclose(j0.field.means, np.asarray(updated["jstate"].field.means)).all(1)
    assert moved.sum() > 0
    for k in FIELD_KEYS:
        atol = 1e-6 if k in ("means", "quats") else 0.0
        close(getattr(t0.field, k), getattr(j0.field, k), atol=atol, rtol=0, msg=k)
    want = convert(j0)  # the moments, accumulators and stats: carried exactly
    for name, g in want.opt.items():
        for part in ("mu", "nu", "accum"):
            for a, b in zip(topt.leaves(getattr(t0.opt[name], part)),
                            topt.leaves(getattr(g, part))):
                np.testing.assert_array_equal(a.numpy(), b.numpy(), err_msg=f"{name} {part}")
        assert int(t0.opt[name].count) == int(g.count)
    for a, b in zip(t0.stats, want.stats):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_update_finetune_matches_jax(updated):
    jrun, trun = updated["jrun"], updated["trun"]
    js = jax_leaves(jrun / "edit" / "checkpoints" / "step_009999999", updated["jstate"])
    ts = tckpt.load_checkpoint(trun / "edit" / "checkpoints" / "step_009999999.pt")
    assert ts.step == int(js.step) == FT_STEPS
    np.testing.assert_array_equal(ts.alive.numpy(), js.alive)
    for leaf, name in topt.FIELD_GROUP_OF.items():
        n = int(ts.opt[name].count) - int(updated["jstate"].opt[name].adam.count)
        assert int(ts.opt[name].count) == int(js.opt[name].adam.count), name
        atol = 2.0 * topt.DEFAULT_GROUPS[name].lr_init * n
        close(getattr(ts.field, leaf), getattr(js.field, leaf), atol=atol, rtol=0, msg=leaf)
    for name, a, b in zip(js.stats._fields, js.stats, ts.stats):
        close(b, a, atol=1e-6, rtol=1e-3, msg=name)
    # the edit's checkpoints, and the fine-tune's run, as the JAX flow leaves them
    listing = {p.name.removesuffix(".pt") for p in (trun / "edit" / "checkpoints").iterdir()}
    assert listing == {p.name for p in (jrun / "edit" / "checkpoints").iterdir()} == {
        "step_000000000", "step_009999999"}
    ft = {p.name.removesuffix(".pt") for p in (trun / "edit" / "finetune" / "checkpoints").iterdir()}
    assert ft == {p.name for p in (jrun / "edit" / "finetune" / "checkpoints").iterdir()}
    jft = json.loads((jrun / "edit" / "finetune" / "config.json").read_text())
    tft = json.loads((trun / "edit" / "finetune" / "config.json").read_text())
    assert tft["model"] == jft["model"] and tft["max_iterations"] == jft["max_iterations"]


def test_update_mesh_raises(updated, tmp_path):
    """A mesh whose gauss axis does not divide the capacity raises before
    any rank starts, as the JAX package's tile_shard.py:150-151 does
    (tests/test_torch_multi_scene.py runs --mesh 1,2)."""
    import shutil

    run = tmp_path / "run"
    shutil.copytree(updated["trun"], run, ignore=shutil.ignore_patterns("edit"))
    root = updated["trun"].parent.parent
    with pytest.raises(ValueError, match="capacity 4096 not divisible by gauss=3"):
        tupdate.main(["--run-dir", str(run), "--edit-object", str(root / "obj.npy"),
                      "--transform-npy", str(root / "move.npy"), "--after-data",
                      str(root / "data" / "after"), "--mesh", "1,3", "--device", "cpu"])


def test_checkpoint_saved_on_the_card_loads_on_the_cpu(updated, tmp_path):
    """A checkpoint written on the card holds the CUDA generator's 16-byte
    state (seed, offset); loaded on the CPU it reseeds from that seed."""
    src = updated["trun"] / "edit" / "checkpoints" / "step_000000000.pt"
    payload = torch.load(src, weights_only=True)
    seed, offset = 987654321, 4
    payload["generator"] = torch.tensor(list(seed.to_bytes(8, "little") + offset.to_bytes(8, "little")),
                                        dtype=torch.uint8)
    torch.save(payload, tmp_path / "step_000000000.pt")
    got = tckpt.load_checkpoint(tmp_path / "step_000000000.pt")
    assert got.generator.initial_seed() == seed
    want = tckpt.load_checkpoint(src)
    for k in FIELD_KEYS:
        assert torch.equal(getattr(got.field, k), getattr(want.field, k)), k


def test_query_cli_on_a_trainer_run_matches_jax(updated, tmp_path):
    """The query CLI reads a trainer run (its latest checkpoint, its
    capture's cameras) as the JAX CLI does, the first step of the e2e flow
    after training."""
    rng = np.random.default_rng(11)
    np.save(tmp_path / "q.npy", rng.normal(size=(2, 512)).astype(np.float32))
    np.save(tmp_path / "c.npy", rng.normal(size=(3, 512)).astype(np.float32))
    common = ["--text-embedding", str(tmp_path / "q.npy"), "--canonical-embedding",
              str(tmp_path / "c.npy"), "--views", "0", "2"]
    jquery.main(["--run-dir", str(updated["jrun"]), *common, "--output", str(tmp_path / "jax")])
    tquery.main(["--run-dir", str(updated["trun"]), *common, "--output", str(tmp_path / "torch"),
                 "--device", "cpu"])
    for v in (0, 2):
        for qi in range(2):
            name = f"view{v:04d}_q{qi}.npy"
            want = np.load(tmp_path / "jax" / name)
            assert want.shape == (WH[1], WH[0])
            close(np.load(tmp_path / "torch" / name), want, atol=1e-5, rtol=1e-4, msg=name)


def test_grasp_main_writes_grasp_request_dict(updated, tmp_path):
    """`main` on a trainer run writes `grasp_request`'s dict (its index
    arrays left out) and the cluster's points, for a threshold that keeps
    half the alive Gaussians."""
    from gaussiangrasper_torch.scripts.common import load_run

    rng = np.random.default_rng(12)
    q, c = rng.normal(size=512).astype(np.float32), rng.normal(size=(3, 512)).astype(np.float32)
    np.save(tmp_path / "q.npy", q)
    np.save(tmp_path / "c.npy", c)
    _, _, state = load_run(updated["trun"], device="cpu")
    rel = tgrasp.gaussian_relevancy(state.fea_up, state.field.features, torch.as_tensor(q),
                                    torch.as_tensor(c)).numpy()
    thr = float(np.median(rel[state.alive.numpy()]))
    want = tgrasp.grasp_request(state, torch.as_tensor(q), torch.as_tensor(c), thr, 0.02)
    idx, sel = want.pop("cluster"), want.pop("selected")
    assert 0 < len(idx) <= len(sel) < int(state.alive.sum())
    got = tgrasp.main(["--run-dir", str(updated["trun"]), "--text-embedding", str(tmp_path / "q.npy"),
                       "--canonical-embedding", str(tmp_path / "c.npy"), "--threshold", repr(thr),
                       "--output", str(tmp_path / "out"), "--device", "cpu"])
    assert got == want
    assert json.loads((tmp_path / "out" / "grasp.json").read_text()) == want
    head = (tmp_path / "out" / "selected.ply").read_bytes().split(b"end_header")[0]
    assert f"element vertex {len(idx)}".encode() in head
