"""PyTorch port vs the JAX package: the render-and-query serving slice.

One field (random, from a numpy seed, SH degree 4 live at step 4000, the
full 3 + 32 + 1 + 3 = 39 channels) goes through the JAX package's
`models.model.render` (the xla backend on the CPU) and, converted by
`weights.state_from_numpy`, through the port's. Image channels agree at
atol 1e-5 / rtol 1e-4 (float32 sums in another order); the fea_up lift,
relevancy, SSIM and the CLIs' outputs are held to the JAX functions too.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussiangrasper_torch.engine import checkpoint as tckpt
from gaussiangrasper_torch.engine.weights import state_from_numpy
from gaussiangrasper_torch.models import losses as tl
from gaussiangrasper_torch.models.gaussian_field import FIELD_KEYS
from gaussiangrasper_torch.models.model import GaussianSplatConfig as TConfig
from gaussiangrasper_torch.models.model import feature_pca_vis as t_pca
from gaussiangrasper_torch.scripts import query as tquery
from gaussiangrasper_torch.scripts import render as trender
from gaussiangrasper_torch.utils.image_io import write_png
from gaussiangrasper_tpu.core.cameras import Camera as JCamera
from gaussiangrasper_tpu.models import losses as jl
from gaussiangrasper_tpu.models.efd import init_mlp, mlp_apply
from gaussiangrasper_tpu.models.gaussian_field import GaussianParams as JParams
from gaussiangrasper_tpu.models.model import GaussianSplatConfig as JConfig
from gaussiangrasper_tpu.models.model import feature_pca_vis as j_pca
from gaussiangrasper_tpu.models.model import render as j_render
from gaussiangrasper_tpu.scripts.query import relevancy_map as j_relevancy
from tests.test_torch_core import H, W, T, close

N, STEP = 300, 4000


def _orbit_c2w(angle):
    """OpenGL camera on a circle around (0, 0, -3), looking at it."""
    target = np.array([0.0, 0.0, -3.0])
    eye = target + 3.0 * np.array([np.sin(angle), 0.0, np.cos(angle)])
    back = (eye - target) / np.linalg.norm(eye - target)
    right = np.cross([0.0, 1.0, 0.0], back)
    right /= np.linalg.norm(right)
    up = np.cross(back, right)
    return np.stack([right, up, back, eye], 1).astype(np.float32)


@pytest.fixture(scope="module")
def served():
    """JAX field + fea_up, their numpy leaves, two cameras and the JAX
    renders of both views."""
    rng = np.random.default_rng(0)
    f32 = np.float32
    sh = np.zeros((N, 25, 3), f32)
    sh[:, 0] = rng.uniform(-1.5, 1.5, (N, 3))
    sh[:, 1:] = 0.2 * rng.normal(size=(N, 24, 3))
    field = {
        "means": (np.concatenate([rng.uniform(-1.2, 1.2, (N, 2)), rng.uniform(-4.0, -2.0, (N, 1))], 1)).astype(f32),
        "log_scales": rng.uniform(-4.0, -2.5, (N, 3)).astype(f32),
        "quats": rng.normal(size=(N, 4)).astype(f32),
        "opacity_logits": rng.normal(size=N).astype(f32),
        "sh_coeffs": sh,
        "features": rng.uniform(-1, 1, (N, 32)).astype(f32),
    }
    alive = np.ones(N, bool)
    alive[-7:] = False
    fea_up = {k: np.asarray(v) for k, v in init_mlp(jax.random.PRNGKey(1), 32, 512, (128,)).items()}
    c2ws = [np.eye(4, dtype=f32)[:3], _orbit_c2w(0.3)]
    intr = (0.8 * W, 0.8 * W, W / 2, H / 2)
    jcfg = JConfig(feature_dim=32)
    jfield = JParams(**{k: jnp.asarray(v) for k, v in field.items()})
    rend = jax.jit(lambda f, a, c: j_render(f, a, c, STEP, jcfg))
    jouts = []
    for c2w in c2ws:
        o = rend(jfield, jnp.asarray(alive), JCamera.create(*intr, c2w, W, H))
        jouts.append({k: np.asarray(o[k]) for k in ("rgb", "feature", "depth", "normal", "alpha")})
    return dict(field=field, alive=alive, fea_up=fea_up, c2ws=c2ws, intr=intr, jouts=jouts)


def _state(served):
    return state_from_numpy(served["field"], served["alive"], served["fea_up"], STEP)


def test_render_matches_jax(served):
    state = _state(served)
    for c2w, ref in zip(served["c2ws"], served["jouts"]):
        cam = trender.Camera.create(*served["intr"], c2w, W, H)
        outs = trender.render_view(state, cam, TConfig())
        assert int(outs["bins"].pair_overflow) == 0 and int(outs["bins"].overflow) == 0
        for k in ("rgb", "feature", "depth", "normal", "alpha"):
            close(outs[k], ref[k], atol=1e-5, rtol=1e-4, msg=k)
        assert float(outs["alpha"].max()) > 0.5  # the view sees the field


def test_lift_relevancy_and_pca_match_jax(served):
    state = _state(served)
    fea = served["jouts"][0]["feature"]
    jclip = mlp_apply({k: jnp.asarray(v) for k, v in served["fea_up"].items()}, jnp.asarray(fea))
    tclip = trender.lift(state.fea_up, T(fea))
    close(tclip, jclip, atol=1e-5, rtol=1e-4, msg="fea_up")
    rng = np.random.default_rng(5)
    q = rng.normal(size=512).astype(np.float32)
    canon = rng.normal(size=(4, 512)).astype(np.float32)
    close(tquery.relevancy_map(tclip, T(q), T(canon)),
          j_relevancy(jclip, jnp.asarray(q), jnp.asarray(canon)), atol=1e-5, rtol=1e-4)
    tp, jp = t_pca(T(fea)).numpy(), np.asarray(j_pca(jnp.asarray(fea)))
    for c in range(3):  # eigenvector signs are arbitrary: a flip maps v to 1 - v
        d = min(np.abs(tp[..., c] - jp[..., c]).max(), np.abs(tp[..., c] - (1 - jp[..., c])).max())
        assert d < 1e-3, (c, d)


def test_eval_losses_match_jax():
    rng = np.random.default_rng(6)
    a, b = (rng.uniform(size=(40, 50, 3)).astype(np.float32) for _ in range(2))
    mask = rng.uniform(size=(40, 50)) > 0.3
    close(tl.ssim(T(a), T(b)), jl.ssim(jnp.asarray(a), jnp.asarray(b)), atol=1e-6, rtol=0)
    close(tl.psnr(T(a), T(b)), jl.psnr(jnp.asarray(a), jnp.asarray(b)), rtol=1e-5)
    close(tl.psnr(T(a), T(b), T(mask)), jl.psnr(jnp.asarray(a), jnp.asarray(b), jnp.asarray(mask)),
          rtol=1e-5)
    close(tl.masked_l1(T(a[..., 0]), T(b[..., 0]), T(mask)),
          jl.masked_l1(jnp.asarray(a[..., 0]), jnp.asarray(b[..., 0]), jnp.asarray(mask)))
    close(tl.cosine_similarity_loss(T(a.reshape(-1, 3)), T(b.reshape(-1, 3)), T(mask.reshape(-1))),
          jl.cosine_similarity_loss(jnp.asarray(a.reshape(-1, 3)), jnp.asarray(b.reshape(-1, 3)),
                                    weights=jnp.asarray(mask.reshape(-1))))


def _write_run(served, run_dir):
    state = _state(served)
    tckpt.save_run(run_dir, state, TConfig(), experiment_name="tiny")
    rng = np.random.default_rng(8)
    V = len(served["c2ws"])
    valid = np.ones((V, H, W), bool)
    valid[:, :5] = False
    normal = rng.normal(size=(V, H, W, 3)).astype(np.float32)
    tckpt.save_cameras(
        run_dir, [served["intr"][0]] * V, [served["intr"][1]] * V, [served["intr"][2]] * V,
        [served["intr"][3]] * V, np.stack(served["c2ws"]), W, H, dataparser_scale=0.5,
        dataparser_transform=np.concatenate([np.eye(3)[[1, 0, 2]], np.zeros((3, 1))], 1),
        image=rng.uniform(size=(V, H, W, 3)).astype(np.float32),
        depth=rng.uniform(1.0, 4.0, (V, H, W)).astype(np.float32), normal=normal,
        valid_mask=valid)
    return state


def test_render_cli_outputs_and_metrics(served, tmp_path):
    _write_run(served, tmp_path)
    trender.main(["--run-dir", str(tmp_path), "--device", "cpu"])
    out = tmp_path / "renders"
    with np.load(tmp_path / "cameras.npz") as z:
        gt = {k: z[k] for k in z.files}
    metrics = json.loads((out / "metrics.json").read_text())
    assert metrics["experiment_name"] == "tiny"
    assert metrics["binning"] == [{"overflow": 0, "dropped_tiles": 0, "pair_overflow": 0}] * 2
    inv_rot = np.linalg.inv(gt["dataparser_transform"][:3, :3])
    for i, ref in enumerate(served["jouts"]):
        for sub, name in (("rgb", f"{i:05d}.png"), ("normal", f"{i:05d}.png"),
                          ("depth", f"{i:05d}.png")):
            assert (out / sub / name).read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
        clip = np.load(out / "clip" / f"{i:05d}_fea.npy")
        assert clip.shape == (H, W, 512) and clip.dtype == np.float16
        close(np.load(out / "depth" / f"{i:05d}.npy"), ref["depth"][..., 0] / 0.5, atol=2e-5, rtol=1e-4)
        close(np.load(out / "normal" / f"{i:05d}.npy"), ref["normal"] @ inv_rot.T, atol=1e-5, rtol=1e-4)
        row = metrics["results"]["per_view"][i]
        rgb, img = jnp.clip(jnp.asarray(ref["rgb"]), 0, 1), jnp.asarray(gt["image"][i])
        dmask = jnp.asarray(gt["depth"][i] > 0.05)
        want = {
            "psnr": float(jl.psnr(rgb, img)),
            "ssim": float(jl.ssim(rgb, img)),
            "psnr_masked": float(jl.psnr(rgb, img, jnp.asarray(gt["valid_mask"][i]))),
            "depth_mae": float(jl.masked_l1(jnp.asarray(ref["depth"][..., 0]),
                                            jnp.asarray(gt["depth"][i]), dmask)) / 0.5,
            "normal_cos": 1.0 - float(jl.cosine_similarity_loss(
                jnp.asarray(ref["normal"]).reshape(-1, 3),
                jnp.asarray(gt["normal"][i]).reshape(-1, 3), weights=dmask.reshape(-1))),
        }
        for k, v in want.items():
            close(row[k], v, atol=1e-5, rtol=1e-4, msg=k)


def test_query_cli_matches_jax_relevancy(served, tmp_path):
    _write_run(served, tmp_path)
    rng = np.random.default_rng(9)
    q = rng.normal(size=(2, 512)).astype(np.float32)
    canon = rng.normal(size=(4, 512)).astype(np.float32)
    np.save(tmp_path / "q.npy", q)
    np.save(tmp_path / "c.npy", canon)
    tquery.main(["--run-dir", str(tmp_path), "--text-embedding", str(tmp_path / "q.npy"),
                 "--canonical-embedding", str(tmp_path / "c.npy"), "--views", "0", "1",
                 "--device", "cpu"])
    fea_up = {k: jnp.asarray(v) for k, v in served["fea_up"].items()}
    for v, ref in enumerate(served["jouts"]):
        jclip = mlp_apply(fea_up, jnp.asarray(ref["feature"]))
        for qi in range(2):
            got = np.load(tmp_path / "query" / f"view{v:04d}_q{qi}.npy")
            close(got, j_relevancy(jclip, jnp.asarray(q[qi]), jnp.asarray(canon)),
                  atol=1e-5, rtol=1e-4)
            assert (tmp_path / "query" / f"view{v:04d}_q{qi}.png").exists()
    with pytest.raises(SystemExit, match="weights"):
        tquery.main(["--run-dir", str(tmp_path), "--text", "mug", "--device", "cpu"])


def test_checkpoint_round_trip(served, tmp_path):
    state = _write_run(served, tmp_path)
    cfg, loaded, name = tckpt.load_run(tmp_path, "cpu")
    assert cfg == TConfig() and name == "tiny" and loaded.step == STEP
    for k, a, b in zip(FIELD_KEYS, state.field, loaded.field):
        assert torch.equal(a, b), k
    assert torch.equal(state.alive, loaded.alive)
    for (ka, a), (kb, b) in zip(state.fea_up.state_dict().items(),
                                loaded.fea_up.state_dict().items()):
        assert ka == kb and torch.equal(a, b)
    cams, data = tckpt.load_cameras(tmp_path, "cpu")
    assert len(cams) == 2 and torch.equal(cams[1].camera_to_world, T(served["c2ws"][1]))
    assert float(data["dataparser_scale"]) == 0.5


def test_png_writer_round_trip(tmp_path):
    import zlib

    img = np.random.default_rng(10).integers(0, 256, (5, 7, 3), dtype=np.uint8)
    write_png(tmp_path / "x.png", img)
    raw = (tmp_path / "x.png").read_bytes()
    assert raw[:8] == b"\x89PNG\r\n\x1a\n"
    idat_len = int.from_bytes(raw[33:37], "big")
    assert raw[37:41] == b"IDAT"
    rows = np.frombuffer(zlib.decompress(raw[41:41 + idat_len]), np.uint8).reshape(5, 1 + 21)
    assert (rows[:, 0] == 0).all()
    np.testing.assert_array_equal(rows[:, 1:].reshape(5, 7, 3), img)
