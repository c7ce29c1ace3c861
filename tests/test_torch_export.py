"""PyTorch port vs the JAX package: the export tools.

The same seeded numpy inputs go into the JAX function and the port's:
- `write_gaussian_ply` byte-equal, and each package reads the other's file;
- `write_ply_points` / `write_ply_mesh` byte-equal;
- `unproject_view`, `TSDFVolume` (fused volume and weights) and
  `marching_tetrahedra` equal: the port keeps the JAX tool's float32 pixel
  arithmetic (its camera values are float32 device scalars);
- the texture path (`unwrap_per_triangle`, `face_texels`,
  `bake_from_views`) equal, and `write_obj`'s .obj / .mtl text equal and its
  PNG (the port's stdlib writer, the JAX tool's Pillow) the same pixels;
- the three export CLIs on the CPU on a port run: `export_ply`'s file
  byte-equal to the JAX writer's for the loaded state, a point cloud and a
  mesh, a textured .obj.
"""

import numpy as np
import pytest
from PIL import Image

import jax.numpy as jnp

from gaussiangrasper_torch.core.cameras import Camera as TCamera
from gaussiangrasper_torch.models.gaussian_field import FIELD_KEYS, field_from_numpy
from gaussiangrasper_torch.scripts import common as tcommon
from gaussiangrasper_torch.scripts import export_ply as tply
from gaussiangrasper_torch.scripts import export_pointcloud as tpc
from gaussiangrasper_torch.scripts import export_texture as ttex
from gaussiangrasper_torch.scripts import train as ttrain
from gaussiangrasper_torch.utils.image_io import read_png
from gaussiangrasper_tpu.core.cameras import Camera as JCamera
from gaussiangrasper_tpu.data.synthetic import generate_tabletop
from gaussiangrasper_tpu.models.gaussian_field import GaussianParams as JParams
from gaussiangrasper_tpu.scripts import export_ply as jply
from gaussiangrasper_tpu.scripts import export_pointcloud as jpc
from gaussiangrasper_tpu.scripts import export_texture as jtex
from tests.test_torch_edit import random_field

W, H = 40, 30


def jfield(arrays):
    return JParams(**{k: jnp.asarray(v) for k, v in arrays.items()})


@pytest.mark.parametrize("sh_k", [1, 16])
def test_gaussian_ply_byte_equal_and_cross_read(tmp_path, sh_k):
    rng = np.random.default_rng(10)
    arrays = random_field(rng, 80, sh_k=sh_k)
    alive = rng.uniform(size=80) < 0.7
    nj = jply.write_gaussian_ply(tmp_path / "j.ply", jfield(arrays), alive)
    nt = tply.write_gaussian_ply(tmp_path / "t.ply", field_from_numpy(arrays), alive)
    assert nj == nt == alive.sum()
    assert (tmp_path / "t.ply").read_bytes() == (tmp_path / "j.ply").read_bytes()
    for a, b in ((jply.read_gaussian_ply(tmp_path / "t.ply"), tply.read_gaussian_ply(tmp_path / "j.ply")),
                 (tply.read_gaussian_ply(tmp_path / "t.ply"), {k: arrays[k][alive] for k in arrays})):
        for k in ("means", "sh_coeffs", "opacity_logits", "log_scales", "quats"):
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_point_and_mesh_writers_byte_equal(tmp_path):
    rng = np.random.default_rng(11)
    xyz = rng.normal(size=(50, 3))
    rgb = rng.integers(0, 256, (50, 3))
    verts = rng.normal(size=(20, 3)).astype(np.float32)
    faces = rng.integers(0, 20, (30, 3))
    for pkg, tag in ((jpc, "j"), (tpc, "t")):
        pkg.write_ply_points(tmp_path / f"{tag}_p.ply", xyz, rgb)
        pkg.write_ply_mesh(tmp_path / f"{tag}_m.ply", verts, faces)
    for name in ("p", "m"):
        assert (tmp_path / f"t_{name}.ply").read_bytes() == (tmp_path / f"j_{name}.ply").read_bytes()


def cameras(n, seed):
    """n OpenGL cameras on a ring at distance 2, looking at the origin."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        a = 2 * np.pi * i / n + rng.uniform(0, 0.3)
        eye = np.array([2 * np.cos(a), 2 * np.sin(a), 0.6])
        fwd = -eye / np.linalg.norm(eye)
        right = np.cross(fwd, [0.0, 0.0, 1.0])
        right /= np.linalg.norm(right)
        up = np.cross(right, fwd)
        c2w = np.stack([right, up, -fwd, eye], 1).astype(np.float32)
        args = (37.3 + i, 36.1, W / 2 + 0.3, H / 2 - 0.2, c2w, W, H)
        out.append((JCamera.create(*args), TCamera.create(*args, device="cpu")))
    return out


def sphere_depth(cam, radius=0.6):
    """Ray-traced depth (along -z) of a sphere at the origin, 0 on a miss."""
    c2w = np.asarray(cam.camera_to_world, np.float64)
    ys, xs = np.mgrid[0:H, 0:W]
    d_cam = np.stack([(xs + 0.5 - float(cam.cx)) / float(cam.fx),
                      -(ys + 0.5 - float(cam.cy)) / float(cam.fy), -np.ones_like(xs, float)], -1)
    d = d_cam @ c2w[:3, :3].T
    o = c2w[:3, 3]
    b = d @ o
    c = o @ o - radius ** 2
    a = (d * d).sum(-1)
    disc = b * b - a * c
    t = np.where(disc > 0, (-b - np.sqrt(np.maximum(disc, 0))) / a, 0.0)
    return t.astype(np.float32)  # t is the depth along -z: d_cam's z is -1


def test_unproject_view_matches_jax():
    rng = np.random.default_rng(12)
    (jc, tc), = cameras(1, 12)
    depth = sphere_depth(jc)
    depth[0, :5] = 9.0  # past max_depth
    rgb = rng.uniform(0, 255, (H, W, 3)).astype(np.float32)
    want = jpc.unproject_view(depth, rgb, jc, max_depth=8.0)
    got = tpc.unproject_view(depth, rgb, tc, max_depth=8.0)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, np.asarray(b))
    assert len(want[0]) > 100


@pytest.fixture(scope="module")
def fused():
    """The same 4 sphere views fused by each package."""
    cams = cameras(4, 13)
    bounds = np.array([[-0.8, -0.8, -0.8], [0.8, 0.8, 0.8]])
    vols = [jpc.TSDFVolume(bounds, resolution=24, trunc=0.1),
            tpc.TSDFVolume(bounds, resolution=24, trunc=0.1)]
    for jc, tc in cams:
        depth = sphere_depth(jc)
        vols[0].integrate(depth, jc)
        vols[1].integrate(depth, tc)
    return cams, vols


def test_tsdf_fusion_and_mesh_match_jax(fused):
    _, (jv, tv) = fused
    np.testing.assert_array_equal(tv.tsdf, jv.tsdf)
    np.testing.assert_array_equal(tv.weight, jv.weight)
    assert (jv.weight > 0).mean() > 0.2
    (jverts, jfaces), (tverts, tfaces) = jv.extract_mesh(), tv.extract_mesh()
    np.testing.assert_array_equal(tverts, jverts)
    np.testing.assert_array_equal(tfaces, jfaces)
    assert len(jfaces) > 100


def test_marching_tetrahedra_matches_jax():
    r = 20
    g = (np.arange(r) + 0.5) / r - 0.5
    zz, yy, xx = np.meshgrid(g, g, g, indexing="ij")
    sdf = (np.sqrt(xx ** 2 + 1.3 * yy ** 2 + zz ** 2) - 0.3).astype(np.float32)
    mask = np.random.default_rng(14).uniform(size=sdf.shape) < 0.95
    args = (sdf, mask, np.array([-0.5, -0.4, -0.6]), np.array([1 / r, 1.1 / r, 0.9 / r]))
    (jv, jf), (tv, tf) = jpc.marching_tetrahedra(*args), tpc.marching_tetrahedra(*args)
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_array_equal(tf, jf)
    assert len(jf) > 100


def test_texture_bake_and_obj_match_jax(fused, tmp_path):
    cams, (jv, _) = fused
    verts, faces = jv.extract_mesh()
    faces = faces[::40]  # a sample of the surface
    rng = np.random.default_rng(15)
    images = [rng.uniform(0, 1, (H, W, 3)).astype(np.float32) for _ in cams]
    depths = [sphere_depth(jc) for jc, _ in cams]
    for cell_px in (4, 6):
        ju, jt_ = jtex.bake_mesh_texture(verts, faces, images, depths, [c[0] for c in cams],
                                         cell_px=cell_px)
        tu, tt_ = ttex.bake_mesh_texture(verts, faces, images, depths, [c[1] for c in cams],
                                         cell_px=cell_px)
        np.testing.assert_array_equal(tu, ju)
        np.testing.assert_array_equal(tt_, jt_)
    assert (jt_ != 0.5).any()
    jpath = jtex.write_obj(tmp_path / "j", "mesh", verts, faces, ju, jt_)
    tpath = ttex.write_obj(tmp_path / "t", "mesh", verts, faces, tu, tt_)
    assert tpath.read_text() == jpath.read_text()
    assert (tmp_path / "t" / "mesh.mtl").read_text() == (tmp_path / "j" / "mesh.mtl").read_text()
    png = np.asarray(Image.open(tmp_path / "j" / "mesh.png"))
    np.testing.assert_array_equal(read_png(tmp_path / "t" / "mesh.png"), png)
    np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "t" / "mesh.png")), png)


def test_export_clis_on_a_port_run(tmp_path):
    scene = generate_tabletop(tmp_path / "scene", width=32, height=24, n_views=3,
                              feature_downscale=2)
    ttrain.main(["--data", str(scene), "--output-dir", str(tmp_path / "out"), "--max-iterations",
                 "1", "--capacity", "4096", "--feature-dim", "16", "--sh-degree", "1",
                 "--max-tiles-per-gaussian", "16", "--device", "cpu"])
    run = tmp_path / "out" / "gaussian-splatting"

    out = tply.main(["--run-dir", str(run), "--device", "cpu"])
    _, _, state = tcommon.load_run(run, device="cpu")
    arrays = {k: getattr(state.field, k).numpy() for k in FIELD_KEYS}
    jply.write_gaussian_ply(tmp_path / "j.ply", jfield(arrays), state.alive.numpy())
    assert out.read_bytes() == (tmp_path / "j.ply").read_bytes()

    tpc.main(["--run-dir", str(run), "--mesh", "--tsdf-resolution", "24", "--device", "cpu"])
    for name, kind in (("pointcloud.ply", b"element vertex "), ("pointcloud_mesh.ply", b"element face ")):
        data = (run / name).read_bytes()
        assert data.startswith(b"ply\n") and kind in data
    n = int((run / "pointcloud.ply").read_bytes().split(b"element vertex ")[1].split(b"\n")[0])
    assert n > 100

    obj = ttex.main(["--run", str(run), "--output", str(tmp_path / "tex"), "--resolution", "24",
                     "--cell-px", "4", "--device", "cpu"])
    lines = obj.read_text().splitlines()
    assert lines[:2] == ["mtllib mesh.mtl", "usemtl mesh"]
    assert sum(ln.startswith("f ") for ln in lines) > 0
    assert read_png(tmp_path / "tex" / "mesh.png").ndim == 3
