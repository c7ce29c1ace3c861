"""PyTorch port vs the JAX package: core transforms, SH, cameras, projection.

Inputs are made with numpy from a seed and go through both packages on the
CPU (JAX forced there by conftest). The helpers at the top are shared by
the other tests/test_torch_*.py files.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussiangrasper_torch._device import full_f32, resolve_device
from gaussiangrasper_torch.core import sh as tsh
from gaussiangrasper_torch.core.cameras import Camera as TCamera, view_matrix as t_view_matrix
from gaussiangrasper_torch.core.transforms import quat_to_rotmat as t_quat_to_rotmat
from gaussiangrasper_torch.core.transforms import random_quats as t_random_quats
from gaussiangrasper_torch.models.gaussian_field import GaussianParams as TParams
from gaussiangrasper_torch.models.gaussian_field import init_random, random_draws, rgb_to_sh0
from gaussiangrasper_torch.models.model import smallest_axis_normals as t_normals
from gaussiangrasper_torch.ops.projection import project_gaussians as t_project
from gaussiangrasper_tpu.core import sh as jsh
from gaussiangrasper_tpu.core.cameras import Camera as JCamera, view_matrix as j_view_matrix
from gaussiangrasper_tpu.core.transforms import quat_to_rotmat as j_quat_to_rotmat
from gaussiangrasper_tpu.models.gaussian_field import GaussianParams as JParams
from gaussiangrasper_tpu.models.model import smallest_axis_normals as j_normals
from gaussiangrasper_tpu.ops.projection import project_gaussians as j_project

# pytest-xdist runs several workers; one intra-op thread each keeps them
# from oversubscribing the cores
torch.set_num_threads(1)

W, H = 64, 48
ATOL, RTOL = 1e-6, 1e-5


def T(x):
    """numpy/JAX array -> CPU torch tensor (float64 -> float32)."""
    a = np.array(x)  # a writable copy
    if a.dtype == np.float64:
        a = a.astype(np.float32)
    return torch.as_tensor(a)


def close(a, b, atol=ATOL, rtol=RTOL, msg=""):
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = b.detach().numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    np.testing.assert_allclose(a, b, atol=atol, rtol=rtol, err_msg=msg)


def make_scene(seed, n, width=W, height=H, n_channels=3):
    """Random Gaussians in front of an identity OpenGL camera (world -z),
    the distribution of tests/test_rasterize.py:make_scene, drawn with numpy."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    means = np.concatenate([rng.uniform(-1.5, 1.5, (n, 2)), -rng.uniform(2.0, 6.0, (n, 1))], -1)
    return dict(
        means=means.astype(f32),
        scales=np.exp(rng.uniform(-4.5, -2.5, (n, 3))).astype(f32),
        quats=rng.normal(size=(n, 4)).astype(f32),
        opacities=(1.0 / (1.0 + np.exp(-rng.normal(size=n)))).astype(f32),
        colors=rng.uniform(size=(n, n_channels)).astype(f32),
        intr=(0.6 * width, 0.6 * width, width / 2, height / 2),
        c2w=np.eye(4, dtype=f32)[:3],
        width=width, height=height,
    )


def cameras(scene):
    fx, fy, cx, cy = scene["intr"]
    args = (fx, fy, cx, cy, scene["c2w"], scene["width"], scene["height"])
    return JCamera.create(*args), TCamera.create(*args, device="cpu")


def project_both(scene, mask=None):
    """(JAX ProjectedGaussians, torch ProjectedGaussians) of one scene."""
    jcam, tcam = cameras(scene)
    jp = j_project(jnp.asarray(scene["means"]), jnp.asarray(scene["scales"]),
                   jnp.asarray(scene["quats"]), j_view_matrix(jcam.camera_to_world),
                   jcam.fx, jcam.fy, jcam.cx, jcam.cy, jcam.width, jcam.height,
                   mask=None if mask is None else jnp.asarray(mask))
    tp = t_project(T(scene["means"]), T(scene["scales"]), T(scene["quats"]),
                   t_view_matrix(tcam.camera_to_world), tcam.fx, tcam.fy, tcam.cx, tcam.cy,
                   tcam.width, tcam.height, mask=None if mask is None else torch.as_tensor(mask))
    return jp, tp


def test_quat_to_rotmat():
    q = np.random.default_rng(0).normal(size=(64, 4)).astype(np.float32)
    close(t_quat_to_rotmat(T(q)), j_quat_to_rotmat(jnp.asarray(q)))


def test_random_quats_are_unit():
    u = np.random.default_rng(1).random((3, 100), np.float32)
    q = t_random_quats(T(u))
    close(torch.linalg.vector_norm(q, dim=-1), np.ones(100, np.float32))


@pytest.mark.parametrize("degree", [0, 1, 2, 3, 4])
def test_eval_sh(degree):
    rng = np.random.default_rng(degree)
    d = rng.normal(size=(50, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    coeffs = rng.normal(size=(50, 25, 3)).astype(np.float32)
    close(tsh.eval_sh(degree, T(d), T(coeffs)),
          jsh.eval_sh(degree, jnp.asarray(d), jnp.asarray(coeffs)))


def test_view_matrix_and_camera():
    rng = np.random.default_rng(2)
    R = t_quat_to_rotmat(T(rng.normal(size=4).astype(np.float32))).numpy()
    c2w = np.concatenate([R, rng.normal(size=(3, 1)).astype(np.float32)], 1)
    close(t_view_matrix(T(c2w)), j_view_matrix(jnp.asarray(c2w)))
    jcam = JCamera.create(100.0, 90.0, 32.0, 24.0, c2w, W, H).rescale(0.5)
    tcam = TCamera.create(100.0, 90.0, 32.0, 24.0, c2w, W, H).rescale(0.5)
    assert (tcam.width, tcam.height) == (jcam.width, jcam.height)
    for k in ("fx", "fy", "cx", "cy"):
        close(getattr(tcam, k), getattr(jcam, k))
    close(tcam.origin, jcam.origin)


def test_project_gaussians_with_culling():
    n = 300
    scene = make_scene(3, n)
    scene["means"][:10, 2] = 1.0      # behind the camera: culled by depth
    mask = np.ones(n, bool)
    mask[10:20] = False               # culled by mask
    jp, tp = project_both(scene, mask)
    for name, a, b in zip(jp._fields, jp, tp):
        close(b, a, msg=name)
    assert (tp.radii[:20] == 0).all() and (tp.xys[:20] == 0).all()


def test_smallest_axis_normals_and_pad_to():
    rng = np.random.default_rng(4)
    ls = rng.normal(size=(40, 3)).astype(np.float32)
    ls[:5] = 0.5  # ties pick the first axis
    q = rng.normal(size=(40, 4)).astype(np.float32)
    close(t_normals(T(ls), T(q)), j_normals(jnp.asarray(ls), jnp.asarray(q)))
    arrays = [rng.normal(size=s).astype(np.float32)
              for s in ((7, 3), (7, 3), (7, 4), (7,), (7, 25, 3), (7, 32))]
    jpad = JParams(*map(jnp.asarray, arrays)).pad_to(12)
    tpad = TParams(*map(T, arrays)).pad_to(12)
    for name, a, b in zip(JParams._fields, jpad, tpad):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a), err_msg=name)


def test_resolve_device_raises_without_cuda():
    assert resolve_device("cpu").type == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda requested"):
            resolve_device(None)


def test_full_f32_turns_tf32_off_and_restores():
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    try:
        with full_f32():
            assert not torch.backends.cuda.matmul.allow_tf32
            assert not torch.backends.cudnn.allow_tf32
        assert torch.backends.cuda.matmul.allow_tf32 and torch.backends.cudnn.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


def test_init_random_from_injected_draws():
    draws = random_draws(np.random.default_rng(5), 30)
    field, alive = init_random(draws, extent=4.0, capacity=40, init_scale=0.02)
    assert field.capacity == 40 and int(alive.sum()) == 30 and not alive[30:].any()
    close(field.means[:30], (draws["means"] - 0.5) * 4.0)
    close(field.sh_coeffs[:30, 0], rgb_to_sh0(draws["rgb"]))
    assert (field.sh_coeffs[:, 1:] == 0).all()
    close(torch.linalg.vector_norm(field.quats, dim=-1), np.ones(40, np.float32))
    close(torch.sigmoid(field.opacity_logits[:30]), np.full(30, 0.1, np.float32))
    close(field.log_scales[:30], np.full((30, 3), np.log(0.02), np.float32))
