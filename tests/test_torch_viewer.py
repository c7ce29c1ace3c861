"""PyTorch port vs the JAX package: the browser viewer (scripts/viewer.py)
and the trainer's live viewer.

tests/test_viewer.py's cases, ported: the train-vs-render throttle, the crop
box hiding half the scene, the resolution override, the render-path and
export endpoints over HTTP on an ephemeral port, the exported PLY's round
trip and the /scene payload. The scene is that file's (two clusters of 30
Gaussians at z = -2), its JAX state carried into the port. Each view mode
is held against the JAX viewer's frame of the same pose: both are JPEGs at
quality 85 of the same render (the port's encoder writes libjpeg's bytes,
the JAX viewer's Pillow the same), decoded within 2 of each other per
channel (a render within 1e-5 can round a pixel to the next uint8, which a
JPEG block spreads by at most a level or two). The trainer serves a frame
while its steps run, and a state handed to the viewer stays whole while
training goes on.
"""

import dataclasses
import io
import json
import threading
import time
import urllib.request

import numpy as np
import pytest
import torch
from PIL import Image

from gaussiangrasper_torch.engine import train_state as tts
from gaussiangrasper_torch.engine.trainer import TrainerConfig, make_trainer
from gaussiangrasper_torch.models.model import GaussianSplatConfig as TConfig
from gaussiangrasper_torch.ops.rasterize import RasterizeConfig as TRC
from gaussiangrasper_torch.scripts import viewer as tviewer
from gaussiangrasper_torch.scripts.export_ply import read_gaussian_ply
from gaussiangrasper_torch.utils.image_io import read_jpeg
from gaussiangrasper_tpu.scripts import viewer as jviewer
from tests.test_torch_train import convert
from tests.test_viewer import _scene

POSE = dict(eye=[0, 0, 0], center=[0, 0, -2], up=[0, 1, 0])


@pytest.fixture(scope="module")
def scenes():
    jstate, jcfg = _scene()
    tstate = convert(jstate)
    tcfg = TConfig(feature_dim=4, sh_degree=1)
    return jstate, jcfg, tstate, tcfg


def _decode(jpeg: bytes) -> np.ndarray:
    return read_jpeg(jpeg).astype(np.int64)


def test_throttle_matches_jax():
    for cls in (tviewer.RenderThrottle, jviewer.RenderThrottle):
        th = cls(train_util=0.9)
        th.training = True
        assert abs(th.delay_for(0.010) - 0.09) < 1e-9
        th.note(0.010, now=100.0)
        t0 = time.monotonic()
        th.admit(now=100.05)  # must sleep ~0.04 s
        assert 0.02 < time.monotonic() - t0 < 0.2
        idle = cls(train_util=0.99)
        idle.note(1.0)  # would imply a ~99 s delay
        t0 = time.monotonic()
        idle.admit()  # not training: no sleep
        assert time.monotonic() - t0 < 0.05
    th = tviewer.RenderThrottle()
    th.note(0.5)
    assert th.renders == 1 and th.render_s == 0.5


@pytest.mark.parametrize("mode", ["rgb", "depth", "normal"])
def test_frames_match_jax_viewer(scenes, mode):
    jstate, jcfg, tstate, tcfg = scenes
    jsrv = jviewer.make_server(lambda: jstate, jcfg, port=0, width=64, height=48)
    tsrv = tviewer.make_server(lambda: tstate, tcfg, port=0, width=64, height=48)
    try:
        want = np.asarray(Image.open(io.BytesIO(jsrv.render_pose(**POSE, mode=mode))), np.int64)
        got = _decode(tsrv.render_pose(**POSE, mode=mode))
    finally:
        jsrv.server_close()
        tsrv.server_close()
    assert got.shape == want.shape == (48, 64, 3)
    assert np.abs(got - want).max() <= 2, np.abs(got - want).max()
    assert got.std() > 0  # the clusters show


def test_feature_mode_and_look_at(scenes):
    _, _, tstate, tcfg = scenes
    np.testing.assert_array_equal(tviewer.look_at([0.3, 0.2, 1], [0, 0, -2], [0, 1, 0]),
                                  jviewer.look_at([0.3, 0.2, 1], [0, 0, -2], [0, 1, 0]))
    srv = tviewer.make_server(lambda: tstate, tcfg, port=0, width=64, height=48)
    try:
        img = _decode(srv.render_pose(**POSE, mode="feature"))
    finally:
        srv.server_close()
    assert img.shape == (48, 64, 3) and img.std() > 0


def test_crop_box_hides_half_the_scene(scenes):
    _, _, tstate, tcfg = scenes
    srv = tviewer.make_server(lambda: tstate, tcfg, port=0, width=64, height=48)
    try:
        full = _decode(srv.render_pose(**POSE)).astype(np.float32)
        left_only = _decode(srv.render_pose(**POSE, crop_min=[-10, -10, -10],
                                            crop_max=[0, 10, 10])).astype(np.float32)
    finally:
        srv.server_close()
    w = full.shape[1]
    right, left = (slice(None), slice(w // 2, None)), (slice(None), slice(0, w // 2))
    assert left_only[right].sum() < 0.25 * full[right].sum() + 1e-6
    assert left_only[left].sum() > 0.5 * full[left].sum()


def test_resolution_override(scenes):
    _, _, tstate, tcfg = scenes
    srv = tviewer.make_server(lambda: tstate, tcfg, port=0, width=64, height=48)
    try:
        img = _decode(srv.render_pose(**POSE, res=32))
    finally:
        srv.server_close()
    assert img.shape == (24, 32, 3)


def test_a_failed_render_is_retried_and_then_raised(scenes, capsys):
    _, _, tstate, tcfg = scenes
    calls = []

    def provider():
        calls.append(1)
        if len(calls) < 3:
            raise RuntimeError("state being replaced")
        return tstate

    srv = tviewer.make_server(provider, tcfg, port=0, width=32, height=24)
    try:
        assert _decode(srv.render_pose(**POSE)).shape == (24, 32, 3)
        assert "attempt 2 of 3 failed" in capsys.readouterr().err
        calls.clear()
        broken = tviewer.make_server(lambda: (_ for _ in ()).throw(RuntimeError("gone")), tcfg,
                                     port=0, width=32, height=24)
        with pytest.raises(RuntimeError, match="gone"):
            broken.render_pose(**POSE)
        broken.server_close()
        assert "attempt 3 of 3 failed" in capsys.readouterr().err
    finally:
        srv.server_close()


def test_render_path_and_export_over_http(scenes, tmp_path):
    _, _, tstate, tcfg = scenes
    srv = tviewer.make_server(lambda: tstate, tcfg, port=0, width=64, height=48,
                              out_dir=tmp_path / "renders")
    base = f"http://127.0.0.1:{srv.server_address[1]}"
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        body = json.dumps({"keyframes": [POSE, {**POSE, "eye": [0.4, 0, 0]}], "n_frames": 6,
                           "mode": "rgb", "res": 64}).encode()
        out = json.loads(urllib.request.urlopen(urllib.request.Request(base + "/render_path",
                                                                       data=body), timeout=120).read())
        assert out["n"] == 7 and len(out["frames"]) == 7  # 6 a transition, then the last keyframe
        assert (tmp_path / "renders" / out["frames"][0]).exists()
        jpeg = urllib.request.urlopen(base + "/frames/" + out["frames"][-1], timeout=60).read()
        assert _decode(jpeg).shape == (48, 64, 3)
        # the last frame is the second keyframe's pose, rendered alone
        assert jpeg == srv.render_pose(**POSE | {"eye": [0.4, 0, 0]}, res=64)
        ply = urllib.request.urlopen(base + "/export.ply", timeout=120).read()
        pc = urllib.request.urlopen(base + "/export/pointcloud.ply", timeout=120).read()
        assert ply.startswith(b"ply") and pc.startswith(b"ply")
        assert f"element vertex {int(tstate.alive.sum())}".encode() in pc
        missing = urllib.request.Request(base + "/frames/none.jpg")
        with pytest.raises(urllib.error.HTTPError, match="404"):
            urllib.request.urlopen(missing, timeout=30)
    finally:
        srv.shutdown()
        srv.server_close()


def test_round_trip_ply_matches_field(scenes, tmp_path):
    _, _, tstate, tcfg = scenes
    srv = tviewer.make_server(lambda: tstate, tcfg, port=0, width=32, height=24, out_dir=tmp_path)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        ply = urllib.request.urlopen(f"http://127.0.0.1:{srv.server_address[1]}/export.ply",
                                     timeout=120).read()
    finally:
        srv.shutdown()
        srv.server_close()
    (tmp_path / "x.ply").write_bytes(ply)
    arrays = read_gaussian_ply(tmp_path / "x.ply")
    keep = tstate.alive.numpy()
    assert arrays["means"].shape[0] == int(keep.sum())
    np.testing.assert_array_equal(arrays["means"], tstate.field.means.numpy()[keep])


def test_scene_payload_has_camera_rig_and_seed_cloud(scenes):
    _, _, tstate, tcfg = scenes
    from gaussiangrasper_torch.core.cameras import Camera as TCamera
    from gaussiangrasper_tpu.core.cameras import Camera as JCamera

    class FakeDM:
        seed_points = (np.linspace(0, 1, 30).reshape(10, 3), np.full((10, 3), 0.5))

        def __init__(self, camera_cls):
            self.camera_cls = camera_cls

        def __len__(self):
            return 3

        def camera(self, i):
            c2w = np.eye(4)[:3]
            c2w[0, 3] = 0.1 * i
            return self.camera_cls.create(fx=60.0, fy=60.0, cx=32.0, cy=24.0,
                                          camera_to_world=c2w, width=64, height=48)

    info = tviewer.scene_info_from_dm(FakeDM(TCamera))
    assert info == jviewer.scene_info_from_dm(FakeDM(JCamera))
    assert info["cameras"][1]["c2w"][0][3] == 0.1 and info["rgb"][0] == [127, 127, 127]

    srv = tviewer.make_server(lambda: tstate, tcfg, port=0, width=64, height=48, scene_info=info)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    base = f"http://127.0.0.1:{srv.server_address[1]}"
    try:
        assert json.loads(urllib.request.urlopen(base + "/scene", timeout=30).read()) == info
        page = urllib.request.urlopen(base + "/", timeout=30).read().decode()
        assert "/scene" in page and "camera rig" in page
    finally:
        srv.shutdown()
        srv.server_close()


SMALL = TConfig(feature_dim=8, sh_degree=1, num_downscales=0, warmup_length=2, refine_every=2,
                raster=TRC(tile_size=16, max_gaussians_per_tile=256))


@pytest.fixture(scope="module")
def tabletop(tmp_path_factory):
    from gaussiangrasper_torch.data.synthetic import generate_tabletop

    return generate_tabletop(tmp_path_factory.mktemp("scene"), width=32, height=24, n_views=2,
                             feature_downscale=2, seed_points=300)


def test_trainer_serves_frames_while_training(tabletop, tmp_path, monkeypatch):
    """A trainer with viewer_port answers /render while its steps run: the
    step after the first waits until the client holds a frame."""
    config = TrainerConfig(data=tabletop, output_dir=tmp_path, experiment_name="live",
                           max_iterations=4, steps_per_save=4, capacity=1024, viewer_port=0,
                           model=SMALL)
    trainer = make_trainer(config, device="cpu")
    trainer.setup()
    served, steps = threading.Event(), []
    step_fn = tts.train_step

    def gated_step(state, *a, **k):
        if state.step == 1:
            assert served.wait(120), "no frame was served during training"
        steps.append(state.step)
        return step_fn(state, *a, **k)

    monkeypatch.setattr(tts, "train_step", gated_step)
    t = threading.Thread(target=trainer.train)
    t.start()
    try:
        while trainer.viewer is None:
            time.sleep(0.01)
        port = trainer.viewer.server_address[1]
        req = urllib.request.Request(f"http://127.0.0.1:{port}/render",
                                     data=json.dumps({**POSE, "mode": "rgb"}).encode())
        frame = urllib.request.urlopen(req, timeout=120).read()
        served.set()
    finally:
        served.set()
        t.join(timeout=300)
    assert not t.is_alive() and steps == [0, 1, 2, 3] and trainer.state.step == 4
    assert _decode(frame).shape == (240, 320, 3)
    assert trainer.viewer.throttle.renders == 1 and not trainer.viewer.throttle.training
    with pytest.raises(OSError):  # shut down with the loop
        urllib.request.urlopen(req, timeout=5)


def test_a_served_state_stays_whole_while_training(tabletop, tmp_path):
    """train_step and refine_step write none of the state they are given:
    the viewer's snapshot keeps its every tensor, bit for bit."""
    config = TrainerConfig(data=tabletop, output_dir=tmp_path, capacity=1024, model=SMALL)
    trainer = make_trainer(config, device="cpu")
    state = trainer.setup()
    cam, batch = trainer.dm.get_batch(0)
    state, _ = tts.train_step(state, cam, batch, SMALL)  # nonzero moments and stats
    tensors = [t for t in _leaves(state) if isinstance(t, torch.Tensor)]
    copies = [t.clone() for t in tensors]
    new, _ = tts.train_step(state, cam, batch, SMALL)
    new = tts.refine_step(new, SMALL, cam.width, cam.height, len(trainer.dm))
    assert new.step == 2 and not all(torch.equal(a, b) for a, b in zip(new.field, state.field))
    for t, c in zip(tensors, copies):
        assert torch.equal(t, c)


def _leaves(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif dataclasses.is_dataclass(x):
        for f in dataclasses.fields(x):
            yield from _leaves(getattr(x, f.name))
    elif isinstance(x, dict):
        for v in x.values():
            yield from _leaves(v)
    elif isinstance(x, (tuple, list)):
        for v in x:
            yield from _leaves(v)
