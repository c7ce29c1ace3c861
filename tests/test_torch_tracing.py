"""The port's spans and counters (utils/profiler.py) on the CPU.

- With no profiler recording, `PROFILER.section` is one shared null
  context: torch's range constructors raise in the test, and nothing is
  recorded.
- A 3-step `Trainer.train` under `torch.profiler.profile` exports a Chrome
  trace holding the step's spans, nested as named, on the trace's clock,
  with the step number in `train_step`'s args; the same three steps with
  spans on and off give bit-equal states and losses.
- `bin/pairs_kept` is `bin_gaussians`' kept pairs, `bin/pairs_sorted` the
  keys of its sort.
- The serve path's and the ray-marched trainer's spans, and spans opened
  from many threads at once.
"""

import json
import threading
from pathlib import Path

import pytest
import torch

from gaussiangrasper_torch.core.cameras import view_matrix
from gaussiangrasper_torch.data.dataparsers.zoo import resolve_parser
from gaussiangrasper_torch.data.manager import FullImageDatamanager, SamplerConfig
from gaussiangrasper_torch.data.synthetic import clip_vectors, generate_tabletop
from gaussiangrasper_torch.engine import nerf_trainer as tnt
from gaussiangrasper_torch.engine import train_state
from gaussiangrasper_torch.engine.trainer import TrainerConfig, make_trainer
from gaussiangrasper_torch.engine.weights import ServeState
from gaussiangrasper_torch.models.efd import FeaUp
from gaussiangrasper_torch.models.model import GaussianSplatConfig
from gaussiangrasper_torch.models.nerf import NerfConfig
from gaussiangrasper_torch.ops.projection import project_gaussians
from gaussiangrasper_torch.ops.rasterize import RasterizeConfig, bin_gaussians, rasterize_projected
from gaussiangrasper_torch.scripts import query, render
from gaussiangrasper_torch.utils import profiler
from gaussiangrasper_torch.utils.profiler import PROFILER

SMALL = GaussianSplatConfig(feature_dim=8, sh_degree=1, num_downscales=0, warmup_length=30,
                            refine_every=100,
                            raster=RasterizeConfig(tile_size=16, max_gaussians_per_tile=256))
STEPS = 3
BIN_CFG = RasterizeConfig(tile_size=16, max_gaussians_per_tile=64, max_tiles_per_gaussian=6)


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    return generate_tabletop(tmp_path_factory.mktemp("tabletop") / "scene", width=32, height=24,
                             n_views=3, feature_downscale=2, seed_points=300)


def train(scene, out: Path, traced: bool):
    """STEPS trainer steps: (final state, each step's loss, the Chrome
    trace's events when traced)."""
    config = TrainerConfig(data=scene, output_dir=out, max_iterations=STEPS,
                           steps_per_save=STEPS, capacity=1024, model=SMALL)
    trainer = make_trainer(config, device="cpu")
    losses = []
    real_step = train_state.train_step

    def keep_loss(*a, **k):
        state, m = real_step(*a, **k)
        losses.append(m["loss"].clone())
        return state, m

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(train_state, "train_step", keep_loss)
        if not traced:
            return trainer.train(), losses, None
        with torch.profiler.profile(record_shapes=True) as prof:
            state = trainer.train()
    path = out / "trace.json"
    prof.export_chrome_trace(str(path))
    return state, losses, json.loads(path.read_text())["traceEvents"]


@pytest.fixture(scope="module")
def runs(scene, tmp_path_factory):
    """The steps traced and untraced, on one thread: the CPU's threaded
    gradient sums land in any order, so two threaded runs differ in the
    last bit with or without spans."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        PROFILER.reset()
        on = train(scene, tmp_path_factory.mktemp("on"), traced=True)
        totals = dict(PROFILER.totals)
        PROFILER.reset()
        off = train(scene, tmp_path_factory.mktemp("off"), traced=False)
    finally:
        torch.set_num_threads(threads)
    return on, off, totals


def leaves(tree):
    return list(tree.values()) if isinstance(tree, dict) else [tree]


def ggt_events(events):
    return [e for e in events if e.get("name", "").startswith(profiler.PREFIX)]


def test_section_off_is_the_shared_null_context(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a torch range opened with no profiler recording")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", refuse)
    PROFILER.reset()
    first = PROFILER.section("train_step", step=3)
    with first, PROFILER.section("forward") as inner:
        assert inner is None
    assert first is PROFILER.section("bin") is profiler._OFF
    PROFILER.count("bin/pairs_kept", torch.tensor(5))
    # the span sites on the main path: binning, compositing, its backward
    proj, opac = small_projection()
    bins = bin_gaussians(proj, 80, 60, BIN_CFG, opacities=opac, keep_pairs=True)
    colors = torch.rand(proj.xys.shape[0], 3, requires_grad=True)
    out = rasterize_projected(proj, colors, opac, torch.zeros(3), 80, 60, BIN_CFG, bins=bins)
    out["image"].sum().backward()
    assert not PROFILER.totals and not PROFILER.counts and not PROFILER.counters
    assert PROFILER.counter("bin/pairs_kept") == 0


def test_hand_built_profiler_times_every_section():
    p = profiler.Profiler()
    with p.section("outer"), p.section("inner"):
        pass
    p.count("n", 2)
    p.count("n", torch.tensor(3))
    assert p.counts == {"outer": 1, "outer/inner": 1} and p.counter("n") == 5
    assert p.totals["outer"] >= p.totals["outer/inner"] >= 0.0
    p.reset()
    assert not p.totals and not p.counters


def test_traced_trainer_steps_hold_the_nested_spans(runs):
    (_, _, events), _, totals = runs
    spans = ggt_events(events)
    by = {}
    for e in spans:
        by.setdefault(e["name"][len(profiler.PREFIX):], []).append(e)
    for name in ("train_step", "train_step/forward", "train_step/forward/project",
                 "train_step/forward/bin", "train_step/forward/composite",
                 "train_step/forward/efd", "train_step/backward", "train_step/stats",
                 "train_step/adam", "train_step/metrics", "data_wait", "downscale", "log"):
        assert len(by.get(name, [])) == STEPS, name
    assert len(by["loss_check"]) == 1 and len(by["save"]) == 1
    assert [e["args"]["step"] for e in by["train_step"]] == list(range(STEPS))
    # each child inside its parent, on the parent's thread
    for name, evs in by.items():
        if "/" not in name:
            continue
        parent = name.rsplit("/", 1)[0]
        for e in evs:
            assert any(p["tid"] == e["tid"] and p["ts"] <= e["ts"]
                       and e["ts"] + e["dur"] <= p["ts"] + p["dur"] for p in by[parent]), name
    # the compositor's backward (on the calling thread on the CPU) and the kernels'
    # clock: aten ops of the step fall inside its spans
    assert len(by["train_step/backward/composite_bwd"]) == STEPS
    step0 = by["train_step"][0]
    assert any(e.get("cat") == "cpu_op" and e["name"].startswith("aten::")
               and step0["ts"] <= e["ts"] <= step0["ts"] + step0["dur"] for e in events)
    assert totals["train_step"] >= totals["train_step/forward"] + totals["train_step/backward"]


def test_spans_on_and_off_give_bit_equal_steps(runs):
    (on_state, on_losses, _), (off_state, off_losses, _), _ = runs
    assert len(on_losses) == len(off_losses) == STEPS
    for a, b in zip(on_losses, off_losses):
        assert torch.equal(a, b)
    assert on_state.step == off_state.step == STEPS
    for a, b in zip(on_state.field, off_state.field):
        assert torch.equal(a, b)
    for k in on_state.fea_up:
        assert torch.equal(on_state.fea_up[k], off_state.fea_up[k])
    for g in on_state.opt:
        for a, b in zip(*(leaves(st.opt[g].mu) for st in (on_state, off_state))):
            assert torch.equal(a, b), g
    assert torch.equal(on_state.alive, off_state.alive)


def small_projection(n=500):
    """n seeded Gaussians in front of an identity OpenGL camera (world -z)
    at 80x60, some off the image: (projection, opacities)."""
    g = torch.Generator().manual_seed(0)
    means = torch.rand(n, 3, generator=g) * torch.tensor([4.0, 3.0, 4.0]) - torch.tensor(
        [2.0, 1.5, 6.0])
    scales = torch.exp(torch.rand(n, 3, generator=g) * 2.0 - 4.5)
    quats = torch.nn.functional.normalize(torch.randn(n, 4, generator=g), dim=-1)
    proj = project_gaussians(means, scales, quats, view_matrix(torch.eye(4)[:3]), 48.0, 48.0,
                             40.0, 30.0, 80, 60)
    return proj, torch.rand(n, generator=g)


def test_bin_counters_count_kept_and_sorted_pairs():
    proj, opac = small_projection()
    PROFILER.reset()
    with torch.profiler.profile():
        bins = bin_gaussians(proj, 80, 60, BIN_CFG, opacities=opac, keep_pairs=True)
        bin_gaussians(proj, 80, 60, BIN_CFG, opacities=opac, keep_pairs=True)
    kept, sorted_ = PROFILER.counter("bin/pairs_kept"), PROFILER.counter("bin/pairs_sorted")
    assert kept == 2 * int(bins.num_tiles_hit.sum()) > 0
    # some Gaussians cover more tiles than the cap, some none: kept < sorted
    assert sorted_ == 2 * 500 * 6 and kept < sorted_
    PROFILER.reset()


def test_serve_request_and_nerf_step_spans(runs, scene, tmp_path):
    (state, _, _), _, _ = runs
    fea_up = FeaUp(SMALL.feature_dim, SMALL.clip_dim)
    fea_up.load_state_dict(state.fea_up)
    served = ServeState(state.field, state.alive, fea_up, state.step)
    outputs = resolve_parser(Path(scene)).parse()
    dm = FullImageDatamanager(outputs, SamplerConfig(), seed=0, device="cpu")
    q = torch.as_tensor(clip_vectors()[1], dtype=torch.float32)
    with torch.profiler.profile() as prof:
        clip_map = render.lift(served.fea_up, render.render_view(served, dm.camera(0),
                                                                 SMALL)["feature"])
        query.relevancy_map(clip_map, q, torch.zeros(1, 512))
    names = {e.name for e in prof.events() if e.name.startswith(profiler.PREFIX)}
    assert names == {"ggt::render_view", "ggt::render_view/project", "ggt::render_view/bin",
                     "ggt::render_view/composite", "ggt::lift", "ggt::relevancy"}

    cfg = tnt.NerfTrainerConfig(
        data=scene, output_dir=tmp_path, max_iterations=2, steps_per_save=2, rays_per_batch=32,
        steps_per_log=1000, model=NerfConfig(field="nerfacto", num_coarse=8, num_fine=8,
                                             hidden=16, hash_levels=4, log2_hashmap_size=8,
                                             far=4.0))
    nerf = tnt.NerfTrainer(cfg, dm)
    nerf.setup()
    with torch.profiler.profile(record_shapes=True) as prof:
        nerf.train()
    steps = [e for e in prof.events() if e.name == "ggt::nerf_step"]
    assert len(steps) == 2
    names = {e.name for e in prof.events() if e.name.startswith(profiler.PREFIX)}
    assert names == {"ggt::nerf_step", "ggt::nerf_step/render", "ggt::nerf_step/render/hash",
                     "ggt::nerf_step/backward", "ggt::nerf_step/adam", "ggt::history"}


def test_spans_from_many_threads_keep_their_own_paths():
    """More threads than cores open spans at once: every call is counted and
    no thread's path takes another's name."""
    import os
    import sys

    p = profiler.Profiler()
    n_threads, n_calls = 2 * (os.cpu_count() or 2), 200
    seen = []

    def work(i):
        for _ in range(n_calls):
            with p.section(f"t{i}") as outer, p.section("child") as inner:
                seen.append((outer.path, inner.path))

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(i,)) for i in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert all(inner == outer + "/child" for outer, inner in seen)
    for i in range(n_threads):
        assert p.counts[f"t{i}"] == p.counts[f"t{i}/child"] == n_calls
