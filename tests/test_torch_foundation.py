"""PyTorch port vs transformers and the JAX package: SAM and CLIP's text
tower as the port's own modules, and the last small public functions.

The trained snapshots (facebook/sam-vit-base, openai/clip-vit-base-patch16)
are not here, so every model runs with seeded random weights at tiny
widths, written as a snapshot in the hub cache layout; transformers loads
that snapshot by its directory (never by hub name), the port by its hub
name through HF_HUB_CACHE, or by its directory. Tolerances:

- snapshot reader, tokenizer ids and masks, SAM's pixel_values, sizes and
  points: bit-equal (the same bytes, the same integer and float64 math);
- the text tower against `CLIPModel.get_text_features`, SAM's image
  embedding, `pred_masks` logits and `iou_scores` against `SamModel`, and
  relevancy maps: atol 1e-5, rtol 1e-4 (float32 sums in another order;
  transformers' default SDPA attention against the port's eager one);
- instance maps and thresholded masks: equal wherever no upscaled logit of
  the JAX side lies within 1e-4 of 0;
- the schedules, quat_mul, rotate_x, projection_matrix: rtol 1e-6 (float32
  against float32, or a float64 product rounded once).
"""

import contextlib
import os
import sys

# nothing here may reach the hub: every transformers load is a local directory
os.environ["HF_HUB_OFFLINE"] = "1"
os.environ["TRANSFORMERS_OFFLINE"] = "1"

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402
from safetensors.torch import load_file, save_file  # noqa: E402
from transformers import (CLIPModel, CLIPProcessor, CLIPTokenizer, CLIPTokenizerFast,  # noqa: E402
                          SamModel, SamProcessor)

from gaussiangrasper_torch.core import cameras as tcams  # noqa: E402
from gaussiangrasper_torch.core import transforms as ttf  # noqa: E402
from gaussiangrasper_torch.engine import checkpoint as tckpt  # noqa: E402
from gaussiangrasper_torch.engine import optimizers as topt  # noqa: E402
from gaussiangrasper_torch.engine.weights import state_from_numpy  # noqa: E402
from gaussiangrasper_torch.models import clip_text as tclip  # noqa: E402
from gaussiangrasper_torch.models import model as tmodel  # noqa: E402
from gaussiangrasper_torch.models import sam as tsam  # noqa: E402
from gaussiangrasper_torch.scripts import query as tquery  # noqa: E402
from gaussiangrasper_torch.scripts import segment as tseg  # noqa: E402
from gaussiangrasper_torch.utils import hub_snapshot as hs  # noqa: E402
from gaussiangrasper_torch.utils.clip_tokenizer import ClipTokenizer, synthetic_vocab  # noqa: E402
from gaussiangrasper_torch.utils.image_io import write_png  # noqa: E402
from gaussiangrasper_torch.utils.sam_processor import SamProcessor as TSamProcessor  # noqa: E402
from gaussiangrasper_tpu.core import cameras as jcams  # noqa: E402
from gaussiangrasper_tpu.core import transforms as jtf  # noqa: E402
from gaussiangrasper_tpu.engine import optimizers as jopt  # noqa: E402
from gaussiangrasper_tpu.models import model as jmodel  # noqa: E402
from gaussiangrasper_tpu.models.efd import init_mlp  # noqa: E402
from gaussiangrasper_tpu.scripts import query as jquery  # noqa: E402
from gaussiangrasper_tpu.scripts import segment as jseg  # noqa: E402
from tests.test_torch_core import close  # noqa: E402

CLIP_NAME, SAM_NAME = "openai/clip-vit-base-patch16", "facebook/sam-vit-base"
PROMPTS = ["object", "things", "stuff", "texture", "a red mug", "What's  this?! (3.14, #2)",
           "café naïve Ångström", "don't we'll it''s", " tabs\tand\nnewlines ", "12 o'clock",
           "x" * 30]
LONG = " ".join(["scissors on the tabletop"] * 40)  # past 77 tokens
NEAR_ZERO = 1e-4


def _clip_snapshot(root, eos_last: bool):
    vocab, merges = synthetic_vocab(400, seed=3)
    c = tclip.ClipTextConfig(vocab_size=len(vocab), hidden_size=32, intermediate_size=64,
                             num_hidden_layers=2, num_attention_heads=2,
                             eos_token_id=len(vocab) - 1 if eos_last else 2, projection_dim=512)
    config = tclip.config_json(c)
    config["vision_config"] = {"hidden_size": 32, "intermediate_size": 64, "num_hidden_layers": 1,
                               "num_attention_heads": 2, "image_size": 32, "patch_size": 16}
    pre = {"crop_size": 32, "do_center_crop": True, "do_normalize": True, "do_resize": True,
           "image_mean": [0.48145466, 0.4578275, 0.40821073],
           "image_std": [0.26862954, 0.26130258, 0.27577711], "resample": 3, "size": 32}
    return hs.write_snapshot(root, CLIP_NAME, {
        "config.json": config, "vocab.json": vocab, "merges.txt": merges,
        "preprocessor_config.json": pre, "model.safetensors": tclip.random_weights(c, seed=4)})


@pytest.fixture(scope="module")
def clip_snaps(tmp_path_factory):
    """{eos rule: (hub root, snapshot dir)}: 2 is the published snapshots'
    eos_token_id (pooling at the largest id), "last" the end token's id."""
    out = {}
    for rule in ("2", "last"):
        root = tmp_path_factory.mktemp(f"hub_clip_{rule}")
        out[rule] = (root, _clip_snapshot(root, rule == "last"))
    return out


SAM_CONFIG = tsam.SamConfig(
    tsam.SamVisionConfig(hidden_size=32, output_channels=16, num_hidden_layers=3,
                         num_attention_heads=2, image_size=64, window_size=3,
                         global_attn_indexes=(1,), num_pos_feats=8),
    tsam.SamPromptEncoderConfig(hidden_size=16, image_size=64, mask_input_channels=8),
    tsam.SamMaskDecoderConfig(hidden_size=16, mlp_dim=32, num_attention_heads=2,
                              iou_head_hidden_dim=16))


@pytest.fixture(scope="module")
def sam_snap(tmp_path_factory):
    """(hub root, snapshot dir) of a SAM at 64x64 input (a 4x4 embedding
    grid: windows of 3 with padding, one global block)."""
    root = tmp_path_factory.mktemp("hub_sam")
    pre = {"do_normalize": True, "do_pad": True, "do_rescale": True, "do_resize": True,
           "image_mean": [0.485, 0.456, 0.406], "image_std": [0.229, 0.224, 0.225],
           "image_processor_type": "SamImageProcessor", "pad_size": {"height": 64, "width": 64},
           "processor_class": "SamProcessor", "resample": 2,
           "rescale_factor": 0.00392156862745098, "size": {"longest_edge": 64}}
    snap = hs.write_snapshot(root, SAM_NAME, {
        "config.json": SAM_CONFIG.to_dict(), "preprocessor_config.json": pre,
        "model.safetensors": tsam.random_weights(SAM_CONFIG, seed=5)})
    return root, snap


@pytest.fixture(scope="module")
def hf_sam(sam_snap):
    snap = sam_snap[1]
    return SamModel.from_pretrained(snap).eval(), SamProcessor.from_pretrained(snap)


def _hub_env(monkeypatch, root, home):
    """Point the hub search at `root` only (HF_HOME unset, HOME a fresh dir)."""
    monkeypatch.setenv("HF_HUB_CACHE", str(root))
    monkeypatch.delenv("HF_HOME", raising=False)
    monkeypatch.setenv("HOME", str(home))


@contextlib.contextmanager
def _without_hf(monkeypatch):
    """Importing transformers or safetensors fails inside (as on the card
    machine, which has neither)."""
    with monkeypatch.context() as m:
        for name in ("transformers", "safetensors"):
            m.setitem(sys.modules, name, None)
        yield


def _image(seed, h=75, w=96):
    """A seeded frame: smooth colour fields and a few flat discs."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    img = np.stack([127 + 100 * np.sin(xx / (7 + 3 * c) + yy / (11 - 2 * c) + c)
                    for c in range(3)], -1)
    for _ in range(4):
        cy, cx, r = rng.uniform(0, h), rng.uniform(0, w), rng.uniform(6, 18)
        img[(yy - cy) ** 2 + (xx - cx) ** 2 < r * r] = rng.integers(0, 256, 3)
    return img.astype(np.uint8)


# --- the snapshot reader ------------------------------------------------------------


def _tensors():
    g = torch.Generator().manual_seed(0)
    return {"a.f32": torch.randn(3, 4, generator=g), "b.f16": torch.randn(5, generator=g).half(),
            "c.bf16": torch.randn(2, 3, generator=g).bfloat16(),
            "d.f64": torch.randn(2, 2, generator=g).double(),
            "e.i64": torch.randint(-9, 9, (4,), generator=g),
            "f.i32": torch.randint(-9, 9, (2, 2), generator=g).int(),
            "g.u8": torch.randint(0, 255, (7,), generator=g).to(torch.uint8),
            "h.bool": torch.rand(6, generator=g) > 0.5, "i.empty": torch.zeros(0, 3),
            "j.scalar": torch.tensor(2.5)}


@pytest.mark.parametrize("layout", ["safetensors", "torch_bin"])
def test_snapshot_weights_match_safetensors_and_torch_save(tmp_path, layout):
    want = _tensors()
    if layout == "safetensors":
        save_file(want, str(tmp_path / hs.SAFETENSORS), metadata={"format": "pt"})
        # the port's writer, read back by the library
        hs.write_safetensors(tmp_path / "port.safetensors", want)
        back = load_file(str(tmp_path / "port.safetensors"))
        assert set(back) == set(want)
        for k in want:
            assert back[k].dtype == want[k].dtype and torch.equal(back[k], want[k]), k
    else:
        torch.save(want, tmp_path / hs.TORCH_BIN)
    got = hs.load_weights(tmp_path)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        assert torch.equal(got[k], want[k]), k
    kept = hs.load_weights(tmp_path, lambda k: k.startswith("a.") or k.startswith("h."))
    assert set(kept) == {"a.f32", "h.bool"}


def test_snapshot_search_order_and_missing_paths(tmp_path, monkeypatch):
    roots = {name: tmp_path / name / "hub" for name in ("cache", "home", "user")}
    for i, (name, root) in enumerate(roots.items()):
        hs.write_snapshot(root if name != "user" else tmp_path / "user" / ".cache" / "huggingface"
                          / "hub", "org/model", {"config.json": {"which": name}}, commit=str(i) * 40)
    monkeypatch.setenv("HF_HUB_CACHE", str(roots["cache"]))
    monkeypatch.setenv("HF_HOME", str(tmp_path / "home"))
    monkeypatch.setenv("HOME", str(tmp_path / "user"))
    assert hs.read_config(hs.snapshot_dir("org/model"))["which"] == "cache"
    monkeypatch.delenv("HF_HUB_CACHE")
    assert hs.read_config(hs.snapshot_dir("org/model"))["which"] == "home"
    monkeypatch.delenv("HF_HOME")
    snap = hs.snapshot_dir("org/model")
    assert hs.read_config(snap)["which"] == "user" and snap.name == "2" * 40
    assert hs.snapshot_dir(str(snap)) == snap  # a directory is its own snapshot
    monkeypatch.setenv("HF_HUB_CACHE", str(tmp_path / "empty"))
    monkeypatch.setenv("HF_HOME", str(tmp_path / "none"))
    with pytest.raises(hs.SnapshotNotFound) as e:
        hs.snapshot_dir("org/other")
    want = [tmp_path / "empty", tmp_path / "none" / "hub",
            tmp_path / "user" / ".cache" / "huggingface" / "hub"]
    assert str(e.value) == "no snapshot of org/other at " + ", ".join(
        str(r / "models--org--other" / "refs" / "main") for r in want)


# --- the tokenizer and the text tower -------------------------------------------------


@pytest.mark.parametrize("kind", ["fast", "python"])
def test_tokenizer_matches_transformers(clip_snaps, kind):
    snap = clip_snaps["2"][1]
    cls = CLIPTokenizerFast if kind == "fast" else CLIPTokenizer
    ref = cls.from_pretrained(snap)
    if kind == "fast":  # the tokenizer the JAX call's CLIPProcessor builds
        assert isinstance(CLIPProcessor.from_pretrained(snap).tokenizer, CLIPTokenizerFast)
    tok = ClipTokenizer(snap)
    want = ref(PROMPTS, padding=True, return_tensors="pt")
    ids, mask = tok(PROMPTS)
    assert torch.equal(ids, want["input_ids"]) and torch.equal(mask, want["attention_mask"])
    assert int(mask.sum(1).max()) > 12  # the synthetic merges leave long prompts
    assert len(tok.encode(LONG)) > 77
    want = ref([LONG, "a red mug"], padding=True, truncation=True, max_length=77,
               return_tensors="pt")
    ids, mask = tok([LONG, "a red mug"], max_length=77)
    assert ids.shape == (2, 77)
    assert torch.equal(ids, want["input_ids"]) and torch.equal(mask, want["attention_mask"])


@pytest.mark.parametrize("eos", ["2", "last"])
def test_text_tower_matches_get_text_features(clip_snaps, eos):
    snap = clip_snaps[eos][1]
    model = CLIPModel.from_pretrained(snap).eval()
    proc = CLIPProcessor.from_pretrained(snap)
    with torch.no_grad():
        want = model.get_text_features(**proc(text=PROMPTS, return_tensors="pt", padding=True))
    enc = tclip.ClipTextEncoder(snap, "cpu")
    assert enc.config.eos_token_id == model.config.text_config.eos_token_id
    got = enc(PROMPTS)
    assert got.shape == (len(PROMPTS), 512)
    close(got, want, atol=1e-5, rtol=1e-4)
    assert float((want[0] - want[1]).abs().max()) > 1e-3  # the prompts differ


def test_encode_text_and_relevancy_match_jax(clip_snaps, tmp_path, monkeypatch):
    root, snap = clip_snaps["2"]
    model, proc = CLIPModel.from_pretrained(snap).eval(), CLIPProcessor.from_pretrained(snap)
    prompts = ["a red mug", "scissors"]
    want_q = jquery.encode_text(prompts, model=model, proc=proc)
    want_c = jquery.encode_text(list(tquery.CANONICAL_PHRASES), model=model, proc=proc)
    _hub_env(monkeypatch, root, tmp_path)
    got_q = tquery.encode_text(prompts, "cpu")
    enc = tclip.ClipTextEncoder.from_name(tquery.CLIP_MODEL, "cpu")
    got_c = tquery.encode_text(tquery.CANONICAL_PHRASES, encoder=enc)
    close(got_q, want_q, atol=1e-5, rtol=1e-4)
    close(got_c, want_c, atol=1e-5, rtol=1e-4)
    rng = np.random.default_rng(0)
    clip_map = rng.normal(size=(8, 6, 512)).astype(np.float32)
    for qi in range(2):
        want = jquery.relevancy_map(jnp.asarray(clip_map), jnp.asarray(want_q[qi]),
                                    jnp.asarray(want_c))
        got = tquery.relevancy_map(torch.as_tensor(clip_map), torch.as_tensor(got_q[qi]),
                                   torch.as_tensor(got_c))
        close(got, want, atol=1e-5, rtol=1e-4)
        assert float(got.min()) >= 0.0 and float(got.max()) <= 1.0


def _field_arrays(n, f, seed=1):
    """Numpy leaves of n alive Gaussians with f features in front of an
    identity camera."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    sh = np.zeros((n, 25, 3), f32)
    sh[:, 0] = rng.uniform(-1.5, 1.5, (n, 3))
    sh[:, 1:] = 0.2 * rng.normal(size=(n, 24, 3))
    return {"means": np.concatenate([rng.uniform(-1, 1, (n, 2)), rng.uniform(-4, -2, (n, 1))],
                                    1).astype(f32),
            "log_scales": rng.uniform(-3.5, -2.5, (n, 3)).astype(f32),
            "quats": rng.normal(size=(n, 4)).astype(f32),
            "opacity_logits": rng.normal(size=n).astype(f32), "sh_coeffs": sh,
            "features": rng.uniform(-1, 1, (n, f)).astype(f32)}


def _serving_run(run_dir):
    """A port serving run: a seeded 32-feature field, two views."""
    n, w, h = 200, 48, 32
    f32 = np.float32
    field = _field_arrays(n, 32)
    fea_up = {k: np.asarray(v) for k, v in init_mlp(jax.random.PRNGKey(1), 32, 512, (64,)).items()}
    state = state_from_numpy(field, np.ones(n, bool), fea_up, 4000)
    cfg = tmodel.GaussianSplatConfig(feature_dim=32)
    tckpt.save_run(run_dir, state, cfg, experiment_name="tiny")
    c2w = np.stack([np.eye(4, dtype=f32)[:3]] * 2)
    c2w[1, 0, 3] = 0.2
    tckpt.save_cameras(run_dir, [40.0] * 2, [40.0] * 2, [w / 2] * 2, [h / 2] * 2, c2w, w, h)


def test_query_cli_text_matches_jax_encoding(clip_snaps, tmp_path, monkeypatch):
    """`--text` on the card's default path (here --device cpu, transformers
    and safetensors unimportable) against the same CLI fed the JAX
    package's encodings of the prompt and of the canonical phrases; without
    a snapshot --text exits naming the paths."""
    root, snap = clip_snaps["2"]
    run = tmp_path / "run"
    _serving_run(run)
    model, proc = CLIPModel.from_pretrained(snap).eval(), CLIPProcessor.from_pretrained(snap)
    np.save(tmp_path / "q.npy", jquery.encode_text(["a red mug"], model=model, proc=proc))
    np.save(tmp_path / "c.npy", jquery.encode_text(["object", "things", "stuff", "texture"],
                                                   model=model, proc=proc))
    _hub_env(monkeypatch, root, tmp_path)
    with _without_hf(monkeypatch):
        tquery.main(["--run-dir", str(run), "--text", "a red mug", "--views", "0", "1",
                     "--device", "cpu", "--output", str(tmp_path / "text")])
    tquery.main(["--run-dir", str(run), "--text-embedding", str(tmp_path / "q.npy"),
                 "--canonical-embedding", str(tmp_path / "c.npy"), "--views", "0", "1",
                 "--device", "cpu", "--output", str(tmp_path / "emb")])
    for v in (0, 1):
        got = np.load(tmp_path / "text" / f"view{v:04d}_q0.npy")
        close(got, np.load(tmp_path / "emb" / f"view{v:04d}_q0.npy"), atol=1e-5, rtol=1e-4)
        assert got.shape == (32, 48) and 0.0 <= got.min() and got.max() <= 1.0
    _hub_env(monkeypatch, tmp_path / "empty", tmp_path / "home")
    with pytest.raises(SystemExit) as e:
        tquery.main(["--run-dir", str(run), "--text", "mug", "--device", "cpu"])
    for path in hs.cache_roots():
        assert str(hs.repo_dir(path, CLIP_NAME) / "refs" / "main") in str(e.value)


# --- SAM ---------------------------------------------------------------------------------


def _grid_points(h, w):
    gy, gx = np.mgrid[0:h:max(h // 8, 1), 0:w:max(w // 8, 1)]
    return [[int(x), int(y)] for y, x in zip(gy.ravel(), gx.ravel())]


def test_sam_matches_transformers(sam_snap, hf_sam):
    hm, hp = hf_sam
    img = _image(0)
    points = _grid_points(*img.shape[:2])
    want_in = hp(img, input_points=[[[p] for p in points]], return_tensors="pt")
    with torch.no_grad():
        want = hm(**want_in)
        want_emb = hm.get_image_embeddings(want_in["pixel_values"])
    model, snap = tsam.load(str(sam_snap[1]), "cpu")
    proc = TSamProcessor.from_snapshot(snap)
    got_in = proc(img, points, "cpu")
    for k in ("pixel_values", "original_sizes", "reshaped_input_sizes", "input_points"):
        assert got_in[k].dtype == want_in[k].dtype and torch.equal(got_in[k], want_in[k]), k
    with torch.no_grad():
        emb = model.image_embeddings(got_in["pixel_values"])
        masks, iou = model.decode(emb, got_in["input_points"])
    assert emb.shape == (1, 16, 4, 4) and masks.shape == (1, len(points), 3, 16, 16)
    close(emb, want_emb, atol=1e-5, rtol=1e-4)
    close(masks, want.pred_masks, atol=1e-5, rtol=1e-4)
    close(iou, want.iou_scores, atol=1e-5, rtol=1e-4)
    logits = hp.image_processor.post_process_masks(
        want.pred_masks, want_in["original_sizes"], want_in["reshaped_input_sizes"],
        binarize=False)[0]
    got = proc.post_process_masks(masks, got_in["original_sizes"], got_in["reshaped_input_sizes"])[0]
    assert got.shape == logits.shape == (len(points), 3, 75, 96)
    differ = got != (logits > 0)
    assert not differ[logits.abs() >= NEAR_ZERO].any()
    assert 0.1 < float(got.float().mean()) < 0.9


def _near_zero_pixels(hf_sam, img):
    """Pixels where any point's first upscaled logit (the JAX side's) lies
    within NEAR_ZERO of 0."""
    hm, hp = hf_sam
    inp = hp(img, input_points=[[[p] for p in _grid_points(*img.shape[:2])]], return_tensors="pt")
    with torch.no_grad():
        pred = hm(**inp).pred_masks
    logits = hp.image_processor.post_process_masks(pred, inp["original_sizes"],
                                                   inp["reshaped_input_sizes"], binarize=False)[0]
    return (logits[:, 0].abs() < NEAR_ZERO).any(0).numpy()


def test_sam_instance_masks_match_jax(sam_snap, hf_sam):
    hm, hp = hf_sam
    model, proc = tseg.load_sam(str(sam_snap[1]), "cpu")
    for seed in (0, 1):
        img = _image(seed)
        want = jseg.sam_instance_masks(img, "unused", 40, model=hm, proc=hp)
        got = tseg.sam_instance_masks(img, "unused", 40, model, proc, device="cpu")
        assert got.dtype == np.int32 and got.shape == img.shape[:2]
        differ = got != want
        assert not (differ & ~_near_zero_pixels(hf_sam, img)).any()
        assert len(np.unique(want)) > 2


def test_segment_cli_sam_on_the_hub_snapshot(sam_snap, hf_sam, tmp_path, monkeypatch):
    """`segment --backend sam --device cpu` (transformers and safetensors
    unimportable) finds the snapshot by hub name and writes the JAX glue's
    instance maps; without one it exits naming every path searched."""
    hm, hp = hf_sam
    root = sam_snap[0]
    data = tmp_path / "scene"
    (data / "images").mkdir(parents=True)
    frames = [_image(2), _image(3, 64, 80)]
    for i, f in enumerate(frames):
        write_png(data / "images" / f"{i:05d}.png", f)
    _hub_env(monkeypatch, root, tmp_path)
    with _without_hf(monkeypatch):
        tseg.main(["--data", str(data), "--backend", "sam", "--min-area", "40", "--device", "cpu"])
    for i, f in enumerate(frames):
        got = np.load(data / "masks" / f"{i:05d}.npy")
        want = jseg.sam_instance_masks(f, "unused", 40, model=hm, proc=hp)
        assert not ((got != want) & ~_near_zero_pixels(hf_sam, f)).any()
        np.testing.assert_array_equal(np.load(data / "boundary_mask" / f"{i:05d}.npy"),
                                      np.ones(f.shape[:2], np.uint8))
    _hub_env(monkeypatch, tmp_path / "empty", tmp_path / "home")
    with pytest.raises(SystemExit) as e:
        tseg.main(["--data", str(data), "--backend", "sam", "--device", "cpu"])
    paths = [str(hs.repo_dir(r, SAM_NAME) / "refs" / "main") for r in hs.cache_roots()]
    assert str(e.value) == (f"SAM backend unavailable (SnapshotNotFound: no snapshot of "
                            f"{SAM_NAME} at {', '.join(paths)}); use --backend classic or "
                            "pre-cache the weights")


# --- the rest of the function-level gap ----------------------------------------------


def _lr_cases():
    steps = (0, 1, 40, 99, 100, 101, 500, 2999, 3000, 10_000, 499_999, 500_000, 800_000, 950_000)
    yield "exponential_decay_lr", [dict(lr_init=1e-2, lr_final=1e-4, max_steps=3000),
                                   dict(lr_init=1e-2, lr_final=1e-4, max_steps=3000,
                                        warmup_steps=100),
                                   dict(lr_init=5e-3, lr_final=5e-5, max_steps=3000,
                                        warmup_steps=100, ramp="linear")], steps
    yield "multistep_lr", [dict(lr_init=1e-2), dict(lr_init=3e-4, milestones=(40, 500),
                                                    gamma=0.5)], steps
    yield "cosine_decay_lr", [dict(lr_init=1e-2, max_steps=3000),
                              dict(lr_init=1e-2, max_steps=3000, warmup_steps=100,
                                   lr_final=1e-4)], steps


GAP = ["exponential_decay_lr", "multistep_lr", "cosine_decay_lr", "quat_mul", "rotate_x",
       "CameraType", "projection_matrix", "GaussianSplatModel"]


@pytest.mark.parametrize("name", GAP)
def test_function_gap_matches_jax(name):
    lrs = {n: (kws, steps) for n, kws, steps in _lr_cases()}
    if name in lrs:
        kws, steps = lrs[name]
        for kw in kws:
            for s in steps:
                got = getattr(topt, name)(s, **kw)
                want = getattr(jopt, name)(s, **kw)
                assert got.dtype == torch.float32 and got.shape == ()
                close(got, want, atol=0, rtol=1e-6, msg=f"{kw} {s}")
    elif name == "quat_mul":
        rng = np.random.default_rng(0)
        a, b = rng.normal(size=(5, 4)).astype(np.float32), rng.normal(size=(5, 4)).astype(np.float32)
        close(ttf.quat_mul(torch.as_tensor(a), torch.as_tensor(b)), jtf.quat_mul(a, b),
              atol=0, rtol=1e-6)
        close(ttf.quat_mul(torch.as_tensor(a[0]), torch.as_tensor(b)), jtf.quat_mul(a[0], b),
              atol=0, rtol=1e-6)
    elif name == "rotate_x":
        for theta in (0.0, 0.3, -1.2, np.pi / 2, 3.0):
            close(ttf.rotate_x(theta), jtf.rotate_x(theta), atol=1e-7, rtol=1e-6)
    elif name == "CameraType":
        assert [(m.name, m.value) for m in tcams.CameraType] == \
            [(m.name, m.value) for m in jcams.CameraType]
    elif name == "projection_matrix":
        for args in ((0.01, 100.0, 1.2, 0.9), (0.1, 10.0, np.pi / 2, np.pi / 3)):
            got = tcams.projection_matrix(*args)
            assert got.dtype == torch.float32
            close(got, jcams.projection_matrix(*args), atol=1e-7, rtol=1e-6)
    else:
        from gaussiangrasper_torch.models.efd import params_from_numpy
        from gaussiangrasper_torch.models.gaussian_field import FIELD_KEYS, GaussianParams
        from gaussiangrasper_tpu.models.gaussian_field import GaussianParams as JParams

        field = _field_arrays(120, 8)
        alive = np.arange(120) < 110
        raster = dict(tile_size=16, max_gaussians_per_tile=256)
        jcfg = jmodel.GaussianSplatConfig(raster=jmodel.RasterizeConfig(**raster), feature_dim=8)
        tcfg = tmodel.GaussianSplatConfig(raster=tmodel.RasterizeConfig(**raster), feature_dim=8)
        c2w = np.eye(4, dtype=np.float32)[:3]
        jcam = jcams.Camera.create(40.0, 40.0, 24.0, 16.0, c2w, 48, 32)
        tcam = tcams.Camera.create(40.0, 40.0, 24.0, 16.0, c2w, 48, 32)
        tfield = GaussianParams(*(torch.as_tensor(field[k]) for k in FIELD_KEYS))
        jm, tm = jmodel.GaussianSplatModel(jcfg), tmodel.GaussianSplatModel(tcfg)
        assert tm.config is tcfg
        want = jax.jit(lambda f: jm.render(f, jnp.asarray(alive), jcam, 9))(
            JParams(**{k: jnp.asarray(v) for k, v in field.items()}))
        got = tm.render(tfield, torch.as_tensor(alive), tcam, 9)
        direct = tmodel.render(tfield, torch.as_tensor(alive), tcam, 9, tcfg)
        for k in ("rgb", "feature", "depth", "normal", "alpha"):
            assert torch.equal(got[k], direct[k]), k
            close(got[k], want[k], atol=1e-5, rtol=1e-4, msg=k)
        assert float(want["alpha"].max()) > 0.5
        # the namespace's train_loss is the port's train_loss, which
        # tests/test_torch_train.py holds against the JAX one
        rng = np.random.default_rng(2)
        batch = {"image": rng.random((32, 48, 3), np.float32),
                 "depth": rng.uniform(2, 4, (32, 48)).astype(np.float32),
                 "normal": rng.normal(size=(32, 48, 3)).astype(np.float32),
                 "valid_mask": rng.random((32, 48)) > 0.2,
                 "pair_a": rng.integers(0, 32, (4, 8, 2)).astype(np.int32),
                 "pair_b": rng.integers(0, 32, (4, 8, 2)).astype(np.int32),
                 "pair_valid": np.ones((4, 8), bool), "group_valid": np.ones(4, bool),
                 "points": rng.integers(0, 32, (16, 2)).astype(np.int32),
                 "point_valid": np.ones(16, bool),
                 "gt_clip": rng.normal(size=(16, 512)).astype(np.float32)}
        fea = {k: np.asarray(v) for k, v in init_mlp(jax.random.PRNGKey(1), 8, 512, (32,)).items()}
        args = ({"field": tfield, "fea_up": params_from_numpy(fea)}, torch.as_tensor(alive), tcam,
                {k: torch.as_tensor(v) for k, v in batch.items()}, 10)
        total, _ = tm.train_loss(*args)
        assert torch.equal(total, tmodel.train_loss(*args, tcfg)[0]) and torch.isfinite(total)
        assert set(vars(jmodel.GaussianSplatModel)) - {"__doc__"} == \
            set(vars(tmodel.GaussianSplatModel)) - {"__doc__"}
