"""SAM at ViT-H's layout (facebook/sam-vit-huge) on the port's
`segment --backend sam` path.

On the CPU, at tiny widths with ViT-H's structure (hidden 64, 4 heads, 4
blocks with global attention at 1 and 3, windows of 4 over a 10 x 10
grid, so the windows pad): the port against the benchmark's plain
reference (`portbench/reference/sam-vit-huge/sam.py`, written apart from
the port): the image embedding, the low-res logits and the IoU scores
within 1e-5 of their scale, and `sam_instance_masks`' id map on a 96 x 80
image equal to the reference's but where a mask's logit lies within 1e-5
of its scale of 0. ViT-H itself is built on the meta device from
`portbench/configs/sam-vit-huge.json` and its parameters counted against
the count from the widths; it never runs on the CPU. The spans and
counters appear under a torch.profiler and nowhere else.

On a card (`gpu`): `segment --backend sam --sam-model facebook/sam-vit-huge`
on a written snapshot of two 800 x 800 views writes the id maps that
`sam_instance_masks` gives with the same weights loaded by `sam.load_state`
(the benchmark's path). No JAX here:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_sam_vith.py -q
"""

import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from gaussiangrasper_torch.models import sam
from gaussiangrasper_torch.scripts import segment
from gaussiangrasper_torch.utils import hub_snapshot
from gaussiangrasper_torch.utils.image_io import write_png
from gaussiangrasper_torch.utils.profiler import PROFILER
from gaussiangrasper_torch.utils.sam_processor import SamProcessor

ROOT = Path(__file__).resolve().parents[1]
CONFIG = json.loads((ROOT / "portbench" / "configs" / "sam-vit-huge.json").read_text())
TINY = sam.SamConfig(
    vision=sam.SamVisionConfig(hidden_size=64, num_hidden_layers=4, num_attention_heads=4,
                               global_attn_indexes=(1, 3), window_size=4, image_size=160,
                               num_pos_feats=16, output_channels=32, mlp_dim=256),
    prompt_encoder=sam.SamPromptEncoderConfig(hidden_size=32, image_size=160),
    mask_decoder=sam.SamMaskDecoderConfig(hidden_size=32, mlp_dim=64, num_attention_heads=4,
                                          iou_head_hidden_dim=32))


def reference():
    path = ROOT / "portbench" / "reference" / "sam-vit-huge" / "sam.py"
    spec = importlib.util.spec_from_file_location("sam_vit_huge_reference", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def tiny_model(seed):
    weights = sam.random_weights(TINY, seed)
    with torch.device("meta"):
        model = sam.SamModel(TINY)
    return sam.load_state(model, dict(weights)).eval(), weights


def image(seed, h=96, w=80):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    img = np.stack([127 + 100 * np.sin(xx / (5 + 2 * c) + yy / (9 - 2 * c) + c) for c in range(3)], -1)
    for _ in range(3):
        cy, cx, r = rng.uniform(0, h), rng.uniform(0, w), rng.uniform(8, 20)
        img[(yy - cy) ** 2 + (xx - cx) ** 2 < r * r] = rng.integers(0, 256, 3)
    return img.astype(np.uint8)


def gap(got, want):
    return float((got - want).abs().max() / want.abs().max())


@pytest.mark.parametrize("seed", [0, 1])
def test_port_matches_the_plain_reference_at_tiny_widths(seed):
    ref = reference()
    model, weights = tiny_model(seed)
    proc = SamProcessor(longest_edge=160, pad_size=(160, 160))
    img = image(seed)
    h, w = img.shape[:2]
    gy, gx = np.mgrid[0:h:h // 8, 0:w:w // 8]
    inputs = proc(img, [[int(x), int(y)] for y, x in zip(gy.ravel(), gx.ravel())], "cpu")
    with torch.no_grad():
        emb = model.image_embeddings(inputs["pixel_values"])
        logits, iou = model.decode(emb, inputs["input_points"])
    want = ref.forward(weights, TINY.to_dict(), inputs["pixel_values"], inputs["input_points"][0, :, 0])
    assert logits.shape == (1, 64, 3, 40, 40)
    assert gap(emb, want["embedding"]) < 1e-5
    assert gap(logits[0], want["logits"]) < 1e-5
    assert gap(iou[0], want["iou"]) < 1e-5

    ids = torch.from_numpy(segment.sam_instance_masks(img, "", 200, model, proc, "cpu"))
    view = ref.upscale(want["logits"][:, 0], (160, 160), tuple(inputs["reshaped_input_sizes"][0].tolist()),
                       (h, w))
    ref_ids = ref.instance_map(view, torch.argsort(want["iou"][:, 0]), 200)
    near = (view.abs() < 1e-5 * view.abs().max()).any(0)
    assert ids.shape == (h, w) and int(ids.max()) >= 2
    assert int(((ids != ref_ids) & ~near).sum()) == 0


def test_vith_parameter_count_from_the_widths():
    hf = CONFIG["hf_config"]
    cfg = sam.SamConfig.from_dict(hf)
    with torch.device("meta"):
        model = sam.SamModel(cfg)
    v, p, d = hf["vision_config"], hf["prompt_encoder_config"], hf["mask_decoder_config"]
    c, m, n = v["hidden_size"], v["mlp_dim"], v["image_size"] // v["patch_size"]
    head, oc = c // v["num_attention_heads"], v["output_channels"]
    assert (c, v["num_hidden_layers"], v["num_attention_heads"], m) == (1280, 32, 16, 5120)
    assert cfg.vision.global_attn_indexes == (7, 15, 23, 31) and cfg.vision.window_size == 14
    block = 4 * c + (3 * c * c + 3 * c) + (c * c + c) + (2 * c * m + m + c)
    rel = sum(2 * (2 * (n if i in v["global_attn_indexes"] else v["window_size"]) - 1) * head
              for i in range(v["num_hidden_layers"]))
    encoder = (3 * v["patch_size"] ** 2 * c + c + n * n * c + v["num_hidden_layers"] * block + rel
               + c * oc + 9 * oc * oc + 4 * oc)
    e, k = p["hidden_size"], p["mask_input_channels"]
    prompt = (4 * 4 + 4) + (4 * k * 4 + k) + (k * e + e) + 2 * 4 + 2 * k + e + 4 * e + e
    h, inner = d["hidden_size"], d["hidden_size"] // d["attention_downsample_rate"]
    cross = 3 * (h * inner + inner) + inner * h + h
    two_way = (4 * (h * h + h) + 2 * cross + (2 * h * d["mlp_dim"] + d["mlp_dim"] + h) + 8 * h)
    decoder = (h + 4 * h + d["num_hidden_layers"] * two_way + cross + 2 * h
               + (h * h // 4 * 4 + h // 4) + (h // 4 * h // 8 * 4 + h // 8) + 2 * h // 4
               + 4 * (2 * (h * h + h) + h * h // 8 + h // 8)
               + (2 * (h * h + h) + h * 4 + 4))
    total = sum(t.numel() for t in model.parameters())
    assert sum(t.numel() for t in model.vision_encoder.parameters()) == encoder
    assert total == encoder + prompt + decoder == CONFIG["parameters"]


def test_spans_and_counters_only_under_a_profiler():
    model, _ = tiny_model(2)
    proc = SamProcessor(longest_edge=160, pad_size=(160, 160))
    img = image(2)
    PROFILER.reset()
    segment.sam_instance_masks(img, "", 200, model, proc, "cpu")
    assert not PROFILER.totals and not PROFILER.counters
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        ids = segment.sam_instance_masks(img, "", 200, model, proc, "cpu")
    counts = dict(PROFILER.counts)
    counters = {k: PROFILER.counter(k) for k in PROFILER.counters}
    PROFILER.reset()
    assert counts == {"segment/preprocess": 1, "sam/encode": 1, "sam/encode/patch_embed": 1,
                      "sam/encode/window_attn": 2, "sam/encode/global_attn": 2,
                      "sam/encode/mlp": 4, "sam/encode/neck": 1, "sam/decode": 1,
                      "segment/post": 1}
    # two windowed blocks, each over the 10 x 10 grid padded to 12 x 12
    assert counters == {"sam/window_rows": 2 * 144, "sam/prompts": 64,
                        "sam/masks_kept": int(ids.max()) + 1}
    names = {e.name for e in prof.events()}
    assert {"ggt::sam/encode/global_attn", "ggt::segment/post"} <= names


@pytest.mark.gpu
def test_vith_cli_on_the_card_matches_the_benchmark_path(tmp_path, monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cfg = sam.SamConfig.from_dict(CONFIG["hf_config"])
    weights = sam.random_weights(cfg, 2 ** 31 + 7)
    hub_snapshot.write_snapshot(tmp_path / "hub", "facebook/sam-vit-huge",
                                {"config.json": CONFIG["hf_config"], "model.safetensors": weights})
    monkeypatch.setenv("HF_HUB_CACHE", str(tmp_path / "hub"))
    data = tmp_path / "scene"
    (data / "images").mkdir(parents=True)
    views = [image(10 + v, 800, 800) for v in range(2)]
    for v, img in enumerate(views):
        write_png(data / "images" / f"r_{v:03d}.png", img)
    segment.main(["--data", str(data), "--backend", "sam", "--sam-model", "facebook/sam-vit-huge"])
    with torch.device("meta"):
        model = sam.SamModel(cfg)
    model = sam.load_state(model, weights).to("cuda").eval()
    proc = SamProcessor()
    for v, img in enumerate(views):
        want = segment.sam_instance_masks(img, "", 200, model, proc, "cuda")
        got = np.load(data / "masks" / f"r_{v:03d}.npy")
        assert want.max() >= 1
        np.testing.assert_array_equal(got, want)
