"""The work of a SAM request, counted from the configuration's widths, and
its least time on one H100 at the published peaks (`work.least_s`: f32 at
67 TFLOP/s, the configuration's precision; bytes at 3.35 TB/s).

Counted so that an implementation which skips padded rows is not credited
with work it did not need: every linear layer of the encoder over the
grid's real tokens (64 x 64 = 4,096 at 1024 / 16), windowed attention's
scores and weighted sums over the padded windows (25 windows of 14 x 14
over a grid padded to 70 x 70), global attention over the real tokens; the
decomposed relative positions (two products of each query with its row's
and column's table), the patch and neck convolutions. Elementwise work
(LayerNorm, GELU, softmax) is left out. Bytes: the encoder's weights read
once and its input and output once; for the request also the decoder's
weights, the image embedding per prompt, the upscaled logits written once.
"""

from __future__ import annotations

import math
from typing import Dict

from .work import F32, least_s


def encoder_macs(vc: dict) -> Dict[str, float]:
    """Multiply-adds of one image through the encoder, by part."""
    d, n = vc["hidden_size"], vc["image_size"] // vc["patch_size"]
    t = n * n
    ws = vc["window_size"]
    mlp = vc.get("mlp_dim") or int(d * vc.get("mlp_ratio", 4.0))
    layers = vc["num_hidden_layers"]
    n_global = sum(1 for i in vc["global_attn_indexes"] if i < layers)
    wn = math.ceil(n / ws)
    win_rows = wn * wn * ws * ws
    out = {
        "patch_embed": t * vc["num_channels"] * vc["patch_size"] ** 2 * d,
        "linears": layers * t * d * (3 * d + d + 2 * mlp),
        # q.k and the weighted sum over each window, plus the two relative-position products
        "window_attn": (layers - n_global) * win_rows * d * (2 * ws * ws + 2 * ws),
        "global_attn": n_global * t * d * (2 * t + 2 * n),
        "neck": t * d * vc["output_channels"] + t * vc["output_channels"] ** 2 * 9,
    }
    out["total"] = sum(out.values())
    return out


def encoder_params(vc: dict) -> int:
    d, n = vc["hidden_size"], vc["image_size"] // vc["patch_size"]
    mlp = vc.get("mlp_dim") or int(d * vc.get("mlp_ratio", 4.0))
    head = d // vc["num_attention_heads"]
    per = 4 * d + 3 * d * d + 3 * d + d * d + d + 2 * d * mlp + mlp + d
    rel = sum(2 * (2 * (n if i in vc["global_attn_indexes"] else vc["window_size"]) - 1) * head
              for i in range(vc["num_hidden_layers"]))
    oc = vc["output_channels"]
    return (vc["num_channels"] * vc["patch_size"] ** 2 * d + d + n * n * d
            + vc["num_hidden_layers"] * per + rel + d * oc + 9 * oc * oc + 4 * oc)


def decoder_macs(dc: dict, n: int, prompts: int) -> Dict[str, float]:
    """Multiply-adds of `prompts` single-point prompts through the mask
    decoder on an n x n embedding: per prompt, each two-way block's
    projections of the image keys (token-to-image k and v, image-to-token q
    and out), its token-side projections and MLP, the attention over the
    image, the final attention, the upscaling and the masks' products."""
    c, hw = dc["hidden_size"], n * n
    inner = c // dc["attention_downsample_rate"]
    tokens = dc["num_multimask_outputs"] + 1 + 1 + 2
    image_side = 2 * hw * c * inner + hw * c * inner + hw * inner * c + 2 * 2 * tokens * hw * inner
    token_side = 4 * tokens * c * c + 2 * tokens * c * inner + 2 * tokens * c * dc["mlp_dim"]
    final = 2 * hw * c * inner + 2 * tokens * hw * inner + tokens * c * inner
    up = hw * c * (c // 4) * 4 + 4 * hw * (c // 4) * (c // 8) * 4
    masks = (dc["num_multimask_outputs"] + 1) * (c // 8) * 16 * hw
    per = dc["num_hidden_layers"] * (image_side + token_side) + final + up + masks
    return {"per_prompt": per, "total": prompts * per}


def request_least(cfg: dict, prompts: int, view_hw) -> Dict[str, dict]:
    """Least seconds of the encoder and of a whole request (encoder,
    decoder, the first mask of each prompt upscaled to the padded input
    and to the view), each with its operations and bytes."""
    vc, dc = cfg["vision_config"], cfg["mask_decoder_config"]
    size = vc["image_size"]
    n = size // vc["patch_size"]
    enc_ops = 2.0 * encoder_macs(vc)["total"]
    enc_bytes = F32 * (encoder_params(vc) + 3 * size * size + vc["output_channels"] * n * n)
    enc = {"ops": enc_ops, "bytes": enc_bytes, "least_s": least_s(enc_ops, 0.0, enc_bytes)}
    dec_ops = 2.0 * decoder_macs(dc, n, prompts)["total"]
    h, w = view_hw
    up_px = prompts * (size * size + h * w)
    dec_bytes = F32 * (prompts * dc["hidden_size"] * n * n + 3 * prompts * 16 * n * n + up_px)
    dec = {"ops": dec_ops + 8.0 * up_px, "bytes": dec_bytes,
           "least_s": least_s(dec_ops + 8.0 * up_px, 0.0, dec_bytes)}
    return {"encoder": enc, "decoder": dec,
            "request": {"least_s": enc["least_s"] + dec["least_s"]}}
