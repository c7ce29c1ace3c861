"""SAM's forward and the automatic instance-id map, plain PyTorch.

Written from Segment Anything (arXiv:2304.02643) and
`segment_anything/modeling/{image_encoder,prompt_encoder,mask_decoder,
transformer}.py` as functions of one weight dict under transformers'
`SamModel` keys and the widths of a transformers `config.json`
(`vision_config`, `prompt_encoder_config`, `mask_decoder_config`):

- encoder: a patch convolution, the absolute position table, pre-LN
  blocks (windowed attention with zero padding at the bottom and right,
  or global attention at `global_attn_indexes`), decomposed relative
  positions added into every score matrix, the MLP, and the neck;
- prompt encoder: random-Fourier point embeddings, the pad point, the
  no-mask embedding;
- mask decoder: the two-way transformer, the upscaling, the hypernetwork
  MLPs and the IoU head, the three multimask outputs;
- `instance_map`: the low-res logits bilinearly up to the padded input,
  cropped to the resized image, bilinearly to the view, thresholded at 0;
  masks in ascending order of their first IoU score, a later one
  overwriting, those of at least `min_area` pixels numbered in turn.

Departures from `segment_anything`, each to match what transformers'
`SamModel` loads and computes:
- the decoder's LayerNorms in each two-way block take eps 1e-6 (SAM: 1e-5),
  the final one 1e-5;
- the pad point's label is -1 and its embedding is `not_a_point_embed`
  (SAM: the same, by adding it to zero);
- the prompt encoder's Fourier matrix is the image-wide one (transformers
  ties them; SAM draws one matrix, so this is the same);
- preprocessing is not done here: the caller passes `pixel_values` and the
  points as the program's processor made them (Pillow's resize is not
  written twice).
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

Weights = Dict[str, torch.Tensor]


def _lin(w: Weights, name: str, x: torch.Tensor) -> torch.Tensor:
    y = x @ w[name + ".weight"].t()
    bias = w.get(name + ".bias")
    return y if bias is None else y + bias


def _norm_last(x: torch.Tensor, g: torch.Tensor, b: torch.Tensor, eps: float) -> torch.Tensor:
    mu = x.mean(-1, keepdim=True)
    var = (x - mu).square().mean(-1, keepdim=True)
    return (x - mu) / torch.sqrt(var + eps) * g + b


def _norm_channels(x: torch.Tensor, g: torch.Tensor, b: torch.Tensor, eps: float) -> torch.Tensor:
    """LayerNorm2d over the channels of (N, C, H, W)."""
    mu = x.mean(1, keepdim=True)
    var = (x - mu).square().mean(1, keepdim=True)
    return g[:, None, None] * ((x - mu) / torch.sqrt(var + eps)) + b[:, None, None]


def _ln(w: Weights, name: str, x: torch.Tensor, eps: float) -> torch.Tensor:
    return _norm_last(x, w[name + ".weight"], w[name + ".bias"], eps)


# --- the image encoder --------------------------------------------------------------


def window_partition(x: torch.Tensor, ws: int):
    """(B, H, W, C) -> (B * nw, ws, ws, C) windows and the padded size;
    zeros pad the bottom and right."""
    b, h, w_, c = x.shape
    ph, pw = (ws - h % ws) % ws, (ws - w_ % ws) % ws
    x = F.pad(x, (0, 0, 0, pw, 0, ph))
    hp, wp = h + ph, w_ + pw
    x = x.view(b, hp // ws, ws, wp // ws, ws, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, ws, ws, c), (hp, wp)


def window_unpartition(x: torch.Tensor, ws: int, padded: Tuple[int, int],
                       size: Tuple[int, int]) -> torch.Tensor:
    hp, wp = padded
    h, w_ = size
    b = x.shape[0] // ((hp // ws) * (wp // ws))
    x = x.view(b, hp // ws, wp // ws, ws, ws, -1).permute(0, 1, 3, 2, 4, 5).reshape(b, hp, wp, -1)
    return x[:, :h, :w_]


def rel_table(size: int, table: torch.Tensor) -> torch.Tensor:
    """(size, size, C): row i, column j holds the table's entry for the
    offset i - j, the table first resized linearly to 2 * size - 1 rows
    where it has another length."""
    n = 2 * size - 1
    if table.shape[0] != n:
        table = F.interpolate(table.t()[None], size=n, mode="linear")[0].t()
    i = torch.arange(size, device=table.device)
    return table[(i[:, None] - i[None, :]) + size - 1]


def attention(w: Weights, name: str, x: torch.Tensor, heads: int, rel: bool) -> torch.Tensor:
    """Multi-head attention over an (N, H, W, C) grid with the decomposed
    relative positions: score(q, k) += <q, Rh[qh - kh]> + <q, Rw[qw - kw]>."""
    n, h, w_, c = x.shape
    d = c // heads
    qkv = _lin(w, name + ".qkv", x).view(n, h * w_, 3, heads, d)
    q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))  # (N, heads, HW, d)
    s = (q / math.sqrt(d)) @ k.transpose(-1, -2)
    if rel:
        rh = rel_table(h, w[name + ".rel_pos_h"])  # (H, H, d)
        rw = rel_table(w_, w[name + ".rel_pos_w"])  # (W, W, d)
        qg = q.reshape(n, heads, h, w_, d)
        bias_h = torch.einsum("nayxd,ykd->nayxk", qg, rh)  # (N, heads, H, W, kH)
        bias_w = torch.einsum("nayxd,xkd->nayxk", qg, rw)  # (N, heads, H, W, kW)
        s = s.view(n, heads, h, w_, h, w_) + bias_h[..., :, None] + bias_w[..., None, :]
        s = s.view(n, heads, h * w_, h * w_)
    o = torch.softmax(s, dim=-1) @ v  # (N, heads, HW, d)
    o = o.transpose(1, 2).reshape(n, h, w_, c)
    return _lin(w, name + ".proj", o)


def encoder_block(w: Weights, i: int, x: torch.Tensor, vc: dict, window: int) -> torch.Tensor:
    name = f"vision_encoder.layers.{i}"
    eps = vc["layer_norm_eps"]
    rel = vc["use_rel_pos"]
    y = _ln(w, name + ".layer_norm1", x, eps)
    if window > 0:
        wins, padded = window_partition(y, window)
        y = attention(w, name + ".attn", wins, vc["num_attention_heads"], rel)
        y = window_unpartition(y, window, padded, x.shape[1:3])
    else:
        y = attention(w, name + ".attn", y, vc["num_attention_heads"], rel)
    x = x + y
    hidden = F.gelu(_lin(w, name + ".mlp.lin1", _ln(w, name + ".layer_norm2", x, eps)))
    return x + _lin(w, name + ".mlp.lin2", hidden)


def image_encoder(w: Weights, cfg: dict, pixels: torch.Tensor) -> torch.Tensor:
    """(1, 3, 1024, 1024) -> (1, 256, 64, 64)."""
    vc = cfg["vision_config"]
    p = vc["patch_size"]
    x = F.conv2d(pixels, w["vision_encoder.patch_embed.projection.weight"],
                 w["vision_encoder.patch_embed.projection.bias"], stride=p).permute(0, 2, 3, 1)
    if vc["use_abs_pos"]:
        x = x + w["vision_encoder.pos_embed"]
    for i in range(vc["num_hidden_layers"]):
        window = 0 if i in vc["global_attn_indexes"] else vc["window_size"]
        x = encoder_block(w, i, x, vc, window)
    x = x.permute(0, 3, 1, 2)
    x = F.conv2d(x, w["vision_encoder.neck.conv1.weight"])
    x = _norm_channels(x, w["vision_encoder.neck.layer_norm1.weight"],
                       w["vision_encoder.neck.layer_norm1.bias"], 1e-6)
    x = F.conv2d(x, w["vision_encoder.neck.conv2.weight"], padding=1)
    return _norm_channels(x, w["vision_encoder.neck.layer_norm2.weight"],
                          w["vision_encoder.neck.layer_norm2.bias"], 1e-6)


# --- prompts and the mask decoder -----------------------------------------------------


def fourier(w: Weights, xy01: torch.Tensor) -> torch.Tensor:
    """Random-Fourier features of points in [0, 1]^2 (x, y last)."""
    g = w["shared_image_embedding.positional_embedding"]
    proj = 2 * math.pi * ((2 * xy01 - 1) @ g)
    return torch.cat([proj.sin(), proj.cos()], dim=-1)


def prompt_tokens(w: Weights, cfg: dict, points: torch.Tensor) -> torch.Tensor:
    """(P, 2, C) sparse tokens of P foreground points (x, y) in pixels of
    the resized input: each point, then the pad point."""
    size = cfg["prompt_encoder_config"]["image_size"]
    xy = (points.to(torch.float32) + 0.5) / size
    emb = fourier(w, xy) + w["prompt_encoder.point_embed.1.weight"]
    pad = w["prompt_encoder.not_a_point_embed.weight"].expand(emb.shape[0], -1)
    return torch.stack([emb, pad], dim=1)


def image_pe(w: Weights, n: int) -> torch.Tensor:
    """(C, n, n) Fourier features of the embedding grid's cell centres."""
    dev = w["shared_image_embedding.positional_embedding"].device
    c = (torch.arange(n, dtype=torch.float32, device=dev) + 0.5) / n
    grid = torch.stack([c[None, :].expand(n, n), c[:, None].expand(n, n)], dim=-1)
    return fourier(w, grid).permute(2, 0, 1)


def dec_attention(w: Weights, name: str, q, k, v, heads: int) -> torch.Tensor:
    """(B, Nq, C), (B, Nk, C) -> (B, Nq, C), the projections narrower."""
    q, k, v = _lin(w, name + ".q_proj", q), _lin(w, name + ".k_proj", k), _lin(w, name + ".v_proj", v)
    b, nq, inner = q.shape
    d = inner // heads

    def split(t):
        return t.view(b, t.shape[1], heads, d).transpose(1, 2)

    q, k, v = split(q), split(k), split(v)
    a = torch.softmax(q @ k.transpose(-1, -2) / math.sqrt(d), dim=-1)
    return _lin(w, name + ".out_proj", (a @ v).transpose(1, 2).reshape(b, nq, inner))


def two_way(w: Weights, dc: dict, tokens, image, pe):
    """The two-way transformer on (P, T, C) tokens and (P, HW, C) image
    keys with their position embedding."""
    heads, eps = dc["num_attention_heads"], dc["layer_norm_eps"]
    queries, keys = tokens, image
    for i in range(dc["num_hidden_layers"]):
        n = f"mask_decoder.transformer.layers.{i}"
        if i == 0:
            queries = dec_attention(w, n + ".self_attn", queries, queries, queries, heads)
        else:
            q = queries + tokens
            queries = queries + dec_attention(w, n + ".self_attn", q, q, queries, heads)
        queries = _ln(w, n + ".layer_norm1", queries, eps)
        q, k = queries + tokens, keys + pe
        queries = _ln(w, n + ".layer_norm2",
                      queries + dec_attention(w, n + ".cross_attn_token_to_image", q, k, keys, heads), eps)
        hidden = F.relu(_lin(w, n + ".mlp.lin1", queries))
        queries = _ln(w, n + ".layer_norm3", queries + _lin(w, n + ".mlp.lin2", hidden), eps)
        q, k = queries + tokens, keys + pe
        keys = _ln(w, n + ".layer_norm4",
                   keys + dec_attention(w, n + ".cross_attn_image_to_token", k, q, queries, heads), eps)
    n = "mask_decoder.transformer"
    q, k = queries + tokens, keys + pe
    queries = _ln(w, n + ".layer_norm_final_attn",
                  queries + dec_attention(w, n + ".final_attn_token_to_image", q, k, keys, heads), 1e-5)
    return queries, keys


def mlp_head(w: Weights, name: str, x: torch.Tensor, depth: int) -> torch.Tensor:
    x = F.relu(_lin(w, name + ".proj_in", x))
    for j in range(depth - 2):
        x = F.relu(_lin(w, f"{name}.layers.{j}", x))
    return _lin(w, name + ".proj_out", x)


def mask_decoder(w: Weights, cfg: dict, embedding: torch.Tensor, points: torch.Tensor):
    """(logits (P, 3, 4h, 4w), iou (P, 3)) of P single-point prompts on an
    image embedding (1, C, h, w)."""
    dc = cfg["mask_decoder_config"]
    _, c, h, w_ = embedding.shape
    sparse = prompt_tokens(w, cfg, points)
    p = sparse.shape[0]
    outs = torch.cat([w["mask_decoder.iou_token.weight"], w["mask_decoder.mask_tokens.weight"]])
    tokens = torch.cat([outs[None].expand(p, -1, -1), sparse], dim=1)
    dense = w["prompt_encoder.no_mask_embed.weight"].view(1, c, 1, 1)
    image = (embedding + dense).flatten(2).transpose(1, 2).expand(p, -1, -1)
    pe = image_pe(w, h).flatten(1).t()[None].expand(p, -1, -1)
    queries, keys = two_way(w, dc, tokens, image, pe)
    n_masks = dc["num_multimask_outputs"] + 1
    src = keys.transpose(1, 2).reshape(p, c, h, w_)
    up = F.conv_transpose2d(src, w["mask_decoder.upscale_conv1.weight"],
                            w["mask_decoder.upscale_conv1.bias"], stride=2)
    up = F.gelu(_norm_channels(up, w["mask_decoder.upscale_layer_norm.weight"],
                               w["mask_decoder.upscale_layer_norm.bias"], 1e-6))
    up = F.gelu(F.conv_transpose2d(up, w["mask_decoder.upscale_conv2.weight"],
                                   w["mask_decoder.upscale_conv2.bias"], stride=2))
    hyper = torch.stack([mlp_head(w, f"mask_decoder.output_hypernetworks_mlps.{i}",
                                  queries[:, 1 + i], 3) for i in range(n_masks)], dim=1)
    _, uc, uh, uw = up.shape
    masks = (hyper @ up.reshape(p, uc, uh * uw)).view(p, n_masks, uh, uw)
    iou = mlp_head(w, "mask_decoder.iou_prediction_head", queries[:, 0], dc["iou_head_depth"])
    return masks[:, 1:], iou[:, 1:]


def forward(w: Weights, cfg: dict, pixel_values: torch.Tensor, points: torch.Tensor) -> dict:
    """The image embedding, the low-res logits and the IoU scores of one
    view: pixel_values (1, 3, S, S) and points (P, 2) as the processor
    gives them."""
    with torch.no_grad():
        emb = image_encoder(w, cfg, pixel_values)
        logits, iou = mask_decoder(w, cfg, emb, points)
    return {"embedding": emb, "logits": logits, "iou": iou}


def upscale(logits: torch.Tensor, pad: Tuple[int, int], resized: Tuple[int, int],
            size: Tuple[int, int]) -> torch.Tensor:
    """(P, h, w) low-res logits -> (P, H, W) logits on the view."""
    up = F.interpolate(logits[:, None], size=pad, mode="bilinear", align_corners=False)
    up = up[..., :resized[0], :resized[1]]
    return F.interpolate(up, size=size, mode="bilinear", align_corners=False)[:, 0]


def instance_map(view_logits: torch.Tensor, order: torch.Tensor, min_area: int) -> torch.Tensor:
    """(H, W) int32 ids: masks (logit > 0) in `order`, a later one
    overwriting, those of at least `min_area` pixels numbered in turn;
    -1 elsewhere."""
    out = torch.full(view_logits.shape[1:], -1, dtype=torch.int32, device=view_logits.device)
    n = 0
    for i in order.tolist():
        m = view_logits[i] > 0
        if int(m.sum()) >= min_area:
            out[m] = n
            n += 1
    return out
