"""SAM (the Segment Anything model) as the port's own modules (counterpart
of transformers' `SamModel`, which the JAX package's scripts/segment.py
calls).

- The vision encoder: a 16x16 patch embedding and an absolute position
  embedding, pre-LN blocks with 14x14 windowed attention and decomposed
  relative positions (global attention at `global_attn_indexes`), and the
  neck (conv 1x1, LayerNorm2d, conv 3x3, LayerNorm2d) to 256 channels.
- The prompt encoder: the random-Fourier positional embedding (a loaded
  buffer, shared with the image-wide one), point and label embeddings with
  a single point padded as transformers pads it (a pad point at 0, label
  -1), and the no-mask embedding.
- The mask decoder: the two-way transformer (token self-attention,
  token-to-image and image-to-token cross-attention at half width), the
  upscaling (ConvTranspose2d, LayerNorm2d, GELU, ConvTranspose2d, GELU), the
  hypernetwork MLPs and the IoU head; with multimask output, the masks and
  scores of tokens 1..3.

Attention is transformers' eager path (matmul, softmax, matmul); the
caller runs the model under `_device.full_f32` (TF32 would round the
products to about three digits). Widths come from the snapshot's
config.json over SamConfig's defaults, and the state-dict keys are
transformers' own, so a cached `facebook/sam-vit-base` loads as it is.
"""

from __future__ import annotations

import dataclasses
import math
from pathlib import Path
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from gaussiangrasper_torch.utils import hub_snapshot

TIED_KEY = "prompt_encoder.shared_embedding.positional_embedding"
SHARED_KEY = "shared_image_embedding.positional_embedding"


@dataclasses.dataclass(frozen=True)
class SamVisionConfig:
    hidden_size: int = 768
    output_channels: int = 256
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    num_channels: int = 3
    image_size: int = 1024
    patch_size: int = 16
    hidden_act: str = "gelu"
    layer_norm_eps: float = 1e-6
    qkv_bias: bool = True
    mlp_ratio: float = 4.0
    use_abs_pos: bool = True
    use_rel_pos: bool = True
    window_size: int = 14
    global_attn_indexes: Tuple[int, ...] = (2, 5, 8, 11)
    num_pos_feats: int = 128
    mlp_dim: Optional[int] = None

    @property
    def mlp_width(self) -> int:
        return self.mlp_dim if self.mlp_dim is not None else int(self.hidden_size * self.mlp_ratio)


@dataclasses.dataclass(frozen=True)
class SamPromptEncoderConfig:
    hidden_size: int = 256
    image_size: int = 1024
    patch_size: int = 16
    mask_input_channels: int = 16
    num_point_embeddings: int = 4
    hidden_act: str = "gelu"
    layer_norm_eps: float = 1e-6

    @property
    def image_embedding_size(self) -> int:
        return self.image_size // self.patch_size


@dataclasses.dataclass(frozen=True)
class SamMaskDecoderConfig:
    hidden_size: int = 256
    hidden_act: str = "relu"
    mlp_dim: int = 2048
    num_hidden_layers: int = 2
    num_attention_heads: int = 8
    attention_downsample_rate: int = 2
    num_multimask_outputs: int = 3
    iou_head_depth: int = 3
    iou_head_hidden_dim: int = 256
    layer_norm_eps: float = 1e-6


@dataclasses.dataclass(frozen=True)
class SamConfig:
    vision: SamVisionConfig = SamVisionConfig()
    prompt_encoder: SamPromptEncoderConfig = SamPromptEncoderConfig()
    mask_decoder: SamMaskDecoderConfig = SamMaskDecoderConfig()

    @classmethod
    def from_dict(cls, config: dict) -> "SamConfig":
        def sub(kind, key):
            names = {f.name for f in dataclasses.fields(kind)}
            d = {k: v for k, v in (config.get(key) or {}).items() if k in names}
            if "global_attn_indexes" in d:
                d["global_attn_indexes"] = tuple(d["global_attn_indexes"])
            return kind(**d)

        return cls(sub(SamVisionConfig, "vision_config"),
                   sub(SamPromptEncoderConfig, "prompt_encoder_config"),
                   sub(SamMaskDecoderConfig, "mask_decoder_config"))

    def to_dict(self) -> dict:
        """A SamModel config.json (for writing a snapshot)."""
        return {"architectures": ["SamModel"], "model_type": "sam",
                "vision_config": dataclasses.asdict(self.vision),
                "prompt_encoder_config": dataclasses.asdict(self.prompt_encoder),
                "mask_decoder_config": dataclasses.asdict(self.mask_decoder)}


ACTIVATIONS = {"gelu": F.gelu, "relu": F.relu}


class LayerNorm2d(nn.LayerNorm):
    """LayerNorm over the channels of an (N, C, H, W) map."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)


class MLPBlock(nn.Module):
    def __init__(self, width: int, mlp_dim: int, act: str):
        super().__init__()
        self.lin1 = nn.Linear(width, mlp_dim)
        self.lin2 = nn.Linear(mlp_dim, width)
        self.act = ACTIVATIONS[act]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.lin2(self.act(self.lin1(x)))


# --- the vision encoder -----------------------------------------------------------


class PatchEmbeddings(nn.Module):
    def __init__(self, c: SamVisionConfig):
        super().__init__()
        self.projection = nn.Conv2d(c.num_channels, c.hidden_size, kernel_size=c.patch_size,
                                    stride=c.patch_size)

    def forward(self, pixels: torch.Tensor) -> torch.Tensor:
        return self.projection(pixels).permute(0, 2, 3, 1)


class VisionAttention(nn.Module):
    """Multi-head attention with decomposed relative positions over an
    (N, H, W, C) grid (a window, or the whole image)."""

    def __init__(self, c: SamVisionConfig, window_size: int):
        super().__init__()
        size = c.image_size // c.patch_size if window_size == 0 else window_size
        self.heads = c.num_attention_heads
        head_dim = c.hidden_size // c.num_attention_heads
        self.scale = head_dim ** -0.5
        self.qkv = nn.Linear(c.hidden_size, 3 * c.hidden_size, bias=c.qkv_bias)
        self.proj = nn.Linear(c.hidden_size, c.hidden_size)
        self.use_rel_pos = c.use_rel_pos
        if self.use_rel_pos:
            self.rel_pos_h = nn.Parameter(torch.zeros(2 * size - 1, head_dim))
            self.rel_pos_w = nn.Parameter(torch.zeros(2 * size - 1, head_dim))

    @staticmethod
    def rel_pos(q_size: int, k_size: int, table: torch.Tensor) -> torch.Tensor:
        """(q_size, k_size, C) embeddings of the query-key offsets, the table
        resized linearly to 2 * max(q, k) - 1 rows first."""
        n = int(2 * max(q_size, k_size) - 1)
        resized = F.interpolate(table.reshape(1, table.shape[0], -1).permute(0, 2, 1), size=n,
                                mode="linear").reshape(-1, n).permute(1, 0)
        dev = table.device
        q = torch.arange(q_size, device=dev)[:, None] * max(k_size / q_size, 1.0)
        k = torch.arange(k_size, device=dev)[None, :] * max(q_size / k_size, 1.0)
        return resized[((q - k) + (k_size - 1) * max(q_size / k_size, 1.0)).long()]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, _ = x.shape
        qkv = self.qkv(x).reshape(b, h * w, 3, self.heads, -1).permute(2, 0, 3, 1, 4)
        q, k, v = qkv.reshape(3, b * self.heads, h * w, -1).unbind(0)
        attn = (q * self.scale) @ k.transpose(-2, -1)
        if self.use_rel_pos:
            rh, rw = self.rel_pos(h, h, self.rel_pos_h), self.rel_pos(w, w, self.rel_pos_w)
            rq = q.reshape(b * self.heads, h, w, -1)
            rel_h = torch.einsum("bhwc,hkc->bhwk", rq, rh)
            rel_w = torch.einsum("bhwc,wkc->bhwk", rq, rw)
            attn = attn + (rel_h[:, :, :, :, None] + rel_w[:, :, :, None, :]).reshape_as(attn)
        attn = torch.softmax(attn, dtype=torch.float32, dim=-1).to(q.dtype)
        out = (attn @ v).reshape(b, self.heads, h, w, -1).permute(0, 2, 3, 1, 4).reshape(b, h, w, -1)
        return self.proj(out)


class VisionLayer(nn.Module):
    def __init__(self, c: SamVisionConfig, window_size: int):
        super().__init__()
        self.layer_norm1 = nn.LayerNorm(c.hidden_size, eps=c.layer_norm_eps)
        self.attn = VisionAttention(c, window_size)
        self.layer_norm2 = nn.LayerNorm(c.hidden_size, eps=c.layer_norm_eps)
        self.mlp = MLPBlock(c.hidden_size, c.mlp_width, c.hidden_act)
        self.window_size = window_size

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.layer_norm1(x)
        ws = self.window_size
        if ws > 0:
            b, h, w, ch = y.shape
            ph, pw = -h % ws, -w % ws
            y = F.pad(y, (0, 0, 0, pw, 0, ph))
            hp, wp = h + ph, w + pw
            y = y.reshape(b, hp // ws, ws, wp // ws, ws, ch).permute(0, 1, 3, 2, 4, 5)
            y = self.attn(y.contiguous().reshape(-1, ws, ws, ch))
            y = y.reshape(b, hp // ws, wp // ws, ws, ws, -1).permute(0, 1, 3, 2, 4, 5)
            y = y.contiguous().reshape(b, hp, wp, -1)[:, :h, :w, :].contiguous()
        else:
            y = self.attn(y)
        x = x + y
        return x + self.mlp(self.layer_norm2(x))


class VisionNeck(nn.Module):
    def __init__(self, c: SamVisionConfig):
        super().__init__()
        self.conv1 = nn.Conv2d(c.hidden_size, c.output_channels, kernel_size=1, bias=False)
        self.layer_norm1 = LayerNorm2d(c.output_channels, eps=1e-6)
        self.conv2 = nn.Conv2d(c.output_channels, c.output_channels, kernel_size=3, padding=1,
                               bias=False)
        self.layer_norm2 = LayerNorm2d(c.output_channels, eps=1e-6)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.layer_norm1(self.conv1(x.permute(0, 3, 1, 2)))
        return self.layer_norm2(self.conv2(x))


class VisionEncoder(nn.Module):
    def __init__(self, c: SamVisionConfig):
        super().__init__()
        self.patch_embed = PatchEmbeddings(c)
        n = c.image_size // c.patch_size
        self.pos_embed = nn.Parameter(torch.zeros(1, n, n, c.hidden_size)) if c.use_abs_pos else None
        self.layers = nn.ModuleList(
            VisionLayer(c, 0 if i in c.global_attn_indexes else c.window_size)
            for i in range(c.num_hidden_layers))
        self.neck = VisionNeck(c)

    def forward(self, pixels: torch.Tensor) -> torch.Tensor:
        x = self.patch_embed(pixels)
        if self.pos_embed is not None:
            x = x + self.pos_embed
        for layer in self.layers:
            x = layer(x)
        return self.neck(x)


# --- the prompt encoder -------------------------------------------------------------


class PositionalEmbedding(nn.Module):
    """Random-Fourier features of points in [0, 1]^2 (or in pixels of
    `input_shape`): sin and cos of 2 pi (2 p - 1) @ G."""

    def __init__(self, c: SamVisionConfig):
        super().__init__()
        self.register_buffer("positional_embedding",
                             (c.hidden_size // 2) * torch.randn((2, c.num_pos_feats)))

    def forward(self, coords: torch.Tensor, input_shape=None) -> torch.Tensor:
        coords = coords.clone()
        if input_shape is not None:
            coords[..., 0] = coords[..., 0] / input_shape[1]
            coords[..., 1] = coords[..., 1] / input_shape[0]
        coords = (2 * coords - 1).to(self.positional_embedding.dtype)
        coords = 2 * math.pi * (coords @ self.positional_embedding)
        return torch.cat([torch.sin(coords), torch.cos(coords)], dim=-1)


class MaskEmbedding(nn.Module):
    """The input-mask embedding's weights, held for the snapshot's keys:
    the automatic masks prompt with points only, so nothing runs it."""

    def __init__(self, c: SamPromptEncoderConfig):
        super().__init__()
        ch = c.mask_input_channels // 4
        self.conv1 = nn.Conv2d(1, ch, kernel_size=2, stride=2)
        self.conv2 = nn.Conv2d(ch, c.mask_input_channels, kernel_size=2, stride=2)
        self.conv3 = nn.Conv2d(c.mask_input_channels, c.hidden_size, kernel_size=1)
        self.layer_norm1 = LayerNorm2d(ch, eps=c.layer_norm_eps)
        self.layer_norm2 = LayerNorm2d(4 * ch, eps=c.layer_norm_eps)


class PromptEncoder(nn.Module):
    def __init__(self, c: SamPromptEncoderConfig, shared: PositionalEmbedding):
        super().__init__()
        self.shared_embedding = shared
        self.mask_embed = MaskEmbedding(c)
        self.no_mask_embed = nn.Embedding(1, c.hidden_size)
        self.image_embedding_size = c.image_embedding_size
        self.input_image_size = c.image_size
        self.point_embed = nn.ModuleList(nn.Embedding(1, c.hidden_size)
                                         for _ in range(c.num_point_embeddings))
        self.not_a_point_embed = nn.Embedding(1, c.hidden_size)

    def forward(self, points: torch.Tensor, labels: torch.Tensor):
        """(sparse (B, P, n + 1, C), dense (B, C, h, w)) of points (B, P, n, 2)
        in pixels of the resized image, labels (B, P, n); a pad point (0, 0)
        with label -1 is appended, as transformers does without boxes."""
        points = points + 0.5
        b, p = points.shape[:2]
        points = torch.cat([points, torch.zeros((b, p, 1, 2), device=points.device)], dim=2)
        labels = torch.cat([labels, -torch.ones((b, p, 1), device=labels.device)], dim=2)
        size = self.input_image_size
        emb = self.shared_embedding(points, (size, size))
        emb = torch.where(labels[..., None] == -1, self.not_a_point_embed.weight, emb)
        emb = torch.where(labels[..., None] != -10, emb, torch.zeros_like(emb))
        emb = torch.where((labels == 0)[..., None], emb + self.point_embed[0].weight[None, None], emb)
        emb = torch.where((labels == 1)[..., None], emb + self.point_embed[1].weight[None, None], emb)
        n = self.image_embedding_size
        dense = self.no_mask_embed.weight.reshape(1, -1, 1, 1).expand(b, -1, n, n)
        return emb, dense


# --- the mask decoder ---------------------------------------------------------------


class Attention(nn.Module):
    """The decoder's attention over (B, P, tokens, C), the projections
    `downsample` times narrower than C."""

    def __init__(self, c: SamMaskDecoderConfig, downsample: Optional[int] = None):
        super().__init__()
        inner = c.hidden_size // (c.attention_downsample_rate if downsample is None else downsample)
        self.heads = c.num_attention_heads
        self.scaling = (inner // c.num_attention_heads) ** -0.5
        self.q_proj = nn.Linear(c.hidden_size, inner)
        self.k_proj = nn.Linear(c.hidden_size, inner)
        self.v_proj = nn.Linear(c.hidden_size, inner)
        self.out_proj = nn.Linear(inner, c.hidden_size)

    def _heads(self, x: torch.Tensor) -> torch.Tensor:
        b, p, n, ch = x.shape
        return x.reshape(b * p, n, self.heads, ch // self.heads).transpose(1, 2)

    def forward(self, query: torch.Tensor, key: torch.Tensor, value: torch.Tensor) -> torch.Tensor:
        q, k, v = self.q_proj(query), self.k_proj(key), self.v_proj(value)
        p = q.shape[1]
        q, k, v = self._heads(q), self._heads(k), self._heads(v)
        w = torch.softmax(torch.matmul(q, k.transpose(2, 3)) * self.scaling, dim=-1,
                          dtype=torch.float32).to(q.dtype)
        out = torch.matmul(w, v).transpose(1, 2).contiguous()
        bp, n, h, ch = out.shape
        return self.out_proj(out.reshape(bp // p, p, n, h * ch))


class TwoWayBlock(nn.Module):
    def __init__(self, c: SamMaskDecoderConfig, skip_first_layer_pe: bool):
        super().__init__()
        eps = c.layer_norm_eps
        self.self_attn = Attention(c, downsample=1)
        self.layer_norm1 = nn.LayerNorm(c.hidden_size, eps=eps)
        self.cross_attn_token_to_image = Attention(c, downsample=c.attention_downsample_rate)
        self.layer_norm2 = nn.LayerNorm(c.hidden_size, eps=eps)
        self.mlp = MLPBlock(c.hidden_size, c.mlp_dim, c.hidden_act)
        self.layer_norm3 = nn.LayerNorm(c.hidden_size, eps=eps)
        self.layer_norm4 = nn.LayerNorm(c.hidden_size, eps=eps)
        self.cross_attn_image_to_token = Attention(c, downsample=c.attention_downsample_rate)
        self.skip_first_layer_pe = skip_first_layer_pe

    def forward(self, queries, keys, query_pe, key_pe):
        if self.skip_first_layer_pe:
            queries = self.self_attn(queries, queries, queries)
        else:
            q = queries + query_pe
            queries = queries + self.self_attn(q, q, queries)
        queries = self.layer_norm1(queries)
        q, k = queries + query_pe, keys + key_pe
        queries = self.layer_norm2(queries + self.cross_attn_token_to_image(q, k, keys))
        queries = self.layer_norm3(queries + self.mlp(queries))
        q, k = queries + query_pe, keys + key_pe
        keys = self.layer_norm4(keys + self.cross_attn_image_to_token(k, q, queries))
        return queries, keys


class TwoWayTransformer(nn.Module):
    def __init__(self, c: SamMaskDecoderConfig):
        super().__init__()
        self.layers = nn.ModuleList(TwoWayBlock(c, skip_first_layer_pe=(i == 0))
                                    for i in range(c.num_hidden_layers))
        self.final_attn_token_to_image = Attention(c)
        self.layer_norm_final_attn = nn.LayerNorm(c.hidden_size)

    def forward(self, point_embeddings, image_embeddings, image_pe):
        keys = image_embeddings.flatten(2).permute(0, 2, 1).unsqueeze(1)
        key_pe = image_pe.flatten(2).permute(0, 2, 1).unsqueeze(1)
        queries = point_embeddings
        for layer in self.layers:
            queries, keys = layer(queries, keys, point_embeddings, key_pe)
        q, k = queries + point_embeddings, keys + key_pe
        queries = self.layer_norm_final_attn(queries + self.final_attn_token_to_image(q, k, keys))
        return queries, keys


class FeedForward(nn.Module):
    def __init__(self, d_in: int, hidden: int, d_out: int, num_layers: int):
        super().__init__()
        self.proj_in = nn.Linear(d_in, hidden)
        self.proj_out = nn.Linear(hidden, d_out)
        self.layers = nn.ModuleList(nn.Linear(hidden, hidden) for _ in range(num_layers - 2))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.proj_in(x))
        for layer in self.layers:
            x = F.relu(layer(x))
        return self.proj_out(x)


class MaskDecoder(nn.Module):
    def __init__(self, c: SamMaskDecoderConfig):
        super().__init__()
        h = c.hidden_size
        self.num_mask_tokens = c.num_multimask_outputs + 1
        self.iou_token = nn.Embedding(1, h)
        self.mask_tokens = nn.Embedding(self.num_mask_tokens, h)
        self.transformer = TwoWayTransformer(c)
        self.upscale_conv1 = nn.ConvTranspose2d(h, h // 4, kernel_size=2, stride=2)
        self.upscale_conv2 = nn.ConvTranspose2d(h // 4, h // 8, kernel_size=2, stride=2)
        self.upscale_layer_norm = LayerNorm2d(h // 4, eps=1e-6)
        self.output_hypernetworks_mlps = nn.ModuleList(
            FeedForward(h, h, h // 8, 3) for _ in range(self.num_mask_tokens))
        self.iou_prediction_head = FeedForward(h, c.iou_head_hidden_dim, self.num_mask_tokens,
                                               c.iou_head_depth)

    def forward(self, image_embeddings, image_pe, sparse, dense):
        """(masks (B, P, 3, 4h, 4w), iou (B, P, 3)) with multimask output."""
        b, ch, h, w = image_embeddings.shape
        p = sparse.shape[1]
        tokens = torch.cat([self.iou_token.weight, self.mask_tokens.weight], dim=0)
        tokens = torch.cat((tokens.repeat(b, p, 1, 1), sparse), dim=2).to(self.iou_token.weight.dtype)
        image = (image_embeddings + dense).repeat_interleave(p, 0)
        image_pe = image_pe.repeat_interleave(p, 0)
        queries, keys = self.transformer(tokens, image, image_pe)
        iou_out = queries[:, :, 0, :]
        mask_out = queries[:, :, 1:1 + self.num_mask_tokens, :]
        up = keys.transpose(2, 3).reshape(b * p, ch, h, w)
        up = F.gelu(self.upscale_layer_norm(self.upscale_conv1(up)))
        up = F.gelu(self.upscale_conv2(up))
        hyper = torch.stack([mlp(mask_out[:, :, i, :])
                             for i, mlp in enumerate(self.output_hypernetworks_mlps)], dim=2)
        _, uc, uh, uw = up.shape
        masks = (hyper @ up.reshape(b, p, uc, uh * uw)).reshape(b, p, -1, uh, uw)
        iou = self.iou_prediction_head(iou_out)
        return masks[:, :, 1:], iou[:, :, 1:]


class SamModel(nn.Module):
    """`forward(pixel_values, input_points)` -> (pred_masks (B, P, 3, 256,
    256) logits, iou_scores (B, P, 3)), every point labelled foreground."""

    def __init__(self, c: SamConfig = SamConfig()):
        super().__init__()
        self.config = c
        self.shared_image_embedding = PositionalEmbedding(c.vision)
        self.vision_encoder = VisionEncoder(c.vision)
        self.prompt_encoder = PromptEncoder(c.prompt_encoder, self.shared_image_embedding)
        self.mask_decoder = MaskDecoder(c.mask_decoder)

    def image_positional_embeddings(self) -> torch.Tensor:
        n = self.config.prompt_encoder.image_embedding_size
        pe = self.shared_image_embedding.positional_embedding
        grid = torch.ones((n, n), device=pe.device, dtype=pe.dtype)
        y = (grid.cumsum(dim=0) - 0.5) / n
        x = (grid.cumsum(dim=1) - 0.5) / n
        return self.shared_image_embedding(torch.stack([x, y], dim=-1)).permute(2, 0, 1)[None]

    def image_embeddings(self, pixel_values: torch.Tensor) -> torch.Tensor:
        return self.vision_encoder(pixel_values)

    def decode(self, image_embeddings: torch.Tensor, input_points: torch.Tensor):
        pe = self.image_positional_embeddings().repeat(image_embeddings.shape[0], 1, 1, 1)
        labels = torch.ones_like(input_points[..., 0], dtype=torch.int)
        sparse, dense = self.prompt_encoder(input_points, labels)
        return self.mask_decoder(image_embeddings, pe, sparse, dense)

    def forward(self, pixel_values: torch.Tensor, input_points: torch.Tensor):
        return self.decode(self.image_embeddings(pixel_values), input_points)


def load_state(model: SamModel, weights: dict) -> SamModel:
    """Load transformers' keys into `model` (built on the meta device: the
    tensors are taken as they are, floats as float32), every key required;
    the prompt encoder's positional matrix is the image-wide one
    (transformers ties them and a snapshot may hold only the shared key)."""
    weights = {k: v.float() if v.is_floating_point() else v for k, v in weights.items()}
    weights[TIED_KEY] = weights.get(SHARED_KEY)
    model.load_state_dict(weights, strict=True, assign=True)
    return model


def load(name: str, device) -> Tuple[SamModel, Path]:
    """The model of a cached snapshot on `device` (eval mode) and the
    snapshot's directory; raises hub_snapshot.SnapshotNotFound."""
    snap = hub_snapshot.snapshot_dir(name)
    with torch.device("meta"):  # no initialisation: every tensor comes from the snapshot
        model = SamModel(SamConfig.from_dict(hub_snapshot.read_config(snap)))
    load_state(model, hub_snapshot.load_weights(snap))
    return model.to(device).eval(), snap


def random_weights(c: SamConfig = SamConfig(), seed: int = 0) -> dict:
    """Seeded random weights under transformers' keys (the tied key left
    out, as transformers saves them): each linear or convolution weight
    normal with std 1 / sqrt(fan-in), so activations keep unit scale through
    the blocks; LayerNorm weights 1 +- 0.1; the Fourier matrix standard
    normal, as SAM draws it; the rest (biases, position tables, tokens)
    normal 0.02."""
    g = torch.Generator().manual_seed(seed)
    with torch.device("meta"):
        model = SamModel(c)
    kinds = {f"{n}.weight": m for n, m in model.named_modules()}
    out = {}
    for k, v in model.state_dict().items():
        if k == TIED_KEY:
            continue
        noise = torch.randn(v.shape, generator=g)
        m = kinds.get(k)
        if k == SHARED_KEY:
            out[k] = noise
        elif isinstance(m, nn.LayerNorm):
            out[k] = 1.0 + 0.1 * noise
        elif isinstance(m, (nn.Linear, nn.Conv2d)):
            out[k] = noise / math.sqrt(v[0].numel())
        elif isinstance(m, nn.ConvTranspose2d):  # stride = kernel: one tap per input channel
            out[k] = noise / math.sqrt(v.shape[0])
        else:
            out[k] = 0.02 * noise
    return out
