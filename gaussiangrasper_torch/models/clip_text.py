"""CLIP's text tower and text projection (counterpart of
`CLIPModel.get_text_features`, which the JAX package's scripts/query.py
calls through transformers).

Token and position embeddings, pre-LN encoder layers (causal mask plus the
padding mask, added as transformers adds them: the dtype's lowest value
where a key is hidden), `quick_gelu` MLPs, a final LayerNorm, the pooled
state at the end token, and a bias-free projection. Pooling follows
transformers' rule: a config whose `eos_token_id` is 2 (the published
openai snapshots) takes the position of each row's largest id, any other
the first position holding `eos_token_id`. Attention is transformers' eager
path: matmul, softmax, matmul. Widths come from the snapshot's config.json
(`text_config`, overlaid by `text_config_dict` as CLIPConfig overlays it,
over CLIPTextConfig's defaults) and the state-dict keys are transformers'
own (`text_model.*`, `text_projection.weight`), so a cached
`openai/clip-vit-base-patch16` loads as it is.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from gaussiangrasper_torch.utils import hub_snapshot
from gaussiangrasper_torch.utils.clip_tokenizer import ClipTokenizer


@dataclasses.dataclass(frozen=True)
class ClipTextConfig:
    """CLIPTextConfig's fields that the tower reads, with its defaults;
    projection_dim is the CLIPConfig's (top level) one."""

    vocab_size: int = 49408
    hidden_size: int = 512
    intermediate_size: int = 2048
    num_hidden_layers: int = 12
    num_attention_heads: int = 8
    max_position_embeddings: int = 77
    hidden_act: str = "quick_gelu"
    layer_norm_eps: float = 1e-5
    eos_token_id: int = 49407
    projection_dim: int = 512

    @classmethod
    def from_clip_config(cls, config: dict) -> "ClipTextConfig":
        text = dict(config.get("text_config") or {})
        if config.get("text_config_dict") is not None:
            # CLIPConfig: the dict, over CLIPTextConfig's defaults, replaces text_config's values
            text.update(dataclasses.asdict(cls(**_known(cls, config["text_config_dict"]))))
        text["projection_dim"] = config.get("projection_dim", 512)
        return cls(**_known(cls, text))


def _known(cls, d: dict) -> dict:
    names = {f.name for f in dataclasses.fields(cls)}
    return {k: v for k, v in d.items() if k in names}


ACTIVATIONS = {
    "quick_gelu": lambda x: x * torch.sigmoid(1.702 * x),
    "gelu": F.gelu,
    "relu": F.relu,
}


class ClipAttention(nn.Module):
    def __init__(self, c: ClipTextConfig):
        super().__init__()
        self.heads = c.num_attention_heads
        self.head_dim = c.hidden_size // c.num_attention_heads
        self.scale = self.head_dim ** -0.5
        self.k_proj = nn.Linear(c.hidden_size, c.hidden_size)
        self.v_proj = nn.Linear(c.hidden_size, c.hidden_size)
        self.q_proj = nn.Linear(c.hidden_size, c.hidden_size)
        self.out_proj = nn.Linear(c.hidden_size, c.hidden_size)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        b, n, d = x.shape
        q, k, v = (p(x).view(b, n, self.heads, self.head_dim).transpose(1, 2)
                   for p in (self.q_proj, self.k_proj, self.v_proj))
        w = torch.matmul(q, k.transpose(-1, -2)) * self.scale + mask
        w = torch.softmax(w, dim=-1, dtype=torch.float32).to(q.dtype)
        out = torch.matmul(w, v).transpose(1, 2).reshape(b, n, d)
        return self.out_proj(out)


class ClipMLP(nn.Module):
    def __init__(self, c: ClipTextConfig):
        super().__init__()
        self.act = ACTIVATIONS[c.hidden_act]
        self.fc1 = nn.Linear(c.hidden_size, c.intermediate_size)
        self.fc2 = nn.Linear(c.intermediate_size, c.hidden_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(self.act(self.fc1(x)))


class ClipEncoderLayer(nn.Module):
    def __init__(self, c: ClipTextConfig):
        super().__init__()
        self.self_attn = ClipAttention(c)
        self.layer_norm1 = nn.LayerNorm(c.hidden_size, eps=c.layer_norm_eps)
        self.mlp = ClipMLP(c)
        self.layer_norm2 = nn.LayerNorm(c.hidden_size, eps=c.layer_norm_eps)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        x = x + self.self_attn(self.layer_norm1(x), mask)
        return x + self.mlp(self.layer_norm2(x))


class ClipEmbeddings(nn.Module):
    def __init__(self, c: ClipTextConfig):
        super().__init__()
        self.token_embedding = nn.Embedding(c.vocab_size, c.hidden_size)
        self.position_embedding = nn.Embedding(c.max_position_embeddings, c.hidden_size)

    def forward(self, input_ids: torch.Tensor) -> torch.Tensor:
        n = input_ids.shape[-1]
        if n > self.position_embedding.num_embeddings:
            raise ValueError(f"{n} tokens, past max_position_embeddings "
                             f"{self.position_embedding.num_embeddings}")
        pos = torch.arange(n, device=input_ids.device)
        return self.token_embedding(input_ids) + self.position_embedding(pos)[None]


class ClipEncoder(nn.Module):
    def __init__(self, c: ClipTextConfig):
        super().__init__()
        self.layers = nn.ModuleList(ClipEncoderLayer(c) for _ in range(c.num_hidden_layers))


class ClipTextTransformer(nn.Module):
    def __init__(self, c: ClipTextConfig):
        super().__init__()
        self.embeddings = ClipEmbeddings(c)
        self.encoder = ClipEncoder(c)
        self.final_layer_norm = nn.LayerNorm(c.hidden_size, eps=c.layer_norm_eps)


class ClipTextTower(nn.Module):
    """`get_text_features(input_ids, attention_mask)`: (B, projection_dim)."""

    def __init__(self, c: ClipTextConfig):
        super().__init__()
        self.config = c
        self.text_model = ClipTextTransformer(c)
        self.text_projection = nn.Linear(c.hidden_size, c.projection_dim, bias=False)

    def forward(self, input_ids: torch.Tensor, attention_mask: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        tm = self.text_model
        x = tm.embeddings(input_ids)
        b, n = input_ids.shape
        low = torch.finfo(x.dtype).min
        mask = torch.triu(torch.full((n, n), low, dtype=x.dtype, device=x.device), 1)[None, None]
        if attention_mask is not None:
            hidden = 1.0 - attention_mask.to(x.dtype)
            mask = mask + hidden.masked_fill(hidden.bool(), low)[:, None, None, :]
        for layer in tm.encoder.layers:
            x = layer(x, mask)
        x = tm.final_layer_norm(x)
        ids = input_ids.to(torch.int)
        if self.config.eos_token_id == 2:
            at = ids.argmax(dim=-1)
        else:
            at = (ids == self.config.eos_token_id).int().argmax(dim=-1)
        pooled = x[torch.arange(b, device=x.device), at]
        return self.text_projection(pooled)


def is_text_key(key: str) -> bool:
    return key.startswith("text_model.") or key == "text_projection.weight"


def load_state(tower: ClipTextTower, weights: dict) -> ClipTextTower:
    """Load transformers' keys into `tower` (built on the meta device: the
    tensors are taken as they are, as float32), the vision tower's and the
    persistent `position_ids` of older snapshots left out, every tower key
    required."""
    state = {k: v.float() for k, v in weights.items()
             if is_text_key(k) and not k.endswith("embeddings.position_ids")}
    tower.load_state_dict(state, strict=True, assign=True)
    return tower


class ClipTextEncoder:
    """A snapshot's tokenizer and text tower on one device."""

    def __init__(self, snap: Path, device):
        self.device = torch.device(device)
        self.config = ClipTextConfig.from_clip_config(hub_snapshot.read_config(snap))
        self.tokenizer = ClipTokenizer(snap)
        with torch.device("meta"):  # no initialisation: every tensor comes from the snapshot
            tower = ClipTextTower(self.config)
        load_state(tower, hub_snapshot.load_weights(snap, is_text_key))
        self.tower = tower.to(self.device).eval()

    @classmethod
    def from_name(cls, name: str, device) -> "ClipTextEncoder":
        return cls(hub_snapshot.snapshot_dir(name), device)

    def __call__(self, prompts) -> torch.Tensor:
        """(len(prompts), projection_dim) float32 features on the device."""
        from gaussiangrasper_torch._device import full_f32

        ids, mask = self.tokenizer(list(prompts), self.config.max_position_embeddings)
        with torch.no_grad(), full_f32():
            return self.tower(ids.to(self.device), mask.to(self.device))


def random_weights(c: ClipTextConfig, seed: int = 0) -> dict:
    """Seeded random weights under transformers' keys, at about
    transformers' initial scales (normal 0.02; LayerNorm weights 1 +- 0.1),
    for running the tower without a trained snapshot."""
    g = torch.Generator().manual_seed(seed)
    with torch.device("meta"):
        tower = ClipTextTower(c)
    out = {}
    for k, v in tower.state_dict().items():
        noise = torch.randn(v.shape, generator=g)
        out[k] = 1.0 + 0.1 * noise if "layer_norm" in k and k.endswith("weight") else 0.02 * noise
    return out


def config_json(c: ClipTextConfig) -> dict:
    """A CLIPModel config.json holding `c` (for writing a snapshot)."""
    text = {k: v for k, v in dataclasses.asdict(c).items() if k != "projection_dim"}
    return {"architectures": ["CLIPModel"], "model_type": "clip",
            "projection_dim": c.projection_dim, "text_config": text}
