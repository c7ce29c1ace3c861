"""CLIP's byte-level BPE tokenizer, built from a snapshot's vocab.json and
merges.txt (counterpart of the CLIPProcessor text call in the JAX
package's scripts/query.py).

`ClipTokenizer(snap)(prompts)` gives the `input_ids` / `attention_mask`
that `CLIPProcessor(text=prompts, return_tensors="pt", padding=True)` gives
for the same files:

- the text is NFC-normalised, each run of whitespace becomes one space,
  and it is lowercased;
- `<|startoftext|>` / `<|endoftext|>` in the text are their own tokens;
- the rest is pre-split by CLIP's pattern (`'s|'t|'re|'ve|'m|'ll|'d|
  \\p{L}+|\\p{N}|[^\\s\\p{L}\\p{N}]+`), walked here by Unicode category, since
  `re` has no `\\p{..}`;
- each piece's UTF-8 bytes map through GPT-2's bytes-to-unicode table, the
  last symbol takes the `</w>` word end, and the merges apply in rank order
  (the first 48894 lines after the header, as CLIPTokenizer reads them);
- `<|startoftext|>` leads and `<|endoftext|>` ends each prompt, and the
  batch is padded on the right to its longest prompt with the pad token
  (attention mask 0 there).

`max_length` (the text tower's `max_position_embeddings`) truncates a
longer prompt to its first max_length - 2 tokens between the two, as
`truncation=True, max_length=...` does; the untruncated JAX call would
stop in the text tower instead.
"""

from __future__ import annotations

import json
import re
import unicodedata
from functools import lru_cache
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

BOS, EOS = "<|startoftext|>", "<|endoftext|>"
MAX_MERGES = 49152 - 256 - 2  # CLIPTokenizer reads merges.txt lines 1 .. 48894
CONTRACTIONS = ("'s", "'t", "'re", "'ve", "'m", "'ll", "'d")


@lru_cache(maxsize=None)
def bytes_to_unicode() -> Dict[int, str]:
    """GPT-2's reversible map of the 256 byte values to printable characters."""
    bs = (list(range(ord("!"), ord("~") + 1)) + list(range(ord("¡"), ord("¬") + 1))
          + list(range(ord("®"), ord("ÿ") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, map(chr, cs)))


def _kind(ch: str) -> str:
    cat = unicodedata.category(ch)[0]
    return "L" if cat == "L" else "N" if cat == "N" else " " if ch.isspace() else "P"


def pre_split(text: str) -> List[str]:
    """CLIP's pre-tokenizer pattern, tried in its order at each position."""
    out, i, n = [], 0, len(text)
    while i < n:
        ch = text[i]
        kind = _kind(ch)
        if kind == " ":
            i += 1
            continue
        if ch == "'":
            hit = next((c for c in CONTRACTIONS if text.startswith(c, i)), None)
            if hit is not None:
                out.append(hit)
                i += len(hit)
                continue
        if kind == "N":
            out.append(ch)
            i += 1
            continue
        j = i + 1
        while j < n and _kind(text[j]) == kind:
            j += 1
        out.append(text[i:j])
        i = j
    return out


def normalize(text: str) -> str:
    """NFC, each whitespace run one space, lowercase (the fast tokenizer's
    normalizer sequence)."""
    return re.sub(r"\s+", " ", unicodedata.normalize("NFC", text)).lower()


class ClipTokenizer:
    """CLIP's BPE over a snapshot's (or any directory's) vocab.json and
    merges.txt."""

    def __init__(self, snap: Path):
        snap = Path(snap)
        self.encoder: Dict[str, int] = json.loads((snap / "vocab.json").read_text(encoding="utf-8"))
        lines = (snap / "merges.txt").read_text(encoding="utf-8").strip().split("\n")
        merges = [tuple(m.split()) for m in lines[1:MAX_MERGES + 1]]
        self.ranks: Dict[Tuple[str, str], int] = dict(zip(merges, range(len(merges))))
        self.byte_map = bytes_to_unicode()
        # CLIP's pad and unknown tokens are its end token
        self.bos, self.eos = self.encoder[BOS], self.encoder[EOS]
        self._cache: Dict[str, List[int]] = {}

    def bpe(self, piece: str) -> List[int]:
        """The ids of one pre-split piece."""
        if piece in self._cache:
            return self._cache[piece]
        chars = "".join(self.byte_map[b] for b in piece.encode("utf-8"))
        word = list(chars[:-1]) + [chars[-1] + "</w>"]
        while len(word) > 1:
            pairs = set(zip(word, word[1:]))
            best = min(pairs, key=lambda p: self.ranks.get(p, float("inf")))
            if best not in self.ranks:
                break
            merged, i = [], 0
            while i < len(word):
                if i < len(word) - 1 and (word[i], word[i + 1]) == best:
                    merged.append(word[i] + word[i + 1])
                    i += 2
                else:
                    merged.append(word[i])
                    i += 1
            word = merged
        ids = [self.encoder.get(t, self.eos) for t in word]
        self._cache[piece] = ids
        return ids

    def encode(self, text: str) -> List[int]:
        """The ids of one prompt, without the start and end tokens."""
        ids: List[int] = []
        for part, special in _split_specials(text):
            if special:
                ids.append(self.encoder[part])
            else:
                for piece in pre_split(normalize(part)):
                    ids.extend(self.bpe(piece))
        return ids

    def __call__(self, prompts: Sequence[str], max_length: Optional[int] = None):
        """(input_ids, attention_mask), int64 (B, L) on the CPU: each prompt
        between the start and end tokens, right-padded to the longest."""
        rows = []
        for text in prompts:
            ids = self.encode(text)
            if max_length is not None:
                ids = ids[:max_length - 2]
            rows.append([self.bos, *ids, self.eos])
        width = max(len(r) for r in rows)
        input_ids = torch.full((len(rows), width), self.eos, dtype=torch.int64)
        mask = torch.zeros((len(rows), width), dtype=torch.int64)
        for i, r in enumerate(rows):
            input_ids[i, :len(r)] = torch.tensor(r)
            mask[i, :len(r)] = 1
        return input_ids, mask


def _split_specials(text: str):
    """(part, is_special) in order: the start / end tokens cut out of text."""
    out = []
    while text:
        hits = [(text.find(s), s) for s in (BOS, EOS) if s in text]
        if not hits:
            out.append((text, False))
            break
        at, s = min(hits)
        if at:
            out.append((text[:at], False))
        out.append((s, True))
        text = text[at + len(s):]
    return out


def synthetic_vocab(n_merges: int, seed: int = 0) -> Tuple[dict, str]:
    """(vocab.json dict, merges.txt text) in CLIP's layout: the 256 byte
    symbols, the same with `</w>`, one token per merge, then the start and
    end tokens (n_merges 48894 gives CLIP's 49408). Merges join two earlier
    tokens drawn from a seeded generator, nine in ten from the tokens
    spelled in lowercase ASCII letters, so English prompts merge."""
    base = list(bytes_to_unicode().values())
    tokens = base + [c + "</w>" for c in base]
    seen = set(tokens)
    letters = [t for t in tokens if _lower_ascii(t)]
    rng = np.random.default_rng(seed)
    merges = []
    while len(merges) < n_merges:
        pool = letters if rng.random() < 0.9 else tokens
        a, b = pool[rng.integers(len(pool))], pool[rng.integers(len(pool))]
        if a.endswith("</w>") or a + b in seen:
            continue
        merges.append(f"{a} {b}")
        tokens.append(a + b)
        seen.add(a + b)
        if _lower_ascii(a + b):
            letters.append(a + b)
    tokens += [BOS, EOS]
    vocab = {t: i for i, t in enumerate(tokens)}
    return vocab, "#version: 0.2\n" + "\n".join(merges) + "\n"


def _lower_ascii(token: str) -> bool:
    core = token.replace("</w>", "")
    return core.isascii() and core.isalpha() and core.islower()
