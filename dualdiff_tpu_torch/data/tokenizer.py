"""CLIP text tokenizer: full BPE implementation + deterministic fallback.

The reference tokenizes captions with the HF ``CLIPTokenizer``
(``magicdrive/dataset/utils.py:30-57``).  We implement CLIP's byte-level BPE
in-repo (algorithm only — the vocab/merges are data files loaded from
``pretrained/.../tokenizer``); when those assets are absent (offline
environments), a deterministic hash tokenizer provides the same interface so
training/smoke tests still run end-to-end.

Static-shape note: we always pad to ``model_max_length`` (77) with the EOT
token — the standard SD inference behavior — instead of the reference's
pad-to-longest, which would produce ragged XLA shapes.
"""

from __future__ import annotations

import functools
import gzip
import hashlib
import json
import logging
import os
import re
from typing import List, Optional, Sequence

import numpy as np

log = logging.getLogger(__name__)

__all__ = ["CLIPBPETokenizer", "HashTokenizer", "build_tokenizer"]

BOS = 49406
EOS = 49407
MODEL_MAX_LENGTH = 77


@functools.lru_cache()
def _bytes_to_unicode():
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("\xa1"), ord("\xac") + 1))
        + list(range(ord("\xae"), ord("\xff") + 1))
    )
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def _basic_clean(text: str) -> str:
    return re.sub(r"\s+", " ", text.strip()).lower()


# CLIP's split pattern uses unicode classes \p{L}/\p{N} (HF CLIPTokenizer /
# openai simple_tokenizer; reference magicdrive/dataset/utils.py:30-57).
# stdlib `re` cannot express \p{..}; prefer the `regex` module for exact
# parity and fall back to the closest stdlib approximation ([^\W\d_] is the
# unicode-letter class; \d covers \p{Nd} but not the rare Nl/No chars).
try:
    import regex as _regex

    _PAT = _regex.compile(
        r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d"
        r"|[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+",
        _regex.IGNORECASE,
    )
except ImportError:  # pragma: no cover - regex is available in this env
    _PAT = re.compile(
        r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d"
        r"|[^\W\d_]+|\d|(?:[^\s\w]|_)+",
        re.IGNORECASE | re.UNICODE,
    )


class CLIPBPETokenizer:
    """Byte-level BPE with CLIP's end-of-word markers."""

    def __init__(self, vocab_path: str, merges_path: str):
        with open(vocab_path) as f:
            self.encoder = json.load(f)
        opener = gzip.open if merges_path.endswith(".gz") else open
        with opener(merges_path, "rt") as f:
            merges = f.read().split("\n")
        if merges and merges[0].startswith("#"):
            merges = merges[1:]
        merges = [tuple(m.split()) for m in merges if m]
        self.bpe_ranks = dict(zip(merges, range(len(merges))))
        self.byte_encoder = _bytes_to_unicode()
        self.cache = {}
        self.model_max_length = MODEL_MAX_LENGTH

    def _bpe(self, token: str) -> str:
        if token in self.cache:
            return self.cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        while len(word) > 1:
            pairs = {(word[i], word[i + 1]) for i in range(len(word) - 1)}
            bigram = min(
                pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word: List[str] = []
            i = 0
            while i < len(word):
                if (
                    i < len(word) - 1
                    and word[i] == first
                    and word[i + 1] == second
                ):
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
        out = " ".join(word)
        self.cache[token] = out
        return out

    def encode(self, text: str) -> List[int]:
        ids: List[int] = []
        for tok in _PAT.findall(_basic_clean(text)):
            tok = "".join(self.byte_encoder[b] for b in tok.encode("utf-8"))
            ids.extend(self.encoder[t] for t in self._bpe(tok).split(" "))
        return ids

    def __call__(self, texts, padding: str = "max_length",
                 max_length: Optional[int] = None) -> np.ndarray:
        return _batch(self, texts, max_length or self.model_max_length)


class HashTokenizer:
    """Deterministic fallback when CLIP vocab assets are unavailable.

    Same interface and special-token layout as the BPE tokenizer; word ids
    are stable hashes into the non-special vocab range, so captions map to
    repeatable token sequences (enough for offline smoke/bench runs; swap in
    real assets for production training)."""

    model_max_length = MODEL_MAX_LENGTH

    def encode(self, text: str) -> List[int]:
        ids = []
        for word in _basic_clean(text).split(" "):
            if not word:
                continue
            h = int.from_bytes(
                hashlib.sha1(word.encode()).digest()[:4], "little")
            ids.append(h % (BOS - 1000) + 500)
        return ids

    def __call__(self, texts, padding: str = "max_length",
                 max_length: Optional[int] = None) -> np.ndarray:
        return _batch(self, texts, max_length or self.model_max_length)


def _batch(tok, texts, max_length: int) -> np.ndarray:
    if isinstance(texts, str):
        texts = [texts]
    out = np.full((len(texts), max_length), EOS, np.int32)
    for i, t in enumerate(texts):
        ids = [BOS] + tok.encode(t)[: max_length - 2] + [EOS]
        out[i, : len(ids)] = ids
    return out


def build_tokenizer(pretrained_path: Optional[str] = None,
                    require_real: bool = False):
    """Prefer real CLIP BPE assets (``vocab.json`` + ``merges.txt`` under
    ``<path>/tokenizer`` or ``<path>``); fall back to the hash tokenizer.

    The fallback is LOUD: real-data training on hash tokens silently destroys
    text conditioning, so callers training on non-synthetic datasets should
    pass ``require_real=True`` (gated by cfg ``allow_fallback_assets``)."""
    for base in filter(None, [pretrained_path]):
        for sub in ("tokenizer", "."):
            vocab = os.path.join(base, sub, "vocab.json")
            merges = os.path.join(base, sub, "merges.txt")
            if os.path.exists(vocab) and os.path.exists(merges):
                return CLIPBPETokenizer(vocab, merges)
    if require_real:
        raise FileNotFoundError(
            "CLIP tokenizer assets (vocab.json + merges.txt) not found under "
            f"{pretrained_path!r}. Training on a real dataset with the hash "
            "fallback tokenizer would silently corrupt text conditioning; "
            "point model.pretrained_model_name_or_path at real SD v1.5 "
            "assets, or set allow_fallback_assets=true to proceed anyway.")
    log.warning(
        "CLIP tokenizer assets not found under %r — using the deterministic "
        "HashTokenizer fallback. Fine for synthetic smoke/bench runs; real "
        "training/eval needs real assets.", pretrained_path)
    return HashTokenizer()
