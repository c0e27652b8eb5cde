"""CLIP byte-level BPE tokenizer (the port's copy of
``ldiffusion_tpu/models/tokenizer.py``).

Reads ``tokenizer/vocab.json`` and ``tokenizer/merges.txt`` of an SD
checkpoint directory; whitespace is collapsed and the text lowercased, the
pre-tokenizing regex is the JAX package's (``re``, ASCII letter and digit
classes), each word ends in ``</w>``, and ids are ``[bos, ..., eos]``,
padded to ``max_length`` with eos on request (CLIP's pad is its eos).
"""
from __future__ import annotations

import functools
import json
import os
import re
from typing import Dict, List


@functools.lru_cache()
def _bytes_to_unicode() -> Dict[int, str]:
    bs = (list(range(ord("!"), ord("~") + 1)) + list(range(ord("\xa1"), ord("\xac") + 1))
          + list(range(ord("\xae"), ord("\xff") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


_PAT = re.compile(
    r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|[a-zA-Z]+|[0-9]|[^\sa-zA-Z0-9]+""",
    re.IGNORECASE)


class CLIPTokenizer:
    def __init__(self, vocab: Dict[str, int], merges: List[str], max_length: int = 77):
        self.encoder = vocab
        self.byte_encoder = _bytes_to_unicode()
        self.bpe_ranks = {tuple(m.split()): i for i, m in enumerate(merges)}
        self.max_length = max_length
        self.bos = vocab.get("<|startoftext|>", 49406)
        self.eos = vocab.get("<|endoftext|>", 49407)
        self._cache: Dict[str, str] = {}

    @classmethod
    def from_pretrained(cls, model_dir: str, max_length: int = 77) -> "CLIPTokenizer":
        """From ``model_dir/tokenizer/`` (or ``model_dir`` itself); raises
        FileNotFoundError when ``vocab.json`` or ``merges.txt`` is missing."""
        tok_dir = os.path.join(model_dir, "tokenizer")
        if not os.path.isdir(tok_dir):
            tok_dir = model_dir
        with open(os.path.join(tok_dir, "vocab.json"), encoding="utf-8") as f:
            vocab = json.load(f)
        with open(os.path.join(tok_dir, "merges.txt"), encoding="utf-8") as f:
            lines = f.read().split("\n")
        merges = [line for line in lines if line and not line.startswith("#version")]
        return cls(vocab, merges, max_length)

    def _bpe(self, token: str) -> str:
        if token in self._cache:
            return self._cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        while len(word) > 1:
            pairs = {(word[i], word[i + 1]) for i in range(len(word) - 1)}
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, 1 << 30))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            merged: List[str] = []
            i = 0
            while i < len(word):
                if i < len(word) - 1 and word[i] == first and word[i + 1] == second:
                    merged.append(first + second)
                    i += 2
                else:
                    merged.append(word[i])
                    i += 1
            word = tuple(merged)
        out = " ".join(word)
        self._cache[token] = out
        return out

    def encode(self, text: str) -> List[int]:
        text = re.sub(r"\s+", " ", text.strip()).lower()
        ids: List[int] = []
        for token in _PAT.findall(text):
            token = "".join(self.byte_encoder[b] for b in token.encode("utf-8"))
            ids.extend(self.encoder[t] for t in self._bpe(token).split(" "))
        return ids

    def __call__(self, texts, padding: bool = False):
        """{"input_ids": [[bos, ..., eos], ...]}, truncated to ``max_length``;
        with ``padding`` each list is filled to ``max_length`` with eos."""
        if isinstance(texts, str):
            texts = [texts]
        out = []
        for t in texts:
            ids = [self.bos] + self.encode(t)[: self.max_length - 2] + [self.eos]
            if padding:
                ids = ids + [self.eos] * (self.max_length - len(ids))
            out.append(ids)
        return {"input_ids": out}
