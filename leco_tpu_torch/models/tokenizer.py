"""Pure-Python CLIP BPE tokenizer.

Counterpart of `leco_tpu/models/tokenizer.py` (numpy plus the standard
library). The vocabulary and merges come from the checkpoint's own
`tokenizer/` directory (`vocab.json` + `merges.txt`, or OpenAI's
`bpe_simple_vocab_16e6.txt.gz`), so loading works offline.

Encoding matches `tokenizer(prompts, padding="max_length", max_length=77,
truncation=True)` (train_util.py:60-70): lowercase + NFC, byte-level BPE
with '</w>' end-of-word markers, BOS + tokens[:75] + EOS, padded to 77 with
the pad token (EOS for SD1/2).

One difference from the JAX package, not visible in the ids: the
pre-tokenizer is a scanner over Unicode categories that splits text as the
JAX package's `regex` pattern does (letters `\\p{L}+`, one number `\\p{N}`,
runs of anything else but whitespace, the contractions and the two special
tokens), since the target machine has no `regex` module. The merges run in
the native engine (`leco_tpu_torch/native/`, the port's copy of the JAX
package's `bpe.cpp`, built with g++ at first use) unless
`LECO_TPU_NATIVE=0`, and in the pure-Python loop where the engine is off
or could not be built; both give the same ids.
"""

from __future__ import annotations

import functools
import gzip
import html
import json
import os
import re
import unicodedata
from typing import Optional

import numpy as np

from leco_tpu_torch import native

SPECIAL_TOKENS = ("<|startoftext|>", "<|endoftext|>")
CONTRACTIONS = ("'s", "'t", "'re", "'ve", "'m", "'ll", "'d")


@functools.lru_cache()
def _bytes_to_unicode():
    """GPT-2 byte <-> unicode table (reversible, no control chars)."""
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


def _whitespace_clean(text: str) -> str:
    return re.sub(r"\s+", " ", text).strip()


def _basic_clean(text: str) -> str:
    text = html.unescape(html.unescape(text))
    return unicodedata.normalize("NFC", text.strip())


def _kind(c: str) -> str:
    """'L' letter, 'N' number, 'S' whitespace, 'O' anything else."""
    cat = unicodedata.category(c)
    if cat[0] in "LN":
        return cat[0]
    return "S" if c.isspace() else "O"


def split_words(text: str) -> list[str]:
    """The CLIP pre-tokenizer: at each position the first of these that
    matches, as `regex.findall` takes the alternatives of
    `<|startoftext|>|<|endoftext|>|'s|'t|'re|'ve|'m|'ll|'d|[\\p{L}]+|[\\p{N}]|[^\\s\\p{L}\\p{N}]+`
    (case-insensitive); whitespace separates and is dropped."""
    words = []
    i, n = 0, len(text)
    while i < n:
        low = text[i:i + 15].lower()
        match = next((t for t in SPECIAL_TOKENS + CONTRACTIONS if low.startswith(t)), None)
        if match is not None:
            words.append(text[i:i + len(match)])
            i += len(match)
            continue
        kind = _kind(text[i])
        if kind == "S":
            i += 1
            continue
        j = i + 1
        if kind == "L":
            while j < n and _kind(text[j]) == "L":
                j += 1
        elif kind == "O":
            while j < n and _kind(text[j]) == "O":
                j += 1
        words.append(text[i:j])
        i = j
    return words


class CLIPTokenizer:
    """Byte-level BPE tokenizer with CLIP semantics."""

    def __init__(
        self,
        vocab: dict[str, int],
        merges: list[tuple[str, str]],
        model_max_length: int = 77,
        pad_token_id: Optional[int] = None,
        bos_token: str = SPECIAL_TOKENS[0],
        eos_token: str = SPECIAL_TOKENS[1],
    ):
        self.vocab = vocab
        self.decoder = {v: k for k, v in vocab.items()}
        self.bpe_ranks = {m: i for i, m in enumerate(merges)}
        self.model_max_length = model_max_length
        self.byte_encoder = _bytes_to_unicode()
        self.bos_token_id = vocab[bos_token]
        self.eos_token_id = vocab[eos_token]
        self.pad_token_id = (
            pad_token_id if pad_token_id is not None else self.eos_token_id
        )
        self._bpe_cache: dict[str, tuple[str, ...]] = {}
        self._native = None
        if native.enabled():
            lib = native.load_bpe_library()
            if lib is not None:
                self._native = native.NativeBPE(lib, vocab, merges)

    @classmethod
    def from_pretrained(
        cls, path: str, pad_token_id: Optional[int] = None
    ) -> "CLIPTokenizer":
        """Load from a directory containing vocab.json + merges.txt (a
        diffusers `tokenizer/` subfolder, or its parent, works)."""
        for sub in ("", "tokenizer"):
            d = os.path.join(path, sub) if sub else path
            if os.path.exists(os.path.join(d, "vocab.json")):
                path = d
                break
        with open(os.path.join(path, "vocab.json"), encoding="utf-8") as f:
            vocab = json.load(f)
        merges_path = os.path.join(path, "merges.txt")
        if os.path.exists(merges_path):
            with open(merges_path, encoding="utf-8") as f:
                lines = f.read().split("\n")
        else:  # OpenAI's gzip distribution
            with gzip.open(
                os.path.join(path, "bpe_simple_vocab_16e6.txt.gz"), "rt", encoding="utf-8"
            ) as f:
                lines = f.read().split("\n")
        merges = [
            tuple(line.split()) for line in lines if line and not line.startswith("#")
        ]
        merges = [m for m in merges if len(m) == 2]
        return cls(vocab, merges, pad_token_id=pad_token_id)

    def _bpe(self, token: str) -> tuple[str, ...]:
        if token in self._bpe_cache:
            return self._bpe_cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = set(zip(word[:-1], word[1:]))
        if not pairs:
            return (token + "</w>",)
        while True:
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word: list[str] = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    new_word.extend(word[i:])
                    break
                new_word.extend(word[i:j])
                i = j
                if i < len(word) - 1 and word[i + 1] == second:
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = set(zip(word[:-1], word[1:]))
        self._bpe_cache[token] = word
        return word

    def tokenize(self, text: str) -> list[int]:
        """Text -> BPE ids (no special tokens)."""
        text = _whitespace_clean(_basic_clean(text)).lower()
        ids: list[int] = []
        for token in split_words(text):
            if token in self.vocab and token.startswith("<|"):
                # the special-token literals map to their ids directly
                ids.append(self.vocab[token])
                continue
            token = "".join(self.byte_encoder[b] for b in token.encode("utf-8"))
            if self._native is not None:
                try:
                    ids.extend(self._native.encode_word(token))
                    continue
                except KeyError:
                    pass  # a piece outside the vocabulary: the Python loop raises
            ids.extend(self.vocab[piece] for piece in self._bpe(token))
        return ids

    def __call__(self, prompts: list[str] | str) -> np.ndarray:
        """Pad-to-77, truncating: [BOS] + ids[:75] + [EOS] + pad.
        Returns an int32 array (B, 77), as train_util.text_tokenize."""
        if isinstance(prompts, str):
            prompts = [prompts]
        n = self.model_max_length
        out = np.full((len(prompts), n), self.pad_token_id, dtype=np.int32)
        for row, text in enumerate(prompts):
            ids = self.tokenize(text)[: n - 2]
            seq = [self.bos_token_id] + ids + [self.eos_token_id]
            out[row, : len(seq)] = seq
        return out
