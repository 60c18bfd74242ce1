"""CLIP's byte-pair-encoding tokenizer, without the `regex` package.

Counterpart of `cream_tpu/data/tokenizer.py` (OpenAI's SimpleTokenizer,
TinyCLIP/src/open_clip/tokenizer.py:17-133). The merges file
`bpe_simple_vocab_16e6.txt.gz` is public but not bundled: pass its path
(`bpe_path`, the CLIs' `--bpe`) or set CLIP_BPE_PATH; without it the
tokenizer raises, as the JAX package's does.

The JAX package splits words with `regex` (`\\p{L}`, `\\p{N}`); this one
splits them with `unicodedata` (`split_words`), giving the same tokens as

    <\\|startoftext\\|>|<\\|endoftext\\|>|'s|'t|'re|'ve|'m|'ll|'d|[\\p{L}]+|[\\p{N}]|[^\\s\\p{L}\\p{N}]+

under IGNORECASE: letters are the L* categories, numbers N*, whitespace
is `str.isspace()` but U+001C-U+001F (which `regex`'s `\\s` leaves out),
the contractions and special tokens match case-insensitively (`'S`, and
the long s U+017F for s, as `regex` folds it), and U+0345, which
IGNORECASE folds to a letter, starts no token. Characters assigned after
the Unicode version of Python's `unicodedata` are unknown to it and count
as punctuation. Text is cleaned as in the JAX package (html-unescaped
twice, whitespace squashed, lowercased; no ftfy).
"""
from __future__ import annotations

import collections
import functools
import gzip
import html
import os
import re
import unicodedata

import numpy as np

SPECIAL_TOKENS = ("<|startoftext|>", "<|endoftext|>")
CONTRACTIONS = ("'s", "'t", "'re", "'ve", "'m", "'ll", "'d")
# the characters `regex` matches for each letter of the contractions and
# special tokens under IGNORECASE
_CASE = {c: c + c.upper() for c in "abcdefghijklmnopqrstuvwxyz"}
_CASE["s"] += "\u017f"


@functools.lru_cache(maxsize=None)
def _kind(ch: str) -> str:
    """'L' letter, 'N' number, ' ' whitespace or no token, 'P' the rest."""
    if ch.isspace() and ch not in "\x1c\x1d\x1e\x1f" or ch == "\u0345":
        return " "
    cat = unicodedata.category(ch)[0]
    return cat if cat in "LN" else "P"


def _matches(text: str, i: int, word: str) -> bool:
    return (i + len(word) <= len(text)
            and all(text[i + j] in _CASE.get(c, c) for j, c in enumerate(word)))


def split_words(text: str) -> list[str]:
    """The tokens of the JAX package's `_WORD_RE.findall(text)`."""
    out, i, n = [], 0, len(text)
    while i < n:
        word = next((w for w in SPECIAL_TOKENS if _matches(text, i, w)), None)
        if word is None and text[i] == "'":
            word = next((w for w in CONTRACTIONS if _matches(text, i, w)), None)
        if word is not None:
            out.append(text[i:i + len(word)])
            i += len(word)
            continue
        kind = _kind(text[i])
        j = i + 1
        if kind in "LP":
            while j < n and _kind(text[j]) == kind:
                j += 1
        if kind != " ":
            out.append(text[i:j])
        i = j
    return out


def bytes_to_unicode() -> dict[int, str]:
    """Reversible byte -> printable-unicode map (GPT-2/CLIP standard)."""
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(ord("\xa1"), ord("\xac") + 1))
          + list(range(ord("\xae"), ord("\xff") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def _get_pairs(word: tuple[str, ...]) -> set:
    return {(word[i], word[i + 1]) for i in range(len(word) - 1)}


def _clean(text: str) -> str:
    text = html.unescape(html.unescape(text))
    return re.sub(r"\s+", " ", text.strip()).lower()


class SimpleTokenizer:
    def __init__(self, bpe_path: str | None = None):
        bpe_path = bpe_path or os.environ.get("CLIP_BPE_PATH", "")
        if not bpe_path or not os.path.exists(bpe_path):
            raise FileNotFoundError(
                "BPE merges file required (bpe_simple_vocab_16e6.txt.gz); "
                "pass bpe_path or set CLIP_BPE_PATH")
        with gzip.open(bpe_path, "rt", encoding="utf-8") as f:
            merges = f.read().split("\n")[1:48894 + 1]
        merges = [tuple(m.split()) for m in merges if m]
        self.byte_encoder = bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        vocab = list(self.byte_encoder.values())
        vocab = vocab + [v + "</w>" for v in vocab]
        vocab.extend("".join(m) for m in merges)
        vocab.extend(SPECIAL_TOKENS)
        self.encoder = {t: i for i, t in enumerate(vocab)}
        self.decoder = {i: t for t, i in self.encoder.items()}
        self.bpe_ranks = {m: i for i, m in enumerate(merges)}
        self.cache = {t: t for t in SPECIAL_TOKENS}
        self._chunks: dict[str, list[int]] = {}
        self.sot, self.eot = (self.encoder[t] for t in SPECIAL_TOKENS)
        self.vocab_size = len(self.encoder)

    def _bpe(self, token: str) -> str:
        if token in self.cache:
            return self.cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = _get_pairs(word)
        if not pairs:
            return token + "</w>"
        while True:
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, 1e10))
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
                if i < len(word) - 1 and word[i] == first and word[i + 1] == second:
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = _get_pairs(word)
        out = " ".join(word)
        self.cache[token] = out
        return out

    def _chunk_ids(self, chunk: str) -> list[int]:
        """The ids of one space-free piece of cleaned text (cached: prompts
        share most of their words)."""
        ids = self._chunks.get(chunk)
        if ids is None:
            ids = []
            for token in split_words(chunk):
                token = "".join(self.byte_encoder[b] for b in token.encode("utf-8"))
                ids.extend(self.encoder[t] for t in self._bpe(token).split(" "))
            self._chunks[chunk] = ids
        return ids

    def encode(self, text: str) -> list[int]:
        # no token spans a space, so the split of the cleaned text is the
        # concatenation of its space-separated pieces' splits
        return [i for chunk in _clean(text).split(" ") for i in self._chunk_ids(chunk)]

    def decode(self, ids) -> str:
        text = "".join(self.decoder[int(i)] for i in ids)
        raw = bytearray(self.byte_decoder[c] for c in text)
        return raw.decode("utf-8", errors="replace").replace("</w>", " ")

    def __call__(self, texts, context_length: int = 77) -> np.ndarray:
        """Tokenize to (N, context_length) int32 with SOT/EOT, zero-padded;
        a text too long is truncated with EOT kept last (tokenizer.py
        tokenize())."""
        if isinstance(texts, str):
            texts = [texts]
        out = np.zeros((len(texts), context_length), np.int32)
        for i, t in enumerate(texts):
            ids = [self.sot] + self.encode(t) + [self.eot]
            if len(ids) > context_length:
                ids = ids[:context_length]
                ids[-1] = self.eot
            out[i, :len(ids)] = ids
        return out


def learn_merges(texts, n_merges: int) -> list[tuple[str, str]]:
    """Greedy byte-pair merges learned from `texts` (cleaned and split as the
    tokenizer does; each step merges the most frequent adjacent pair, ties
    broken by the larger pair): a merges file for when the released
    `bpe_simple_vocab_16e6.txt.gz` is not at hand. The ids it gives are
    valid CLIP ids (below 49408) but not the released vocabulary's."""
    byte_encoder = bytes_to_unicode()
    words: collections.Counter = collections.Counter()
    for text in texts:
        for token in split_words(_clean(text)):
            sym = "".join(byte_encoder[b] for b in token.encode("utf-8"))
            words[tuple(sym[:-1]) + (sym[-1] + "</w>",)] += 1
    merges = []
    for _ in range(n_merges):
        pairs: collections.Counter = collections.Counter()
        for word, count in words.items():
            for pair in zip(word, word[1:]):
                pairs[pair] += count
        if not pairs:
            break
        best = max(pairs, key=lambda p: (pairs[p], p))
        merges.append(best)
        merged: collections.Counter = collections.Counter()
        for word, count in words.items():
            out, i = [], 0
            while i < len(word):
                if word[i:i + 2] == best:
                    out.append(word[i] + word[i + 1])
                    i += 2
                else:
                    out.append(word[i])
                    i += 1
            merged[tuple(out)] += count
        words = merged
    return merges


def write_merges(path, merges) -> None:
    """A gzip merges file in the released file's layout: a version line,
    then one "a b" pair a line."""
    with gzip.open(path, "wt", encoding="utf-8") as f:
        f.write("#version: 0.2\n" + "".join(f"{a} {b}\n" for a, b in merges))


@functools.lru_cache(maxsize=2)
def get_tokenizer(bpe_path: str | None = None) -> SimpleTokenizer:
    return SimpleTokenizer(bpe_path)
