"""Text tokenizers for the CLIP text tower (the port's own copy of the JAX
package's ``data/tokenizer.py``).

``SimpleTokenizer`` is CLIP's byte-level BPE (egocentric
``avion/data/tokenizer.py`` upstream), on the standard library's ``re`` and
``html`` only; its merges file (``bpe_simple_vocab_16e6.txt.gz``, gzipped
or plain) is an asset the user provides. ``WordTokenizer`` builds a word
vocabulary from a corpus: ids 0 <pad>, 1 <bos>, 2 <eos>, 3 <unk>, then the
corpus's words by count. ``tokenize`` frames either one's ids.
"""

from __future__ import annotations

import gzip
import html
import re
from collections import Counter
from functools import lru_cache
from typing import Dict, List, Optional, Sequence, Union

import numpy as np


@lru_cache()
def bytes_to_unicode() -> Dict[int, str]:
    """GPT-2 byte-to-unicode table (reversible, avoids control chars)."""
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("¡"), ord("¬") + 1))
        + list(range(ord("®"), ord("ÿ") + 1))
    )
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def get_pairs(word):
    return {(word[i], word[i + 1]) for i in range(len(word) - 1)}


def basic_clean(text: str) -> str:
    return html.unescape(html.unescape(text)).strip()


def whitespace_clean(text: str) -> str:
    return re.sub(r"\s+", " ", text).strip()


class SimpleTokenizer:
    """CLIP byte-level BPE tokenizer over the merges file ``bpe_path``
    (gzipped when it ends in ``.gz``): its first line is a header, then at
    most 48894 merges; the vocabulary is the 256 byte symbols, the same
    with ``</w>``, one token per merge, then <|startoftext|> and
    <|endoftext|>."""

    def __init__(self, bpe_path: str, context_length: int = 77):
        self.context_length = context_length
        self.byte_encoder = bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        opener = gzip.open if bpe_path.endswith(".gz") else open
        with opener(bpe_path, "rt", encoding="utf-8") as f:
            merges = f.read().split("\n")
        merges = merges[1: 49152 - 256 - 2 + 1]
        merges = [tuple(m.split()) for m in merges if m]
        vocab = list(bytes_to_unicode().values())
        vocab = vocab + [v + "</w>" for v in vocab]
        for m in merges:
            vocab.append("".join(m))
        vocab.extend(["<|startoftext|>", "<|endoftext|>"])
        self.encoder = {v: i for i, v in enumerate(vocab)}
        self.decoder = {i: v for v, i in self.encoder.items()}
        self.bpe_ranks = dict(zip(merges, range(len(merges))))
        self.cache = {
            "<|startoftext|>": "<|startoftext|>",
            "<|endoftext|>": "<|endoftext|>",
        }
        self.pat = re.compile(
            r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d"
            r"|[^\s\w]+|\w+",
            re.IGNORECASE,
        )

    def bpe(self, token: str) -> str:
        """The token's BPE symbols, space-separated, the last with
        ``</w>``."""
        if token in self.cache:
            return self.cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = get_pairs(word)
        if not pairs:
            return token + "</w>"
        while True:
            bigram = min(pairs,
                         key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word: List[str] = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    new_word.extend(word[i:])
                    break
                new_word.extend(word[i:j])
                i = j
                if word[i] == first and i < len(word) - 1 and \
                        word[i + 1] == second:
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = get_pairs(word)
        out = " ".join(word)
        self.cache[token] = out
        return out

    def encode(self, text: str) -> List[int]:
        bpe_tokens: List[int] = []
        text = whitespace_clean(basic_clean(text)).lower()
        for token in self.pat.findall(text):
            token = "".join(self.byte_encoder[b] for b in token.encode("utf-8"))
            bpe_tokens.extend(
                self.encoder[t] for t in self.bpe(token).split(" ")
            )
        return bpe_tokens

    def sot_token(self) -> int:
        return self.encoder["<|startoftext|>"]

    def eot_token(self) -> int:
        return self.encoder["<|endoftext|>"]

    def __call__(self, texts: Union[str, Sequence[str]]) -> np.ndarray:
        return tokenize(texts, self, self.context_length)


class WordTokenizer:
    """Whitespace word-level tokenizer with a corpus-built vocabulary of at
    most ``max_vocab`` ids (the most common words first, ties in order of
    first appearance)."""

    PAD, BOS, EOS, UNK = 0, 1, 2, 3

    def __init__(self, corpus: Optional[Sequence[str]] = None,
                 context_length: int = 77, max_vocab: int = 10000):
        self.context_length = context_length
        self.word_to_id: Dict[str, int] = {}
        if corpus:
            counts = Counter(
                w for t in corpus for w in whitespace_clean(t).lower().split()
            )
            for i, (w, _) in enumerate(counts.most_common(max_vocab - 4)):
                self.word_to_id[w] = i + 4

    @property
    def vocab_size(self) -> int:
        return len(self.word_to_id) + 4

    def encode(self, text: str) -> List[int]:
        return [
            self.word_to_id.get(w, self.UNK)
            for w in whitespace_clean(text).lower().split()
        ]

    def sot_token(self) -> int:
        return self.BOS

    def eot_token(self) -> int:
        return self.EOS

    def __call__(self, texts: Union[str, Sequence[str]]) -> np.ndarray:
        return tokenize(texts, self, self.context_length)


def tokenize(texts: Union[str, Sequence[str]], tokenizer,
             context_length: int = 77) -> np.ndarray:
    """(N, context_length) int32: each text's ids between the tokenizer's
    start and end tokens, cut to fit, then zeros."""
    if isinstance(texts, str):
        texts = [texts]
    sot, eot = tokenizer.sot_token(), tokenizer.eot_token()
    out = np.zeros((len(texts), context_length), np.int32)
    for i, t in enumerate(texts):
        toks = [sot] + tokenizer.encode(t)[: context_length - 2] + [eot]
        out[i, : len(toks)] = toks
    return out
