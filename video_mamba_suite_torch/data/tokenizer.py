"""The corpus-built word tokenizer (the port's own copy of the JAX
package's ``WordTokenizer``, ``whitespace_clean`` and ``tokenize`` from
``data/tokenizer.py``): ids 0 <pad>, 1 <bos>, 2 <eos>, 3 <unk>, then the
corpus's words by count. The CLIP byte-level BPE ``SimpleTokenizer`` is
not ported yet."""

from __future__ import annotations

import re
from collections import Counter
from typing import Dict, List, Optional, Sequence, Union

import numpy as np


def whitespace_clean(text: str) -> str:
    return re.sub(r"\s+", " ", text).strip()


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
