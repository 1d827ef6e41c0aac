"""Text dataset utilities (reference: ``$DL/dataset/text``: Dictionary,
LabeledSentence, tokenization/padding transformers; ``$PY/dataset/news20.py``).

Provides the Dictionary + padded-batch pieces the BiLSTM config needs, and a
synthetic news20-style corpus for runs without the real one.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from .dataset import Sample, Transformer


class Dictionary:
    """Token ↔ index mapping with UNK (reference: $DL/dataset/text/Dictionary.scala)."""

    def __init__(self, vocab_size: Optional[int] = None):
        self.vocab_size = vocab_size
        self.word2idx: Dict[str, int] = {"<unk>": 0, "<pad>": 1}
        self.idx2word: List[str] = ["<unk>", "<pad>"]

    def build(self, corpus: Iterable[Sequence[str]]) -> "Dictionary":
        from collections import Counter

        counts = Counter(tok for sent in corpus for tok in sent)
        limit = (self.vocab_size - 2) if self.vocab_size else None
        for tok, _ in counts.most_common(limit):
            if tok not in self.word2idx:
                self.word2idx[tok] = len(self.idx2word)
                self.idx2word.append(tok)
        return self

    def index(self, token: str) -> int:
        return self.word2idx.get(token, 0)

    def encode(self, tokens: Sequence[str]) -> np.ndarray:
        return np.asarray([self.index(t) for t in tokens], np.int32)

    def __len__(self):
        return len(self.idx2word)


class SentenceTokenizer(Transformer):
    """Whitespace/lowercase tokenizer (reference: SentenceTokenizer)."""

    def apply(self, it):
        for text in it:
            yield text.lower().split()


class TextToLabeledSentence(Transformer):
    """(tokens, label) → Sample of encoded indices (reference:
    TextToLabeledSentence + LabeledSentenceToSample)."""

    def __init__(self, dictionary: Dictionary, seq_len: int, pad_id: int = 1):
        self.dictionary = dictionary
        self.seq_len = seq_len
        self.pad_id = pad_id

    def apply(self, it):
        for tokens, label in it:
            ids = self.dictionary.encode(tokens)[: self.seq_len]
            if len(ids) < self.seq_len:
                ids = np.concatenate(
                    [ids, np.full(self.seq_len - len(ids), self.pad_id, np.int32)]
                )
            yield Sample(ids, np.int64(label))


def synthetic_news20(
    n: int = 512, vocab_size: int = 2000, seq_len: int = 64, class_num: int = 20,
    seed: int = 0,
) -> Tuple[np.ndarray, np.ndarray]:
    """Learnable synthetic corpus: each class has characteristic trigger tokens."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, class_num, n)
    seqs = rng.integers(class_num + 2, vocab_size, (n, seq_len)).astype(np.int32)
    # plant 3 class-marker tokens per sequence at random positions
    for k in range(3):
        pos = rng.integers(0, seq_len, n)
        seqs[np.arange(n), pos] = labels + 2
    return seqs, labels.astype(np.int64)
