"""Copy of ``vqatpu.data.dictionary`` (the port imports nothing of the JAX
package).

Vocabulary dictionary, pickle-compatible with the reference's
``Dictionary`` (``FFOE/dataset.py:45-94``): dumps/loads
``[word2idx, idx2word]`` so artifacts interoperate both ways.

Tokenization rule (``dataset.py:62-75``): lowercase, strip ',' and '?',
split `'s` as its own token, whitespace split.  Unknown words map to
``padding_idx - 1`` (the least-frequent vocab word acts as UNK).
"""

from __future__ import annotations

import pickle
from typing import List, Optional


class Dictionary:
    def __init__(self, word2idx: Optional[dict] = None,
                 idx2word: Optional[list] = None):
        self.word2idx = word2idx if word2idx is not None else {}
        self.idx2word = idx2word if idx2word is not None else []

    @property
    def ntoken(self) -> int:
        return len(self.word2idx)

    @property
    def padding_idx(self) -> int:
        return len(self.word2idx)

    def tokenize(self, sentence: str, add_word: bool = False,
                 strip_period: bool = False) -> List[int]:
        """The reference ships THREE tokenizers differing in one rule:
        ``src/dataset.py:46`` (dictionary building, tfidf, answer-embedding
        tools) and ``MC/dataset.py:49`` also strip ``'.'`` — the FFOE
        runtime tokenizer (``FFOE/dataset.py:64``) does not.  The replace
        chain order ('," -> '?' -> 's-split -> '.') is preserved exactly."""
        sentence = sentence.lower()
        sentence = sentence.replace(",", "").replace("?", "").replace("'s", " 's")
        if strip_period:
            sentence = sentence.replace(".", "")
        words = sentence.split()
        if add_word:
            return [self.add_word(w) for w in words]
        unk = self.padding_idx - 1
        return [self.word2idx.get(w, unk) for w in words]

    def tokenize_padded(self, sentence: str, max_length: int,
                        strip_period: bool = False) -> List[int]:
        """Tokenize, truncate, and pad (at the END, matching the reference's
        actual behavior despite its 'pad in front' comment,
        ``FFOE/dataset.py:300-309``)."""
        tokens = self.tokenize(sentence, strip_period=strip_period)[:max_length]
        tokens = tokens + [self.padding_idx] * (max_length - len(tokens))
        return tokens

    def add_word(self, word: str) -> int:
        if word not in self.word2idx:
            self.idx2word.append(word)
            self.word2idx[word] = len(self.idx2word) - 1
        return self.word2idx[word]

    def dump_to_file(self, path: str) -> None:
        with open(path, "wb") as f:
            pickle.dump([self.word2idx, self.idx2word], f)

    @classmethod
    def load_from_file(cls, path: str) -> "Dictionary":
        with open(path, "rb") as f:
            word2idx, idx2word = pickle.load(f)
        return cls(word2idx, idx2word)

    def __len__(self) -> int:
        return len(self.idx2word)
