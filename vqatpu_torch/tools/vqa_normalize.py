"""VQA answer-string normalization, a copy of ``vqatpu.tools.vqa_normalize``
(canonical rules from the official VQA evaluation API,
visualqa.org/evaluation.html; mirrored by the reference's
``tools/compute_softscore.py:18-136``).  The Visual Genome entries of
:mod:`vqatpu_torch.data.datasets` map their answers through
:func:`preprocess_answer`.

The contraction table is *derived* rather than enumerated: the published map
is exactly "every way of dropping one apostrophe from a canonical
contraction" plus a handful of quirk entries, so we generate it from the
canonical list — easier to audit and provably complete.
"""

from __future__ import annotations

import re
from typing import Dict

_CANONICAL_CONTRACTIONS = [
    "ain't", "aren't", "can't", "could've", "couldn't", "couldn't've",
    "didn't", "doesn't", "don't", "hadn't", "hadn't've", "hasn't", "haven't",
    "he'd", "he'd've", "he's", "how'd", "how'll", "how's", "I'd've", "I'm",
    "I've", "isn't", "it'd", "it'd've", "it'll", "ma'am", "mightn't",
    "mightn't've", "might've", "mustn't", "must've", "needn't", "not've",
    "o'clock", "oughtn't", "'ow's'at", "shan't", "she'd've", "should've",
    "shouldn't", "shouldn't've", "somebody'd've", "somebody'll", "somebody's",
    "someone'd", "someone'd've", "someone'll", "someone's", "something'd",
    "something'd've", "something'll", "that's", "there'd", "there'd've",
    "there're", "there's", "they'd", "they'd've", "they'll", "they're",
    "they've", "'twas", "wasn't", "we'd've", "we've", "weren't", "what'll",
    "what're", "what's", "what've", "when's", "where'd", "where's",
    "where've", "who'd", "who'd've", "who'll", "who's", "who've", "why'll",
    "why're", "why's", "won't", "would've", "wouldn't", "wouldn't've",
    "y'all", "y'all'll", "y'all'd've", "you'd", "you'd've", "you'll",
    "you're", "you've",
]

# quirks in the published table that the drop-one-apostrophe rule can't give
_CONTRACTION_QUIRKS = {
    "let's": "let's",
    "she's": "she's",
    "somebody'd": "somebodyd",  # inverted in the official table
}


def _build_contractions() -> Dict[str, str]:
    out: Dict[str, str] = {}
    for canon in _CANONICAL_CONTRACTIONS:
        positions = [i for i, ch in enumerate(canon) if ch == "'"]
        for pos in positions:
            key = canon[:pos] + canon[pos + 1:]
            out[key] = canon
    out.update(_CONTRACTION_QUIRKS)
    return out


CONTRACTIONS = _build_contractions()

DIGIT_MAP = {
    "none": "0", "zero": "0", "one": "1", "two": "2", "three": "3",
    "four": "4", "five": "5", "six": "6", "seven": "7", "eight": "8",
    "nine": "9", "ten": "10",
}

ARTICLES = ("a", "an", "the")

_PERIOD_STRIP = re.compile(r"(?!<=\d)(\.)(?!\d)")
_COMMA_STRIP = re.compile(r"(\d)(\,)(\d)")
_PUNCT = [";", "/", "[", "]", '"', "{", "}", "(", ")", "=", "+", "\\", "_",
          "-", ">", "<", "@", "`", ",", "?", "!"]


def process_punctuation(text: str) -> str:
    out = text
    for p in _PUNCT:
        if (p + " " in text or " " + p in text) or _COMMA_STRIP.search(text):
            out = out.replace(p, "")
        else:
            out = out.replace(p, " ")
    return _PERIOD_STRIP.sub("", out, re.UNICODE)


def process_digit_article(text: str) -> str:
    words = []
    for word in text.lower().split():
        word = DIGIT_MAP.get(word, word)
        if word not in ARTICLES:
            words.append(word)
    return " ".join(CONTRACTIONS.get(w, w) for w in words)


def preprocess_answer(answer: str) -> str:
    answer = process_digit_article(process_punctuation(answer))
    return answer.replace(",", "")


def get_score(occurrences: int) -> float:
    """VQA soft score: average over 10-choose-9 annotator subsets
    (``compute_softscore.py:86-96``)."""
    return (0.0, 0.3, 0.6, 0.9)[occurrences] if occurrences < 4 else 1.0
