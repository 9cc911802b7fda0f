"""Tiny fixed vocabulary for the synthetic reasoning task."""
from __future__ import annotations

from typing import List

PAD, EOS, BOS = 0, 1, 2
DIGIT0 = 3                      # '0'..'9' -> 3..12
PLUS, MINUS, TIMES, EQUALS = 13, 14, 15, 16
STEP, SEP, ANSWER, RECHECK = 17, 18, 19, 20   # '>', ';', 'A', 'R'
VOCAB_SIZE = 32                 # padded to a power-of-two-ish tile

_CHARS = {PAD: "_", EOS: "$", BOS: "^", PLUS: "+", MINUS: "-", TIMES: "*",
          EQUALS: "=", STEP: ">", SEP: ";", ANSWER: "A", RECHECK: "R"}
OPS = {"+": PLUS, "-": MINUS, "*": TIMES}


def digit(d: int) -> int:
    assert 0 <= d <= 9
    return DIGIT0 + d


def is_digit(tok: int) -> bool:
    return DIGIT0 <= tok < DIGIT0 + 10


def digit_value(tok: int) -> int:
    assert is_digit(tok)
    return tok - DIGIT0


def decode(tokens: List[int]) -> str:
    out = []
    for t in tokens:
        if is_digit(t):
            out.append(str(digit_value(t)))
        else:
            out.append(_CHARS.get(t, "?"))
    return "".join(out)
