"""Bytes the decode attention of a step has to move (K1's and K3's work).

The same yardstick for both kernels: every K/V page the step's decode
rows attend, read once, even where siblings or requests share it, with
the tokens it holds (the most any row attends in it); plus each row's
q read and its output written. So a kernel that reads a shared prompt
page once per sibling (K1) shows that cost as a lower share, and one
that reads it once (K3) does not.

The layers that hold K/V are the family's ``attention_layers``.

Worked count, r1-distill-14b (8 KV heads of 128, 48 layers, bf16): a
token's K and V are 2*8*128*2 = 4,096 bytes a layer, 196,608 in all; a
16-token page 3 MiB. Two siblings sharing a full 20-token prompt page
and each holding 5 tokens of their own in a second page: pages {p: 16,
a: 5, b: 5} hold 26 tokens, 26 * 196,608 = 5,111,808 bytes; q and the
output, 2 rows * 40 heads * 128 * 2 bytes * 2 * 48 layers = 1,966,080.
"""
from __future__ import annotations

from typing import Iterable, Sequence, Tuple


def kv_token_bytes(config: dict, elem: int = 2) -> int:
    """K and V bytes of one token in one layer."""
    heads = config["num_attention_heads"]
    hd = config.get("head_dim", config["hidden_size"] // heads)
    return 2 * config["num_key_value_heads"] * hd * elem


def unique_tokens(tables: Iterable[Tuple[Sequence[int], int]],
                  page_size: int) -> int:
    """Tokens held by the distinct pages of ``tables`` ((pages, length)
    per decode row), each page counted once with the most tokens any row
    attends in it."""
    fill = {}
    for pages, length in tables:
        for j in range(-(-length // page_size)):
            valid = min(page_size, length - j * page_size)
            p = pages[j]
            if fill.get(p, 0) < valid:
                fill[p] = valid
    return sum(fill.values())


def decode_bytes(family, config: dict, tables, page_size: int,
                 elem: int = 2) -> int:
    """The step's decode attention work in bytes over the layers that
    hold K/V."""
    tables = list(tables)
    heads = config["num_attention_heads"]
    hd = config.get("head_dim", config["hidden_size"] // heads)
    layers = family.attention_layers(config)
    kv = unique_tokens(tables, page_size) * kv_token_bytes(config, elem)
    qo = len(tables) * heads * hd * elem * 2
    return (kv + qo) * layers
