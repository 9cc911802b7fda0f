"""The bytes a decode step has to stream at least (a copy of the program's
``chip_smoke.py:_step_bytes``, with the K/V bytes added).

Every served weight once (a mixture of experts runs every expert on its
capacity buffer, so all experts' weights), the final norm and the LM head,
plus the K/V every decode row attends in the family's
``attention_layers`` and each decode row's recurrent state
(``state_bytes``). At 256 rows of ~550 tokens of context the K/V of
r1-distill-14b is ~28 GB a step, more than its weights, so it is not
left out here.

Worked count, r1-distill-14b: a layer holds 275,258,368 bf16 parameters
(62,914,560 of attention, 7,168 of biases, 212,336,640 of SwiGLU) and
2 * 5120 fp32 norm scales, 550,557,696 bytes; 48 layers 26,426,769,408;
the final norm 20,480 and the LM head 2 * 778,567,680 = 1,557,135,360;
27,983,925,248 bytes a step (the 29.54 GB served less the embedding
table). 256 rows attending 550 tokens each add 256 * 550 * 196,608 =
27,682,406,400 bytes.
"""
from __future__ import annotations

from bench.work.kv_bytes import kv_token_bytes


def weight_bytes(params: dict) -> int:
    """The served weights' bytes, the embedding table left out (a step
    reads only its rows) unless it is also the LM head."""
    def size(tree):
        return sum(size(v) if isinstance(v, dict)
                   else v.numel() * v.element_size() for v in tree.values())
    head = params["embed"].get("lm_head", params["embed"]["embedding"])
    return (size(params["layers"]) + size(params["final_norm"])
            + head.numel() * head.element_size())


def step_bytes(family, config: dict, params: dict, context: int,
               rows: int) -> int:
    """Weights, the K/V of ``context`` attended tokens in all rows, and
    the recurrent state of ``rows`` decode rows."""
    return (weight_bytes(params)
            + context * kv_token_bytes(config)
            * family.attention_layers(config)
            + rows * family.state_bytes(config))
