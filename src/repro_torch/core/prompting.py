"""Contrastive prompt construction (paper §3.2, Table 1) at token level.

Prompt =  [BOS] [MODULE_<m>]
          for each sampled exemplar (previous implementation + speed):
              [EXEMPLAR] [SCORE_<bucket>] <knob tokens...>
          [GEN]
and the policy must then emit exactly ``knob_count(module)`` knob tokens —
its "## Code" section.  Scores ride along as quantized bucket tokens so the
policy can *compare* fast and slow exemplars, which is the contrastive
mechanism of the paper (the analysis sections of the paper's response
format are implicit in the attention over exemplar/score pairs).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.core.variant_space import MODULES, MODULE_ORDER, Program, knob_count

# ---------------------------------------------------------------------------
# Vocab layout
# ---------------------------------------------------------------------------
PAD, BOS, EOS, GEN, EXEMPLAR = 0, 1, 2, 3, 4
MODULE_BASE = 8                                   # one tag per MODULE_ORDER entry
NUM_SCORE_BUCKETS = 32
SCORE_BASE = MODULE_BASE + len(MODULE_ORDER)      # then the score buckets

_knob_base: dict[tuple[str, str], int] = {}
_cursor = SCORE_BASE + NUM_SCORE_BUCKETS
for _m in MODULE_ORDER:
    for _name, _choices in MODULES[_m]:
        _knob_base[(_m, _name)] = _cursor
        _cursor += len(_choices)
VOCAB_SIZE = _cursor


def module_token(module: str) -> int:
    return MODULE_BASE + MODULE_ORDER.index(module)


def score_token(score: float, lo: float = 0.0, hi: float = 2.0) -> int:
    """Scores are relative-to-baseline speed (1.0 = baseline)."""
    x = np.clip((score - lo) / max(hi - lo, 1e-9), 0.0, 1.0 - 1e-9)
    return SCORE_BASE + int(x * NUM_SCORE_BUCKETS)


def knob_token(module: str, knob: str, choice: int) -> int:
    return _knob_base[(module, knob)] + choice


def program_tokens(p: Program) -> list[int]:
    return [
        knob_token(p.module, name, c)
        for (name, _), c in zip(MODULES[p.module], p.choices)
    ]


def decode_program(module: str, tokens: list[int]) -> Program | None:
    """Strict decode; None on any out-of-range token (reward 0 per paper)."""
    if len(tokens) != knob_count(module):
        return None
    choices = []
    for (name, vals), t in zip(MODULES[module], tokens):
        base = _knob_base[(module, name)]
        c = int(t) - base
        if not (0 <= c < len(vals)):
            return None
        choices.append(c)
    return Program(module, tuple(choices))


def valid_token_mask(module: str, position: int) -> np.ndarray:
    """Grammar mask for constrained sampling at completion position `pos`."""
    mask = np.zeros(VOCAB_SIZE, bool)
    name, vals = MODULES[module][position]
    base = _knob_base[(module, name)]
    mask[base:base + len(vals)] = True
    return mask


@dataclass(frozen=True)
class PromptSpec:
    max_exemplars: int = 6
    max_len: int = 128


def build_prompt(module: str, exemplars: list[tuple[Program, float]],
                 spec: PromptSpec = PromptSpec()) -> list[int]:
    toks = [BOS, module_token(module)]
    for prog, score in exemplars[: spec.max_exemplars]:
        toks.append(EXEMPLAR)
        toks.append(score_token(score))
        toks.extend(program_tokens(prog))
    toks.append(GEN)
    assert len(toks) <= spec.max_len, "prompt overflow"
    return toks
