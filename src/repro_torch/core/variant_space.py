"""The structured variant grammar — CRINN's action space (mirrors
``repro.core.variant_space``; grammar, vocab and token layout identical).

The paper's policy emits free-form C++; offline we cannot run a pretrained
code LLM, so the policy emits token sequences over this grammar instead
(DESIGN.md §2).  The knobs are exactly the optimization dimensions the
paper's RL discovered (§6): adaptive-EF scaling, prefetch-depth analogue
(gather width), multi-entry points, early termination, quantized rerank,
construction breadth/diversity.

Each knob is a categorical choice; a module's "code" is the tuple of its
knob choices.  Token layout (see ``repro_torch.core.prompting`` for the full
vocab): every (knob, choice) pair owns one token, so decoding is exact and
malformed programs are detectable (reward 0, per the paper's "failure to
maintain accuracy/interface => score 0" rule).
"""
from __future__ import annotations

import dataclasses
import itertools
from dataclasses import dataclass

from repro_torch.anns.engine import VariantConfig

# Backend families of the reference's registry.  Promoted into MODULES as
# the "backend" module: the policy picks the algorithm family itself, with
# per-family reward baselines (repro_torch.core.reward.FamilyBaselines)
# keeping banded-AUC comparable across families.
BACKEND_CHOICES = ("graph", "brute_force", "quantized_prefilter", "ivf",
                   "sharded")

# module name -> ordered list of (knob, choices)
MODULES: dict[str, list[tuple[str, tuple]]] = {
    "backend": [
        ("backend", BACKEND_CHOICES),
    ],
    "graph_construction": [
        ("degree", (16, 24, 32, 48, 64)),
        ("ef_construction", (32, 48, 64, 96, 128, 192)),
        ("nn_descent_rounds", (2, 3, 4, 6)),
        ("alpha", (1.0, 1.1, 1.2, 1.3)),
        ("num_entry_points", (1, 2, 3, 5, 7, 9)),
        ("adaptive_ef_coef", (0.0, 4.0, 8.0, 14.5, 20.0)),
    ],
    "search": [
        ("gather_width", (1, 2, 4)),
        ("patience", (0, 2, 4, 8)),
    ],
    # partition-family knobs (inert while backend is a graph family —
    # rewards flatten and the GRPO advantage is 0, so sampling them is
    # harmless; decisive once the backend module picks "ivf").
    # rerank_factor is deliberately shared with "refinement": both stages
    # own the same VariantConfig field, and each run_module seeds its DB
    # with the inherited value, so a tuned choice survives the later
    # stage unless a resample measurably beats it.
    "ivf": [
        ("nlist", (16, 32, 64, 128, 256)),
        ("nprobe", (1, 2, 4, 8, 16, 32)),
        ("kmeans_iters", (2, 4, 8, 16)),
        ("rerank_factor", (1, 2, 4, 8)),
        # sharded-family scale-out knob (inert for backend != "sharded");
        # the policy trades merge overhead against per-shard scan width
        ("n_shards", (1, 2, 4, 8)),
    ],
    "refinement": [
        ("quantized_prefilter", (False, True)),
        ("rerank_factor", (1, 2, 4, 8)),
    ],
}

# progressive optimization order (§3.1), coarsest decision first: pick
# the family, tune its construction, tune search, tune the partition
# knobs, then shared refinement.
MODULE_ORDER = ("backend", "graph_construction", "search", "ivf",
                "refinement")


def knob_count(module: str) -> int:
    return len(MODULES[module])


def program_space_size(module: str) -> int:
    n = 1
    for _, choices in MODULES[module]:
        n *= len(choices)
    return n


@dataclass(frozen=True)
class Program:
    """A decoded module implementation: choice index per knob."""
    module: str
    choices: tuple[int, ...]

    def knobs(self) -> dict:
        out = {}
        for (name, vals), c in zip(MODULES[self.module], self.choices):
            out[name] = vals[c]
        return out

    def apply_to(self, variant: VariantConfig) -> VariantConfig:
        return dataclasses.replace(variant, **self.knobs())


def program_from_variant(module: str, variant: VariantConfig) -> Program:
    """Inverse mapping (used to seed the DB with the GLASS baseline)."""
    choices = []
    for name, vals in MODULES[module]:
        v = getattr(variant, name)
        choices.append(vals.index(v))
    return Program(module, tuple(choices))


def all_programs(module: str):
    ranges = [range(len(ch)) for _, ch in MODULES[module]]
    for combo in itertools.product(*ranges):
        yield Program(module, combo)
