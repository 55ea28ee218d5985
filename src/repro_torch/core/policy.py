"""Policy wrapper (mirrors ``repro.core.policy``): grammar-constrained
sampling of variant programs from the decoder LM, with per-token logps
recorded for GRPO.

Completions are fixed-length (= knob count of the module), so a rollout is
``prefill(prompt)`` (through the flash kernel on the card) plus
``knob_count`` decode steps.  Sampling draws from a ``torch.Generator`` on
the model's device; its stream is not ``jax.random``'s, so parity with the
reference holds at temperature 0 (argmax).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import prompting
from repro_torch.core.variant_space import Program, knob_count
from repro_torch.models import model as model_lib
from repro_torch.models.model import DecoderLM
from repro_torch.models.runtime import Runtime


@dataclass
class Rollout:
    tokens: np.ndarray        # (T,) prompt + completion
    mask: np.ndarray          # (T,) 1.0 on completion positions
    logps: np.ndarray         # (T,) rollout-policy logp of each token (0 off-mask)
    program: Program | None


class Policy:
    def __init__(self, cfg: ModelConfig, model: DecoderLM, rt: Runtime):
        if cfg.padded_vocab < prompting.VOCAB_SIZE:
            raise ValueError(f"padded vocab {cfg.padded_vocab} < prompt "
                             f"vocab {prompting.VOCAB_SIZE}")
        self.cfg = cfg
        self.model = model
        self.rt = rt

    @property
    def device(self) -> torch.device:
        return self.model.embed.embedding.device

    def _masked_sample(self, logits: torch.Tensor, mask: torch.Tensor,
                       generator: torch.Generator | None,
                       temperature: float) -> tuple[torch.Tensor, torch.Tensor]:
        """Sample from the grammar-masked distribution but record the
        *full-vocab* logp: the mask is part of the sampler (environment),
        not the policy measure, so rollout logps stay consistent with the
        full-softmax logps the GRPO loss recomputes."""
        vl = torch.where(mask[None, :logits.shape[-1]], logits,
                         torch.tensor(-1e30, dtype=logits.dtype,
                                      device=logits.device))
        if temperature <= 0:
            tok = torch.argmax(vl, dim=-1)
        else:
            probs = torch.softmax(vl / temperature, dim=-1)
            tok = torch.multinomial(probs, 1, generator=generator)[:, 0]
        lse_full = torch.log_softmax(logits, dim=-1)
        lp = torch.gather(lse_full, -1, tok[:, None])[:, 0]
        return tok, lp

    def sample_group(self, module: str, prompt: list[int], g: int,
                     generator: torch.Generator | None = None,
                     temperature: float = 1.0) -> list[Rollout]:
        """Sample G completions for one prompt (one GRPO group);
        ``generator`` (on the model's device) is needed unless
        ``temperature <= 0``."""
        cfg, rt, model, dev = self.cfg, self.rt, self.model, self.device
        n_steps = knob_count(module)
        T = len(prompt)
        toks = torch.tensor(prompt, dtype=torch.long, device=dev)[None].repeat(g, 1)

        caches = model_lib.init_cache(cfg, g, T + n_steps + 1, device=dev)
        logits, caches, clen = model_lib.prefill(model, toks, rt, caches)

        out_toks, out_lps = [], []
        vmask_full = torch.zeros(cfg.padded_vocab, dtype=torch.bool)
        for step in range(n_steps):
            vmask = prompting.valid_token_mask(module, step)
            vmask_full[:] = False
            vmask_full[: len(vmask)] = torch.from_numpy(vmask)
            tok, lp = self._masked_sample(logits.float(), vmask_full.to(dev),
                                          generator, temperature)
            out_toks.append(tok)
            out_lps.append(lp)
            logits, caches, clen = model_lib.decode_step(
                model, tok[:, None], rt, caches, clen)

        comp = torch.stack(out_toks, dim=1).to(torch.int32).cpu().numpy()
        lps = torch.stack(out_lps, dim=1).float().cpu().numpy()

        rollouts = []
        for i in range(g):
            tokens = np.concatenate([np.asarray(prompt, np.int32), comp[i]])
            mask = np.concatenate([np.zeros(T, np.float32),
                                   np.ones(n_steps, np.float32)])
            logps = np.concatenate([np.zeros(T, np.float32), lps[i]])
            prog = prompting.decode_program(module, comp[i].tolist())
            rollouts.append(Rollout(tokens, mask, logps, prog))
        return rollouts
