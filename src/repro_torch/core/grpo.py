"""GRPO (paper §3.4, eqs. 2-3), mirrors ``repro.core.grpo``.

Group-relative advantages (eq. 2):  r_hat_i = (r_i - mean(r)) / std(r),
with the population std (ddof 0, as ``jnp.std``).  Objective (eq. 3):
per-token PPO-clip with the importance ratio against the rollout policy,
length-normalised per completion, minus a beta-weighted k3 KL penalty
against the reference policy.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.models import model as model_lib
from repro_torch.models.model import DecoderLM
from repro_torch.models.runtime import Runtime


@dataclass(frozen=True)
class GRPOConfig:
    eps_clip: float = 0.2
    beta: float = 0.04           # KL regularisation weight
    aux_weight: float = 0.01     # MoE load-balance loss weight
    group_size: int = 8


def group_advantages(rewards: torch.Tensor) -> torch.Tensor:
    """Eq. (2) over one prompt group. rewards: (G,) -> (G,)."""
    mu = torch.mean(rewards)
    sd = torch.std(rewards, correction=0)
    return (rewards - mu) / (sd + 1e-6)


def grpo_loss(model: DecoderLM, batch: dict, rt: Runtime,
              gcfg: GRPOConfig) -> tuple[torch.Tensor, dict]:
    """batch (tensors on the model's device):
      tokens      (B, T) int — prompt + completion
      mask        (B, T) fp32 — 1 on completion tokens (loss positions)
      advantages  (B,)   fp32 — group-normalised rewards
      old_logps   (B, T) fp32 — rollout policy per-token logp (0 off-mask)
      ref_logps   (B, T) fp32 — reference policy per-token logp
      embeds      (B, T, d), optional — the frontend stub's inputs, fed to
                  the trunk in place of the tokens (audio, vlm)
    Predictions at position t-1 score token t.  Returns (loss, metrics)
    with the loss differentiable in the model's parameters.
    """
    tokens = batch["tokens"]
    hidden, aux = model_lib.forward_train(model, tokens, rt,
                                          embeds=batch.get("embeds"))
    lp = model_lib.token_logprobs(model, hidden[:, :-1], tokens[:, 1:], rt)
    mask = batch["mask"][:, 1:]
    old = batch["old_logps"][:, 1:]
    ref = batch["ref_logps"][:, 1:]
    adv = batch["advantages"][:, None]

    ratio = torch.exp(lp - old)
    unclipped = ratio * adv
    clipped = torch.clamp(ratio, 1.0 - gcfg.eps_clip, 1.0 + gcfg.eps_clip) * adv
    pg = torch.minimum(unclipped, clipped)

    # k3 KL estimator: exp(ref-lp) - (ref-lp) - 1  >= 0
    dlr = ref - lp
    kl = torch.exp(dlr) - dlr - 1.0

    per_tok = (pg - gcfg.beta * kl) * mask
    denom = torch.clamp_min(torch.sum(mask, dim=1), 1.0)
    per_seq = torch.sum(per_tok, dim=1) / denom
    loss = -torch.mean(per_seq) + gcfg.aux_weight * aux

    with torch.no_grad():
        metrics = {
            "pg": torch.mean(torch.sum(pg * mask, dim=1) / denom),
            "kl": torch.mean(torch.sum(kl * mask, dim=1) / denom),
            "ratio_max": torch.max(torch.where(mask > 0, ratio, 1.0)),
            "aux": aux,
        }
    return loss, metrics


def grpo_loss_and_grad(model: DecoderLM, batch: dict, rt: Runtime,
                       gcfg: GRPOConfig, loss_scale: float = 1.0):
    """((loss, metrics), grads) with grads a {parameter name: tensor} dict
    (zeros for a parameter the loss does not reach, as ``jax.grad``
    gives: the token embedding when ``embeds`` replace the tokens);
    nothing is accumulated into ``.grad``.  The gradients are those of
    ``loss * loss_scale`` (a sharded step's rank backpropagates
    ``loss / world``: :mod:`repro_torch.dist.fsdp`)."""
    loss, metrics = grpo_loss(model, batch, rt, gcfg)
    named = dict(model.named_parameters())
    grads = torch.autograd.grad(loss * loss_scale, list(named.values()),
                                materialize_grads=True)
    return (loss.detach(), metrics), dict(zip(named, grads))
