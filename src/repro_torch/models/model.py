"""The decoder LM (mirrors ``repro.models.model``) over every config of
the zoo: init / train-forward / log-probs / LM loss / prefill / decode.

The stack is ``prefix blocks + layer pattern x num_periods``: deepseek's
dense first layer, then the pattern of attention / Mamba / RWKV6 mixers
with dense, MoE or channel-mix FFNs.  The reference stacks the pattern
blocks under a leading ``num_periods`` axis for ``lax.scan``; here all
layers are one ``nn.ModuleList`` walked in order, the prefix first
(:mod:`repro_torch.models.convert` maps the two layouts).  On the train
path ``Runtime.remat="block"`` recomputes each period of the pattern in
the backward pass (``torch.utils.checkpoint``, the reference's
``jax.checkpoint`` of its scan body; the prefix runs outside it), and
``scan_groups > 1`` adds the reference's second level: groups of periods
checkpointed whole.  MoE blocks add their load-balancing loss to the
returned aux.

Inputs are token ids or, for the audio and vlm frontends' stubs,
``embeds`` (B, S, d) in their place (:mod:`repro_torch.models.frontend`).
"""
from __future__ import annotations

import functools

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import BlockSpec, ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import mamba, rwkv
from repro_torch.models.attention import Attention, make_cache
from repro_torch.models.layers import Embed, GatedFFN, Norm, pdtype
from repro_torch.models.moe import MoE
from repro_torch.models.runtime import Runtime


class Block(nn.Module):
    """Pre-norm decoder block: ``x + mixer(norm1(x))``, then
    ``x + ffn(norm2(x))`` (with gemma2-style post norms when configured).
    The mixer is ``spec.kind``'s (attention / mamba / rwkv6); the FFN is
    the MoE (plus deepseek's ``shared_ffn``) where ``spec.moe``, RWKV6's
    channel mix, else a gated FFN, of ``dense_d_ff`` in the
    ``first_k_dense`` prefix (layer ``idx``)."""

    def __init__(self, cfg: ModelConfig, spec: BlockSpec, idx: int,
                 device=None):
        super().__init__()
        self.spec = spec
        self.post = cfg.post_block_norm
        self.norm1 = Norm(cfg, device)
        self.norm2 = Norm(cfg, device)
        if cfg.post_block_norm:
            self.post_norm1 = Norm(cfg, device)
            self.post_norm2 = Norm(cfg, device)
        if spec.kind == "attention":
            self.mixer = Attention(cfg, device)
        elif spec.kind == "mamba":
            self.mixer = mamba.Mamba(cfg, device)
        elif spec.kind == "rwkv6":
            self.mixer = rwkv.TimeMix(cfg, device)
        else:
            raise ValueError(f"unknown block kind {spec.kind!r}")
        if spec.moe:
            self.ffn = MoE(cfg, device)
            if cfg.moe_num_shared > 0:
                self.shared_ffn = GatedFFN(
                    cfg, cfg.moe_num_shared * cfg.moe_d_ff, device)
        elif spec.kind == "rwkv6":
            self.ffn = rwkv.ChannelMix(cfg, device)
        else:
            dense = cfg.dense_d_ff and idx < cfg.first_k_dense
            self.ffn = GatedFFN(cfg, cfg.dense_d_ff if dense else cfg.d_ff,
                                device)

    def forward(self, x: torch.Tensor, *, positions: torch.Tensor, mode: str,
                rt: Runtime, cache: dict | None = None,
                cache_len: int | None = None
                ) -> tuple[torch.Tensor, torch.Tensor]:
        """Returns (x, the MoE aux loss or None).  Prefill and decode write
        ``cache`` (this layer's) in place."""
        spec = self.spec
        h = self.norm1(x)
        new = None
        if spec.kind == "attention":
            mix = self.mixer(h, window=spec.attn_window, positions=positions,
                             mode=mode, cache=cache, cache_len=cache_len,
                             attn_chunk=rt.attn_chunk, attn_impl=rt.attn_impl,
                             rt=rt)
        elif spec.kind == "mamba":
            mix, new = self.mixer(h, mode=mode, state=cache,
                                  chunk=rt.mamba_chunk)
        else:
            mix, new = self.mixer(h, mode=mode, state=cache)
        if new is not None:
            cache.update(new)
        if self.post:
            mix = self.post_norm1(mix)
        x = x + mix

        h = self.norm2(x)
        aux = None
        if spec.moe:
            out, aux = self.ffn(h, rt.capacity_factor, mesh=rt.mesh,
                                ep_axis=rt.tp_axis, dp_axes=rt.data_axes())
            if hasattr(self, "shared_ffn"):
                out = out + self.shared_ffn(h)
        elif spec.kind == "rwkv6":
            out, new = self.ffn(h, mode=mode,
                                state=cache if mode == "decode" else None)
            if new is not None:
                cache.update(new)
        else:
            out = self.ffn(h)
        if self.post:
            out = self.post_norm2(out)
        return x + out, aux


class DecoderLM(nn.Module):
    """Parameters named as the reference's pytree leaves, one block per
    layer: ``embed.*``, ``blocks.<layer>.{norm1,norm2,mixer,ffn,
    shared_ffn}.*``, ``final_norm.*``.  Created on ``device`` (``cuda``
    unless ``"cpu"`` is asked) with the normally-initialised parameters
    zeroed; :func:`init_params` draws them."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        self.embed = Embed(cfg, device)
        self.blocks = nn.ModuleList(
            Block(cfg, spec, i, device)
            for i, spec in enumerate(cfg.block_specs()))
        self.final_norm = Norm(cfg, device)


def init_params(generator: torch.Generator, cfg: ModelConfig,
                device=None) -> DecoderLM:
    """A model with the reference's init distributions (normal weights at
    each module's ``init_stds``, the rest at their constants), drawn from
    ``generator``, which must live on ``device``.  The draws differ from
    ``jax.random``'s; tests carry weights across with
    :func:`repro_torch.models.convert.from_reference_params`."""
    model = DecoderLM(cfg, device=device)
    with torch.no_grad():
        for mod in model.modules():
            for leaf, std in getattr(mod, "init_stds", {}).items():
                p = getattr(mod, leaf, None)
                if p is not None:
                    w = torch.randn(p.shape, generator=generator,
                                    device=p.device)
                    p.copy_(w * std)
    return model


def init_cache(cfg: ModelConfig, batch: int, max_seq: int,
               device=None) -> list[dict]:
    """One cache per layer, in the model's dtype: ``{"k", "v"}`` for
    attention, ``{"conv", "ssm"}`` for Mamba, ``{"shift_tm", "shift_cm",
    "wkv"}`` for RWKV6 (recurrent state in fp32)."""
    device = resolve_device(device)
    dt = pdtype(cfg)
    out = []
    for spec in cfg.block_specs():
        if spec.kind == "attention":
            out.append(make_cache(cfg, spec.attn_window, batch, max_seq, dt,
                                  device))
        elif spec.kind == "mamba":
            out.append(mamba.make_state(cfg, batch, dt, device))
        else:
            out.append(rwkv.make_state(cfg, batch, dt, device))
    return out


def _remat(fn, *args):
    return checkpoint(fn, *args, use_reentrant=False)


def _trunk(model: DecoderLM, x: torch.Tensor, rt: Runtime, *,
           positions: torch.Tensor, mode: str, caches: list | None,
           cache_len: int | None) -> tuple[torch.Tensor, torch.Tensor]:
    """(final-normed hidden, aux summed over the blocks)."""
    def layers(lo: int, hi: int, x: torch.Tensor,
               aux: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        for i in range(lo, hi):
            x, a = model.blocks[i](
                x, positions=positions, mode=mode, rt=rt,
                cache=caches[i] if caches is not None else None,
                cache_len=cache_len)
            if a is not None:
                aux = aux + a
        return x, aux

    aux = torch.zeros((), device=x.device)
    if mode != "train" or rt.remat == "none":
        x, aux = layers(0, len(model.blocks), x, aux)
        return model.final_norm(x), aux

    cfg = model.cfg
    first = cfg.first_k_dense
    period = len(cfg.layer_pattern())
    periods = cfg.num_periods()
    x, aux = layers(0, first, x, aux)          # the prefix, outside remat

    def one_period(t: int, x, aux):
        return layers(first + t * period, first + (t + 1) * period, x, aux)

    def remat_periods(lo: int, hi: int, x, aux):
        for t in range(lo, hi):
            x, aux = _remat(functools.partial(one_period, t), x, aux)
        return x, aux

    G = rt.scan_groups
    if G > 1 and periods % G == 0:
        # sqrt-memory remat: each group of periods keeps only its input
        # carry; its recompute remats period by period => peak ~ (G + P/G)
        # carries instead of P
        inner = periods // G
        for g in range(G):
            x, aux = _remat(functools.partial(remat_periods, g * inner,
                                              (g + 1) * inner), x, aux)
    else:
        x, aux = remat_periods(0, periods, x, aux)
    return model.final_norm(x), aux


def _positions(B: int, S: int, start: int, device) -> torch.Tensor:
    return (torch.arange(S, device=device) + start)[None].expand(B, S)


def _embed_inputs(model: DecoderLM, tokens: torch.Tensor | None,
                  embeds: torch.Tensor | None) -> torch.Tensor:
    """The trunk's input: ``embeds`` (a frontend stub's output, cast to
    the model's dtype) in place of the tokens' embeddings when given."""
    if embeds is not None:
        return embeds.to(pdtype(model.cfg))
    return model.embed(tokens)


def forward_train(model: DecoderLM, tokens: torch.Tensor | None,
                  rt: Runtime, *, embeds: torch.Tensor | None = None
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """tokens (B, S), or ``embeds`` (B, S, d) in their place -> (hidden
    (B, S, d), aux loss summed over the MoE blocks); differentiable."""
    x = _embed_inputs(model, tokens, embeds)
    B, S, _ = x.shape
    return _trunk(model, x, rt, positions=_positions(B, S, 0, x.device),
                  mode="train", caches=None, cache_len=None)


def token_logprobs(model: DecoderLM, hidden: torch.Tensor,
                   targets: torch.Tensor, rt: Runtime) -> torch.Tensor:
    """Per-token log p(target), (B, S), in chunks of at most
    ``rt.logit_chunk`` positions (the largest divisor of S), so no more than
    one chunk's (B, ck, V) logits exist at a time outside autograd."""
    B, S, _ = hidden.shape
    ck = min(rt.logit_chunk, S)
    while S % ck != 0:
        ck -= 1
    out = []
    for lo in range(0, S, ck):
        logits = model.embed.logits(hidden[:, lo:lo + ck])     # (B, ck, V)
        logz = torch.logsumexp(logits, dim=-1)
        tgt = torch.gather(logits, -1,
                           targets[:, lo:lo + ck, None].long())[..., 0]
        out.append(tgt - logz)
    return torch.cat(out, dim=1)


def lm_loss(model: DecoderLM, batch: dict,
            rt: Runtime) -> tuple[torch.Tensor, torch.Tensor]:
    """Next-token cross-entropy over ``batch["labels"]`` (else its
    ``tokens``), shifted inside, weighted by the optional ``loss_mask``
    (B, S); the inputs are ``batch["embeds"]`` where given, else its
    tokens.  Returns (loss, aux), differentiable."""
    hidden, aux = forward_train(model, batch.get("tokens"), rt,
                                embeds=batch.get("embeds"))
    targets = batch.get("labels", batch.get("tokens"))[:, 1:]
    mask = batch.get("loss_mask")
    mask = (torch.ones(targets.shape, device=targets.device)
            if mask is None else mask[:, 1:])
    lp = token_logprobs(model, hidden[:, :-1], targets, rt)
    loss = -torch.sum(lp * mask) / torch.clamp_min(torch.sum(mask), 1.0)
    return loss, aux


@torch.no_grad()
def prefill(model: DecoderLM, tokens: torch.Tensor | None, rt: Runtime,
            caches: list, *, embeds: torch.Tensor | None = None
            ) -> tuple[torch.Tensor, list, int]:
    """Run the prompt (tokens (B, S), or ``embeds`` (B, S, d)), its
    attention layers through the flash kernel, filling ``caches`` (KV
    from slot 0, Mamba / RWKV6 state); returns (last-position logits
    (B, V) fp32, caches, S)."""
    x = _embed_inputs(model, tokens, embeds)
    B, S, _ = x.shape
    h, _ = _trunk(model, x, rt, positions=_positions(B, S, 0, x.device),
                  mode="prefill", caches=caches, cache_len=0)
    return model.embed.logits(h[:, -1:])[:, 0], caches, S


@torch.no_grad()
def decode_step(model: DecoderLM, tokens: torch.Tensor | None, rt: Runtime,
                caches: list, cache_len: int, *,
                embeds: torch.Tensor | None = None
                ) -> tuple[torch.Tensor, list, int]:
    """One token in (B, 1) (or ``embeds`` (B, 1, d)), its logits (B, V)
    out; ``cache_len`` is the number of valid cache positions before it."""
    x = _embed_inputs(model, tokens, embeds)
    B = x.shape[0]
    h, _ = _trunk(model, x, rt,
                  positions=_positions(B, 1, cache_len, x.device),
                  mode="decode", caches=caches, cache_len=cache_len)
    return model.embed.logits(h)[:, 0], caches, cache_len + 1
