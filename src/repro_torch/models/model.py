"""The decoder LM (mirrors ``repro.models.model``) for the dense family:
init / train-forward / log-probs / LM loss / prefill / decode.

The reference stacks the pattern blocks under a leading ``num_periods``
axis for ``lax.scan``; here the layers are an ``nn.ModuleList`` walked in
order (:mod:`repro_torch.models.convert` unstacks the reference's
parameters).  On the train path ``Runtime.remat="block"`` recomputes each
period of the layer pattern in the backward pass
(``torch.utils.checkpoint``, the reference's ``jax.checkpoint`` of its
scan body), and ``scan_groups > 1`` adds the reference's second level:
groups of periods checkpointed whole.  Other families raise
``NotImplementedError`` (ROADMAP.md queue item 8).
"""
from __future__ import annotations

import functools

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import BlockSpec, ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models.attention import Attention, make_cache
from repro_torch.models.layers import Embed, GatedFFN, Norm, pdtype
from repro_torch.models.runtime import Runtime


class Block(nn.Module):
    """Pre-norm decoder block: ``x + mixer(norm1(x))``, then
    ``x + ffn(norm2(x))`` (with gemma2-style post norms when configured)."""

    def __init__(self, cfg: ModelConfig, spec: BlockSpec, device=None):
        super().__init__()
        self.window = spec.attn_window
        self.post = cfg.post_block_norm
        self.norm1 = Norm(cfg, device)
        self.norm2 = Norm(cfg, device)
        if cfg.post_block_norm:
            self.post_norm1 = Norm(cfg, device)
            self.post_norm2 = Norm(cfg, device)
        self.mixer = Attention(cfg, device)
        self.ffn = GatedFFN(cfg, cfg.d_ff, device)

    def forward(self, x: torch.Tensor, *, positions: torch.Tensor, mode: str,
                rt: Runtime, cache: dict | None = None,
                cache_len: int | None = None) -> torch.Tensor:
        mix = self.mixer(self.norm1(x), window=self.window,
                         positions=positions, mode=mode, cache=cache,
                         cache_len=cache_len, attn_chunk=rt.attn_chunk,
                         attn_impl=rt.attn_impl)
        if self.post:
            mix = self.post_norm1(mix)
        x = x + mix
        out = self.ffn(self.norm2(x))
        if self.post:
            out = self.post_norm2(out)
        return x + out


class DecoderLM(nn.Module):
    """Parameters named as the reference's pytree leaves: ``embed.*``,
    ``blocks.<layer>.{norm1,norm2,mixer,ffn}.*``, ``final_norm.scale``.
    Created with zeroed parameters on ``device`` (``cuda`` unless
    ``"cpu"`` is asked); :func:`init_params` draws them."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        cfg.require_dense()
        device = resolve_device(device)
        self.cfg = cfg
        self.embed = Embed(cfg, device)
        self.blocks = nn.ModuleList(
            Block(cfg, spec, device) for spec in cfg.block_specs())
        self.final_norm = Norm(cfg, device)


def _init_std(name: str, cfg: ModelConfig) -> float | None:
    """The reference's init scale of a parameter (None: zeros)."""
    leaf = name.rsplit(".", 1)[-1]
    d = cfg.d_model
    if leaf in ("embedding", "unembed", "wq", "wk", "wv", "w_gate", "w_in"):
        return d ** -0.5
    if leaf == "wo":
        return (cfg.num_heads * cfg.head_dim) ** -0.5
    if leaf == "w_out":
        return cfg.d_ff ** -0.5
    return None                      # norm scales / biases start at zero


def init_params(generator: torch.Generator, cfg: ModelConfig,
                device=None) -> DecoderLM:
    """A model with the reference's init distributions (normal weights at
    the reference's scales, zero norm scales), drawn from ``generator``,
    which must live on ``device``.  The draws differ from
    ``jax.random``'s; tests carry weights across with
    :func:`repro_torch.models.convert.from_reference_params`."""
    model = DecoderLM(cfg, device=device)
    with torch.no_grad():
        for name, p in model.named_parameters():
            std = _init_std(name, cfg)
            if std is not None:
                w = torch.randn(p.shape, generator=generator, device=p.device)
                p.copy_(w * std)
    return model


def init_cache(cfg: ModelConfig, batch: int, max_seq: int,
               device=None) -> list[dict]:
    """One ``{"k", "v"}`` cache per layer, of the model's dtype."""
    device = resolve_device(device)
    return [make_cache(cfg, spec.attn_window, batch, max_seq, pdtype(cfg),
                       device)
            for spec in cfg.block_specs()]


def _remat(fn, x: torch.Tensor) -> torch.Tensor:
    return checkpoint(fn, x, use_reentrant=False)


def _trunk(model: DecoderLM, x: torch.Tensor, rt: Runtime, *,
           positions: torch.Tensor, mode: str, caches: list | None,
           cache_len: int | None) -> torch.Tensor:
    def layers(lo: int, hi: int, x: torch.Tensor) -> torch.Tensor:
        for i in range(lo, hi):
            x = model.blocks[i](x, positions=positions, mode=mode, rt=rt,
                                cache=caches[i] if caches is not None else None,
                                cache_len=cache_len)
        return x

    if mode != "train" or rt.remat == "none":
        return model.final_norm(layers(0, len(model.blocks), x))

    period = len(model.cfg.layer_pattern())
    periods = model.cfg.num_periods()

    def one_period(t: int, x: torch.Tensor) -> torch.Tensor:
        return layers(t * period, (t + 1) * period, x)

    def remat_periods(lo: int, hi: int, x: torch.Tensor) -> torch.Tensor:
        for t in range(lo, hi):
            x = _remat(functools.partial(one_period, t), x)
        return x

    G = rt.scan_groups
    if G > 1 and periods % G == 0:
        # sqrt-memory remat: each group of periods keeps only its input
        # carry; its recompute remats period by period => peak ~ (G + P/G)
        # carries instead of P
        inner = periods // G
        for g in range(G):
            x = _remat(functools.partial(remat_periods, g * inner,
                                         (g + 1) * inner), x)
    else:
        x = remat_periods(0, periods, x)
    return model.final_norm(x)


def _positions(B: int, S: int, start: int, device) -> torch.Tensor:
    return (torch.arange(S, device=device) + start)[None].expand(B, S)


def forward_train(model: DecoderLM, tokens: torch.Tensor,
                  rt: Runtime) -> tuple[torch.Tensor, torch.Tensor]:
    """tokens (B, S) -> (hidden (B, S, d), aux loss); differentiable."""
    x = model.embed(tokens)
    B, S, _ = x.shape
    h = _trunk(model, x, rt, positions=_positions(B, S, 0, x.device),
               mode="train", caches=None, cache_len=None)
    return h, torch.zeros((), device=x.device)


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
    (B, S).  Returns (loss, aux), differentiable."""
    tokens = batch["tokens"]
    hidden, aux = forward_train(model, tokens, rt)
    targets = batch.get("labels", tokens)[:, 1:]
    mask = batch.get("loss_mask")
    mask = (torch.ones(targets.shape, device=targets.device)
            if mask is None else mask[:, 1:])
    lp = token_logprobs(model, hidden[:, :-1], targets, rt)
    loss = -torch.sum(lp * mask) / torch.clamp_min(torch.sum(mask), 1.0)
    return loss, aux


@torch.no_grad()
def prefill(model: DecoderLM, tokens: torch.Tensor, rt: Runtime,
            caches: list) -> tuple[torch.Tensor, list, int]:
    """Run the prompt through the flash kernel, filling ``caches`` from
    slot 0; returns (last-position logits (B, V) fp32, caches, S)."""
    x = model.embed(tokens)
    B, S, _ = x.shape
    h = _trunk(model, x, rt, positions=_positions(B, S, 0, x.device),
               mode="prefill", caches=caches, cache_len=0)
    return model.embed.logits(h[:, -1:])[:, 0], caches, S


@torch.no_grad()
def decode_step(model: DecoderLM, tokens: torch.Tensor, rt: Runtime,
                caches: list, cache_len: int) -> tuple[torch.Tensor, list, int]:
    """One token in (B, 1), its logits (B, V) out; ``cache_len`` is the
    number of valid cache positions before it."""
    x = model.embed(tokens)
    B = x.shape[0]
    h = _trunk(model, x, rt, positions=_positions(B, 1, cache_len, x.device),
               mode="decode", caches=caches, cache_len=cache_len)
    return model.embed.logits(h)[:, 0], caches, cache_len + 1
