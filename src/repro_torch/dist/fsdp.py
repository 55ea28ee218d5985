"""The parameter and optimizer-state slices of a model on one rank of a
mesh, and gather-on-use (PyTorch's FSDP idiom).

Each rank keeps exactly the slice of every parameter that
:func:`~repro_torch.dist.sharding.param_shardings` gives (the rule run on
the port's per-layer shapes), with one deliberate deviation: the
expert-parallel MoE's ``w_gate`` / ``w_in`` / ``w_out`` are E-sharded
over the model axis (each rank its ``E / tp`` experts, used where they
lie), where the widest-dim rule would split ``d`` or ``ff`` (the
reference reshards to ``P(model, None, None)`` inside its ``shard_map``).
AdamW's master / m / v are the slices :func:`zero_shardings` gives.

Inside :meth:`Sharded.gathered`, each block all-gathers its weights just
before it runs (forward hooks; the embedding and final norm for the whole
block), through :func:`~repro_torch.dist.comm.gather_on_use`, whose
backward reduce-scatters the gradient onto the slices.  Compute is not
partitioned: every rank runs the whole block on its data-parallel share
(model ranks on the same share repeat it), so numerics never depend on
the mesh, only memory and traffic do.

Gradients follow one convention: the global loss is the sum of every
rank's term, each rank backpropagating ``loss / world``, and every
collective's backward is its exact adjoint (:mod:`~repro_torch.dist.comm`).
A slice's gradient is then complete once summed over the ranks that
hold the same slice: :meth:`Sharded.reduce_grads` sums over the mesh axes
its spec does not use, reduce-scattering over the DP axes where the ZeRO
spec slices the state.
"""
from __future__ import annotations

import contextlib

import torch

from repro_torch.dist import comm
from repro_torch.dist.sharding import (_axes, axis_sizes, batch_sharding,
                                       gather_full, local_slice,
                                       param_shardings, zero_shardings)
from repro_torch.models.moe import MoE

EXPERT_LEAVES = ("w_gate", "w_in", "w_out")


def _spec_axes(spec: tuple) -> set:
    return {a for e in spec for a in _axes(e)}


class Sharded:
    """This rank's slices of ``model`` on ``mesh``: the parameters are cut
    in place (``p.data`` becomes the slice), so ``named_parameters()``
    gives the slices from then on.  ``dp_axes`` are the axes the batch is
    split over: the Runtime's ``data_axes()``, which its MoE blocks sum
    their aux statistics over."""

    def __init__(self, model, mesh, *, tp_axis: str = "model",
                 dp_axes: tuple):
        self.model, self.mesh = model, mesh
        self.dp = tuple(dp_axes)
        self.sizes = axis_sizes(mesh)
        self.world = 1
        for n in self.sizes.values():
            self.world *= n
        named = dict(model.named_parameters())
        self.shapes = {n: tuple(p.shape) for n, p in named.items()}
        specs = param_shardings(self.shapes, mesh)
        self.local: set[str] = set()     # used as sliced, never gathered
        if tp_axis in self.sizes:
            for prefix, mod in model.named_modules():
                if isinstance(mod, MoE):
                    for leaf in EXPERT_LEAVES:
                        n = f"{prefix}.{leaf}"
                        specs[n] = (tp_axis,) + (None,) * (len(self.shapes[n]) - 1)
                        self.local.add(n)
        self.specs = specs
        self.zero_specs = zero_shardings(specs, self.shapes, mesh)
        with torch.no_grad():
            for n, p in named.items():
                p.data = local_slice(p.data, specs[n], mesh).clone()

    # ------------------------------------------------------------------
    # gather-on-use
    # ------------------------------------------------------------------
    def _install(self, names: list[str]) -> None:
        for n in names:
            mod_name, attr = n.rsplit(".", 1)
            mod = self.model.get_submodule(mod_name)
            full = mod._parameters[attr]
            for d, e in enumerate(self.specs[n]):
                if e is not None:
                    full = comm.gather_on_use(full, self.mesh, _axes(e), d)
            mod.__dict__[attr] = full        # found before _parameters

    def _remove(self, names: list[str]) -> None:
        for n in names:
            mod_name, attr = n.rsplit(".", 1)
            self.model.get_submodule(mod_name).__dict__.pop(attr, None)

    @contextlib.contextmanager
    def gathered(self):
        """Run the model on whole weights: the embedding and final norm
        gathered for the block, each layer's weights gathered as the layer
        starts (again in a remat recompute) and dropped when it ends."""
        gather = [n for n, s in self.specs.items()
                  if n not in self.local and any(e is not None for e in s)]
        top = [n for n in gather if not n.startswith("blocks.")]
        hooks = []
        for i, blk in enumerate(self.model.blocks):
            mine = [n for n in gather if n.startswith(f"blocks.{i}.")]
            hooks.append(blk.register_forward_pre_hook(
                lambda m, a, mine=mine: self._install(mine)))
            hooks.append(blk.register_forward_hook(
                lambda m, a, o, mine=mine: self._remove(mine)))
        self._install(top)
        try:
            yield self.model
        finally:
            for h in hooks:
                h.remove()
            self._remove(top)

    # ------------------------------------------------------------------
    # data, gradients, optimizer state
    # ------------------------------------------------------------------
    def split_batch(self, batch: dict) -> dict:
        """This rank's share of a global batch: each leaf's leading axis
        over the DP axes (:func:`batch_sharding`; whole where it does not
        divide)."""
        out = {}
        for k, v in batch.items():
            spec = batch_sharding(self.mesh, v.dim(),
                                  v.shape[0] if v.dim() else None,
                                  dp_axes=self.dp)
            out[k] = local_slice(v, spec, self.mesh)
        return out

    def _zero_extra(self, name: str):
        """(dim, axes) the ZeRO spec slices beyond the parameter's spec."""
        for d, (p, z) in enumerate(zip(self.specs[name], self.zero_specs[name])):
            if p is None and z is not None:
                return d, _axes(z)
        return None

    def zero_views(self, params: dict) -> dict:
        """Each parameter slice's ZeRO part, as a view into it (AdamW's
        in-place write lands in the parameter)."""
        out = {}
        for n, p in params.items():
            extra = self._zero_extra(n)
            p = p.detach()
            if extra is not None:
                d, axes = extra
                step = p.shape[d] // comm.axis_size(self.mesh, axes)
                p = p.narrow(d, comm.axis_index(self.mesh, axes) * step, step)
            out[n] = p
        return out

    def reduce_grads(self, grads: dict) -> dict:
        """Complete each slice gradient: all-reduce (sum) over the mesh
        axes its parameter spec does not use, reduce-scatter over the DP
        axes its ZeRO spec adds; returns the ZeRO parts."""
        out = {}
        for n, g in grads.items():
            extra = self._zero_extra(n)
            used = _spec_axes(self.specs[n]) | set(extra[1] if extra else ())
            rest = tuple(a for a in self.sizes if a not in used)
            if rest:
                g = comm.all_reduce(g, self.mesh, rest)
            if extra is not None:
                g = comm.reduce_scatter(g, self.mesh, extra[1], dim=extra[0])
            out[n] = g
        return out

    def grad_norm(self, zgrads: dict) -> torch.Tensor:
        """The global norm of the whole gradient from the ZeRO parts: each
        part's square sum weighted by 1 / (ranks holding the same part),
        summed over every rank."""
        def copies(n: str) -> float:
            held = 1
            for a in _spec_axes(self.zero_specs[n]):
                held *= self.sizes[a]
            return held / self.world

        total = sum(torch.sum(g.float() * g.float()) * copies(n)
                    for n, g in zgrads.items())
        return torch.sqrt(comm.all_reduce(total, self.mesh, tuple(self.sizes)))

    @torch.no_grad()
    def refill(self, params: dict, views: dict) -> None:
        """After AdamW wrote each rank's ZeRO part: all-gather the parts
        back into the whole parameter slices."""
        for n, p in params.items():
            extra = self._zero_extra(n)
            if extra is not None:
                p.copy_(comm.all_gather(views[n], self.mesh, extra[1],
                                        dim=extra[0]))

    def full(self, leaf: torch.Tensor, name: str, zero: bool) -> torch.Tensor:
        """The whole leaf (a collective) from this rank's parameter slice
        (``zero`` False) or ZeRO part (True)."""
        spec = (self.zero_specs if zero else self.specs)[name]
        return gather_full(leaf.detach(), spec, self.mesh)

    def cut(self, full: torch.Tensor, name: str, zero: bool) -> torch.Tensor:
        """This rank's parameter slice or ZeRO part of a whole leaf."""
        spec = (self.zero_specs if zero else self.specs)[name]
        return local_slice(full, spec, self.mesh)

    def dp_reduce(self, x: torch.Tensor, op: str = "mean") -> torch.Tensor:
        """A scalar of this rank's data share, reduced over the DP axes."""
        return comm.all_reduce(x, self.mesh, self.dp, op) if self.dp else x
