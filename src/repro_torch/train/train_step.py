"""Train step: loss, gradients (with remat and microbatch accumulation),
optimizer update.

PyTorch counterpart of `repro.train.train_step`. The model owns its
parameters, so a `TrainState` pairs the model with the optimizer state,
and a step updates both in place. Gradients accumulate over `microbatches`
consecutive slices of the batch in f32 (the reference's `lax.scan`
branch); with one microbatch they stay in the parameter dtype, as
`jax.value_and_grad` gives them.

A state placed on a mesh by `launch.sharding` carries its `layout`: each
rank then holds only its block of every sharded parameter, m and v. On
the split plan (a model of any family: `launch.sharding.SplitPlan`,
installed on the model by `place`) the step never gathers a whole model:
the forward and backward of this rank's rows run its heads, ff columns
(or experts and shared-expert columns, or recurrent heads and channels)
and vocab block, each layer
gathered over "data" as it runs; the loss is
`vocab_cross_entropy` of the rank's vocab block; each microbatch's
gradient blocks, already reduce-scattered by the backward, accumulate into
f32 blocks (`Layout.sum_blocks` sums what remains over the batch axes). On
the gathered plan (`Layout._plan = "gathered"`) the step gathers the whole
parameters, runs this rank's rows, reduce-scatters each gradient's batch
mean into this rank's block and shards the parameters back. Either way it
takes the global norm from the blocks and updates only the blocks.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from .optimizer import OptimizerConfig, adamw_update, init_opt_state


@dataclasses.dataclass
class TrainState:
    model: torch.nn.Module
    opt: dict
    layout: object = None      # launch.sharding.Layout of a sharded state

    @property
    def step(self) -> torch.Tensor:
        return self.opt["step"]

    @property
    def params(self) -> dict:
        """name → parameter, the names of `model.net.named_parameters()`."""
        return dict(self.model.net.named_parameters())


def init_state(model) -> TrainState:
    """The model (already initialised by `models.build`) with zero moments."""
    state = TrainState(model=model, opt={})
    state.opt = init_opt_state(state.params)
    return state


def cross_entropy(logits, labels):
    """logits [B, S, V] f32; labels [B, S] integer. Mean NLL."""
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.take_along_dim(logits, labels[..., None], dim=-1)[..., 0]
    return torch.mean(logz - gold)


def make_loss_fn(model, *, impl="ref", remat=True):
    """loss_fn(batch) → (ce + aux, {"ce", "aux"}); on a split plan the
    cross entropy of the rank's vocab block (`SplitPlan.cross_entropy`)."""
    def loss_fn(batch):
        logits, aux = model(batch, impl=impl, remat=remat)
        plan = getattr(model.net, "plan", None)
        ce = (cross_entropy if plan is None else plan.cross_entropy)(logits, batch["labels"])
        return ce + aux, {"ce": ce, "aux": aux}
    return loss_fn


def make_train_step(model, oc: OptimizerConfig, *, microbatches: int = 1,
                    impl="ref", remat=True) -> Callable:
    """Returns train_step(state, batch) → (state, metrics {"loss", "ce",
    "aux", "lr", "grad_norm"}: 0-d tensors); the state is updated in place
    and returned. The batch's leading dim must divide by `microbatches`."""
    loss_fn = make_loss_fn(model, impl=impl, remat=remat)

    def value_and_grad(params, batch):
        loss, parts = loss_fn(batch)
        grads = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
        grads = {n: torch.zeros_like(p) if g is None else g
                 for (n, p), g in zip(params.items(), grads)}
        return loss.detach(), {k: torch.as_tensor(v).detach() for k, v in parts.items()}, grads

    def train_step(state: TrainState, batch: dict):
        params, layout = state.params, state.layout
        plan = getattr(model.net, "plan", None)
        if plan is not None and plan.layout is not layout:
            raise ValueError("the model's split plan is not the state's layout: place the "
                             "state with launch.sharding.place")
        if layout is not None and plan is None:
            layout.gather_params(params)
        if microbatches == 1 and plan is None:
            loss, parts, grads = value_and_grad(params, batch)
        else:
            rows = next(iter(batch.values())).shape[0]
            if rows % microbatches:
                raise ValueError(f"a batch of {rows} rows does not split into "
                                 f"{microbatches} microbatches")
            n = rows // microbatches
            grads = {name: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                     for name, p in params.items()}
            loss = ce = 0.0
            for i in range(microbatches):
                l, pt, g = value_and_grad(params, {k: v[i * n:(i + 1) * n]
                                                   for k, v in batch.items()})
                for name, gi in g.items():
                    grads[name].add_(gi)
                del g
                loss, ce = loss + l, ce + pt["ce"]
            for g in grads.values():
                g.div_(microbatches)
            loss = loss / microbatches
            parts = {"ce": ce / microbatches, "aux": loss - ce / microbatches}
        gnorm = None
        if plan is not None:
            grads = layout.sum_blocks(grads)
        elif layout is not None:
            layout.shard_params(params)
            grads = layout.reduce_grads(grads)
        if layout is not None:
            gnorm = layout.global_norm(grads)
            loss, parts = layout.mean(loss), {k: layout.mean(v) for k, v in parts.items()}
        _, _, om = adamw_update(oc, params, grads, state.opt, grad_norm=gnorm)
        return state, {"loss": loss, **parts, **om}

    return train_step
