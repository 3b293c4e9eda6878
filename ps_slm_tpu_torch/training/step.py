"""The training and eval steps of the TASU model.

Counterpart of ``ps_slm_tpu/training/step.py``: forward (the model's
dtype) -> backward into the trainable parameters -> AdamW with the
warmup-cosine learning rate.  The JAX step is one jitted program with mesh
shardings; here it runs eagerly, on one device or, once
``parallel.mesh.shard_params`` has set ``model.mesh``, as this process's
part of a mesh: the batch is its block of the global batch, the loss its
share of the global mean (``models/tasu.py::forward``), the gradients are
summed over the mesh (``Parallel.sync_grads``) before AdamW steps on the
local shards, and the metrics come back as the global batch's on every
process.  Draws given to a call (``draws``, ``lora_masks``) are the global
batch's, cut to the process's rows.

On CUDA tensors every norm and attention of the path runs through the
port's kernels, forward and backward (``ops/norms.py``,
``ops/flash_attention.py``); the frozen encoder builds no autograd graph,
so its kernels run forward only.

``train_config.remat`` acts through the model, whose factory sets it
(``models/tasu.py::model_factory``: the blocks are recomputed in the
backward); ``gradient_accumulation_steps`` > 1 accumulates with optax.MultiSteps
semantics (``training/train_state.py::MultiSteps``).  ``TrainStep.step``
counts micro-steps, as the JAX ``TrainState.step`` does.

Randomness (the text-only CPS noise, the front end's dither and
SpecAugment, LoRA dropout) comes from one ``torch.Generator`` on the step's device,
seeded with ``train_config.seed`` and drawn from in sequence.  The JAX
step folds the step count into a fixed key instead, so its resume needs no
RNG state; here :meth:`TrainStep.state_dict` carries the generator's state
(with the step, the optimizer and the accumulated gradients), so a resumed
run draws what the uninterrupted one would have, and one generator stays
what a captured CUDA graph would own.
The eval step draws from a generator seeded 0 on every call, a fixed key
per call as the JAX eval's ``PRNGKey(0)``.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Union

import torch

from ps_slm_tpu_torch._build import resolve_device
from ps_slm_tpu_torch.models import tasu
from ps_slm_tpu_torch.ops.fbank import FrontendDraws
from ps_slm_tpu_torch.ops.pseudo_posterior import NoiseDraws
from ps_slm_tpu_torch.training.train_state import MultiSteps, build_optimizer, warmup_cosine
from ps_slm_tpu_torch.utils.profiler import span

Metrics = Dict[str, torch.Tensor]


def _metrics(model: tasu.TasuModel, loss: torch.Tensor, aux) -> Metrics:
    """The step's metrics; under a mesh each process's shares of the loss
    and the accuracy summed into the global batch's."""
    acc = aux["acc"]
    if model.mesh is not None:
        loss, acc = model.mesh.batch_sum(loss), model.mesh.batch_sum(acc)
    return {"loss": loss, "acc": acc, "ntokens": aux["ntokens"]}


def _on_device(model: tasu.TasuModel, device) -> torch.device:
    dev = resolve_device(device)
    model_dev = next(model.parameters()).device
    if model_dev != dev:
        raise ValueError(f"the model is on {model_dev}, the step was asked for {dev}")
    return dev


class TrainStep:
    """``batch -> {"loss", "acc", "ntokens"}``, one micro-step per call.

    Holds the optimizer (state for the trainable parameters only), the
    accumulation (``accum``, which sets the scheduled learning rate), the
    micro-step count and the generator; the metrics are the forward's,
    before the update, as device tensors (no host sync).  ``draws`` and
    ``lora_masks`` (LoRA dropout's keep masks, a dict per layer) replace
    the generator's draws for one call (tests feed the JAX step's).

    Spans (``utils/profiler.py``): ``step`` around the call, holding the
    model's ``front_half``, ``llm`` and ``loss``, then ``backward``,
    ``grad_sync`` under a mesh, and ``optimizer`` (the zeroing, and the
    gradient fill with AdamW's step).
    """

    def __init__(self, model: tasu.TasuModel, train_config, device):
        self.model = model
        self.device = device
        self.trainable = tasu.trainable_mask(model, train_config)
        if model.mesh is not None:
            self.trainable = model.mesh.held(model, self.trainable)
        params = dict(model.named_parameters())
        self.optimizer = build_optimizer(
            (params[n] for n in self.trainable), train_config
        )
        self.accum = MultiSteps(
            self.optimizer,
            warmup_cosine(train_config.lr, train_config.warmup_steps, train_config.total_steps),
            train_config.gradient_accumulation_steps,
        )
        self.step = 0
        self.generator = torch.Generator(device=device).manual_seed(train_config.seed)

    def __call__(
        self, batch: Dict[str, torch.Tensor],
        draws: Optional[Union[NoiseDraws, FrontendDraws]] = None,
        lora_masks: Optional[List[Dict[str, torch.Tensor]]] = None,
    ) -> Metrics:
        with span("step"):
            batch = {k: v.to(self.device) for k, v in batch.items()}
            mesh = self.model.mesh
            if mesh is not None:
                draws, lora_masks = mesh.local_rows(draws), mesh.local_rows(lora_masks)
            with span("optimizer"):
                self.optimizer.zero_grad(set_to_none=True)
            loss, aux = self.model(
                batch, train=True, generator=self.generator, draws=draws, lora_masks=lora_masks,
            )
            if loss.requires_grad:
                with span("backward"):
                    loss.backward()
            if mesh is not None:
                with span("grad_sync"):
                    mesh.sync_grads(self.model)
            with span("optimizer"):
                for p in self.accum.params:
                    if p.grad is None:
                        # a trainable parameter the loss does not reach (voca_trans'
                        # top1_emb) gets a zero gradient, as under jax.grad: AdamW
                        # then still decays it
                        p.grad = torch.zeros_like(p)
                self.accum.step()
            self.step += 1
            return _metrics(self.model, loss.detach(), aux)

    def state_dict(self) -> Dict:
        """What an exact resume needs besides the parameters: the
        micro-step count, AdamW's state, the accumulation and the
        generator's state."""
        return {"step": self.step, "accum": self.accum.state_dict(),
                "generator": self.generator.get_state()}

    def load_state_dict(self, state: Dict) -> None:
        self.step = state["step"]
        self.accum.load_state_dict(state["accum"])
        self.generator.set_state(state["generator"])
        mesh = self.model.mesh
        if mesh is not None:
            # AdamW's moments and the accumulation back in their
            # parameters' layouts (the saved state holds local shards)
            for p in self.accum.params:
                st = self.optimizer.state.get(p, {})
                for k, v in st.items():
                    if torch.is_tensor(v) and v.dim() > 0:
                        st[k] = mesh.to_param_layout(v, p)
            if self.accum.acc is not None:
                self.accum.acc = [mesh.to_param_layout(a, p)
                                  for a, p in zip(self.accum.acc, self.accum.params)]


def make_train_step(model: tasu.TasuModel, train_config, *, device="cuda") -> TrainStep:
    """The training step of ``model`` (which must already be on ``device``)
    under ``train_config``'s freeze flags, optimizer, schedule and gradient
    accumulation (remat is the model's own, set by its factory)."""
    return TrainStep(model, train_config, _on_device(model, device))


def make_eval_step(model: tasu.TasuModel, *, device="cuda"):
    """``batch -> {"loss", "acc", "ntokens"}`` with no gradient
    (``train=False``); the text-only noise draws from a generator seeded 0
    on every call."""
    dev = _on_device(model, device)

    @torch.no_grad()
    def eval_step(batch: Dict[str, torch.Tensor]) -> Metrics:
        batch = {k: v.to(dev) for k, v in batch.items()}
        generator = torch.Generator(device=dev).manual_seed(0)
        loss, aux = model(batch, train=False, generator=generator)
        return _metrics(model, loss, aux)

    return eval_step
