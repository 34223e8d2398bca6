"""A language model's training step through the port's normal path, for a
configuration of app ``lm_train`` (any architecture the port registers).

The configuration's file names the port's architecture (``arch``) and
states the sizes it runs at: ``configs.get_arch(arch)`` with those keys
replaced (:func:`arch_config`) goes to ``registry.build``, whose
``make_train_step`` takes ``train.optimizer.AdamWConfig`` at the file's
``optimizer`` settings and ``init_state``'s moments. The weights are the
benchmark's, drawn from the seed by the configuration's plain reference
(``reference``: ``leaf_specs`` and ``draw``) into a model the port builds
on ``meta`` and moves to the card empty. The batches are
:func:`bench.loads.token_batch` of the seed, one a step.

The reference module also states what it computes: ``ARCH`` (fields of
the port's ``ArchConfig``) and ``MOE`` (of its ``MoEConfig``), which
:func:`arch_config` holds the port's configuration to.

:meth:`System.checked_steps` runs the first ``checked_steps`` steps of
the mix: they warm up every shape the window runs, and the reference
follows them. From them the system keeps, on the card and with no wait,
each step's loss, each leaf's gradient as the optimizer got it at the
first step (the norm of its first moment after that step, over ``1 −
b1`` and the step's clipping scale), and each leaf's change ``‖p − p0‖``
after the last of them.

:func:`plant` puts a fault into the port for the calibration and the
tests (:data:`FAULTS`).
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib
import time
from pathlib import Path

import torch

from bench.loads import token_batch

#: Faults :func:`plant` puts into the port: the second expert of every
#: token left out (``top1``), the loss over half of the batch
#: (``half_batch``), a step that leaves parameters and optimizer state
#: as they were (``unchanged``).
FAULTS = ("top1", "half_batch", "unchanged")

#: Keys of a configuration's file that replace the port's ``ArchConfig``
#: fields.
ARCH_KEYS = ("n_layers", "d_model", "n_heads", "n_kv_heads", "head_dim",
             "vocab", "sliding_window", "rope_theta", "dtype")


def reference(config: dict):
    """The configuration's plain reference module."""
    return importlib.import_module(
        f"bench.reference.{Path(config['reference']).stem}")


def arch_config(config: dict):
    """The port's ``ArchConfig`` of ``config``: its ``arch`` with the
    file's sizes; ``ValueError`` where the port's configuration computes
    something the reference does not."""
    from repro_torch.configs import get_arch

    base = get_arch(config["arch"])
    ref = reference(config)
    wrong = {k: getattr(base, k) for k, v in ref.ARCH.items()
             if getattr(base, k) != v}
    wrong.update({f"moe.{k}": getattr(base.moe, k, None)
                  for k, v in getattr(ref, "MOE", {}).items()
                  if getattr(base.moe, k, None) != v})
    if wrong:
        raise ValueError(f"{config['arch']}: the port computes {wrong}, "
                         f"which {config['reference']} does not")
    fields = {k: config[k] for k in ARCH_KEYS}
    if "moe" in config:
        fields["moe"] = dataclasses.replace(base.moe, **config["moe"])
    return dataclasses.replace(base, **fields)


def named_leaves(tree, prefix: str = "") -> dict:
    """``{dotted name: leaf}`` of a nested dict of leaves."""
    if not isinstance(tree, dict):
        return {prefix[:-1]: tree}
    out = {}
    for key, sub in tree.items():
        out.update(named_leaves(sub, f"{prefix}{key}."))
    return out


class System:
    """The port's model, optimizer state and train step for one run."""

    def __init__(self, config: dict, mix: dict, device, seed: int):
        from repro_torch.interop import param_tree
        from repro_torch.models import registry
        from repro_torch.train.optimizer import AdamWConfig, init_state

        self.config, self.mix, self.seed = config, mix, int(seed)
        self.device = torch.device(device)
        self.phases, self._t = {}, time.perf_counter()
        self.ref = reference(config)
        self.cfg = arch_config(config)
        bundle = registry.build(self.cfg, device=self.device)
        self.model = registry.build(self.cfg, device="meta").init()
        self.model.to_empty(device=self.device)
        self.leaves = named_leaves(param_tree(self.model))
        self.specs = self.ref.leaf_specs(config)
        theirs = {name: (tuple(x.shape), x.dtype)
                  for name, x in self.leaves.items()}
        ours = {s[0]: (tuple(s[1]), s[2]) for s in self.specs}
        if theirs != ours:
            raise ValueError(f"the port's leaves {theirs} are not the "
                             f"reference's {ours}")
        self._mark("build")
        self._load()
        self._mark("weights")
        self.opt_cfg = AdamWConfig(**config["optimizer"])
        self.opt = init_state(self.opt_cfg, param_tree(self.model))
        self.train_step = bundle.make_train_step(self.opt_cfg)
        self.tokens_per_step = int(mix["batch"]) * int(mix["seq"])
        self.k = 0
        self._mark("optimizer")

    def _mark(self, phase: str) -> None:
        """Seconds of set-up ``phase`` since the last mark (the card's
        work included)."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        now = time.perf_counter()
        self.phases[phase] = now - self._t
        self._t = now

    @torch.no_grad()
    def _load(self) -> None:
        for i, spec in enumerate(self.specs):
            self.leaves[spec[0]].copy_(
                self.ref.draw(spec, self.seed, i, self.device))

    def batch(self, k: int) -> dict:
        return token_batch(self.mix, self.config["vocab"], self.seed, k)

    def step(self) -> dict:
        """One step of the port's train step on the next batch."""
        batch = self.batch(self.k)
        self.k += 1
        self.model, self.opt, metrics = self.train_step(self.model,
                                                        self.opt, batch)
        return metrics

    def checked_steps(self, spans) -> None:
        """The mix's first ``checked_steps`` steps, and what the check
        compares of them, kept on the card."""
        losses = []
        for i in range(int(self.mix["checked_steps"])):
            with spans("train.step"):
                metrics = self.step()
            losses.append(metrics["loss"])
            if i == 0:
                self.grad_norm = self._first_gradient(metrics["grad_norm"])
            self._mark(f"step{i + 1}")
        self.loss = torch.stack(losses)
        self.change_norm = self._change()
        self._mark("change")

    @torch.no_grad()
    def _first_gradient(self, gnorm) -> torch.Tensor:
        """Each leaf's gradient norm as the optimizer got it, from its
        first moment after one step: ``m = (1 − b1) · s · g``, ``s`` the
        clipping scale of the step's reported global norm."""
        c = self.opt_cfg
        scale = torch.clamp(c.clip_norm / torch.clamp(gnorm, min=1e-9),
                            max=1.0)
        m = named_leaves(self.opt["m"])
        return torch.stack([torch.linalg.vector_norm(m[s[0]].float())
                            for s in self.specs]) / ((1 - c.b1) * scale)

    @torch.no_grad()
    def _change(self) -> torch.Tensor:
        """Each leaf's ``‖p − p0‖``, ``p0`` drawn again from the seed."""
        from repro_torch.interop import leaf_parts

        out = []
        for i, spec in enumerate(self.specs):
            p0 = self.ref.draw(spec, self.seed, i, self.device)
            parts = leaf_parts(self.leaves[spec[0]])
            if len(parts) > 1:
                sq = sum((x.float() - p0[j]).square().sum()
                         for j, x in enumerate(parts))
            else:
                sq = (parts[0].float() - p0).square().sum()
            out.append(sq.sqrt())
            del p0
        return torch.stack(out)

    def readings(self) -> dict:
        """The kept numbers of the checked steps, as the reference's
        ``train`` returns its own (waits for the card)."""
        names = [s[0] for s in self.specs]
        return {"loss": self.loss.tolist(),
                "grad_norm": dict(zip(names, self.grad_norm.tolist())),
                "change_norm": dict(zip(names, self.change_norm.tolist()))}

    def free(self) -> None:
        """Drop the model, the optimizer state and the train step."""
        del self.model, self.opt, self.train_step, self.leaves


def build(config: dict, mix: dict, device, seed: int) -> System:
    return System(config, mix, device, seed)


@contextlib.contextmanager
def plant(fault: str):
    """The port with ``fault`` (one of :data:`FAULTS`) planted, for
    systems built inside the block."""
    from repro_torch.models import layers, transformer
    from repro_torch.train import optimizer

    if fault == "top1":
        real_router = layers.moe_router

        def moe_router(p, xt, cfg):
            gates, idx = real_router(p, xt, cfg)
            first = torch.arange(gates.shape[-1], device=gates.device) == 0
            return gates * first, idx

        target = (layers, "moe_router", moe_router)
    elif fault == "half_batch":
        real_loss = transformer.lm_loss

        def lm_loss(model, batch, **kw):
            return real_loss(model, {k: v[:v.shape[0] // 2]
                                     for k, v in batch.items()}, **kw)

        target = (transformer, "lm_loss", lm_loss)
    elif fault == "unchanged":
        def apply_updates(cfg, params, grads, state):
            return params, state, {"grad_norm": torch.zeros(()),
                                   "lr": torch.zeros(())}

        target = (optimizer, "apply_updates", apply_updates)
    else:
        raise ValueError(f"unknown fault {fault!r}")
    module, name, fn = target
    real = getattr(module, name)
    setattr(module, name, fn)
    try:
        yield
    finally:
        setattr(module, name, real)
