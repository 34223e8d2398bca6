"""Production training loop: checkpoint/restart, failure injection,
straggler mitigation, deterministic data resume (the port of the JAX
package's ``train/loop.py``).

The loop is structured as supervisor + worker (both in-process here; on a
real fleet the supervisor is the job scheduler): ``run_with_restarts``
restarts the step loop from the newest valid checkpoint whenever a
(simulated or real) fault surfaces, which is the restart path a node
failure would take at scale.

The port's train step updates the model and the optimizer state in place
(``ModelBundle.make_train_step``), so the loop checkpoints
``{"params": interop.param_tree(model), "opt": opt_state}`` on the
reference's on-disk format, and a restore copies the checkpoint back into
those tensors. Where the reference's immutable parameters let a restart
without a checkpoint begin again from the initial state, the supervisor
keeps a host copy of that state when faults are scheduled
(docs/port.md §train).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable

import numpy as np
import torch
from torch import nn

from repro_torch.interop import Stacked, param_tree

from . import checkpoint as ckpt
from .data import DataConfig, Prefetcher, make_source


class FaultInjected(RuntimeError):
    pass


@dataclass
class LoopConfig:
    total_steps: int
    ckpt_dir: str
    ckpt_every: int = 50
    log_every: int = 10
    # fault tolerance knobs
    max_restarts: int = 10
    fail_at_steps: tuple = ()  # inject a fault right after these steps
    # straggler mitigation: steps slower than `straggler_factor` x the
    # running median are logged and counted; persistent stragglers would
    # trigger re-dispatch on a real fleet (here: recorded + surfaced).
    straggler_factor: float = 3.0


@dataclass
class LoopState:
    step: int = 0
    restarts: int = 0
    straggler_events: int = 0
    losses: list = field(default_factory=list)
    step_times: list = field(default_factory=list)


def _tree(params, opt_state) -> dict:
    """The checkpointed tree: a model's parameters as the reference's
    tree (a tree of tensors passes as it is) and the optimizer state."""
    if isinstance(params, nn.Module):
        params = param_tree(params)
    return {"params": params, "opt": opt_state}


@torch.no_grad()
def _assign(dst, src) -> None:
    """Copy every leaf of ``src`` into the same leaf of ``dst``, in
    place."""
    for d, s in zip(ckpt.tree_flatten(dst)[0], ckpt.tree_flatten(src)[0],
                    strict=True):
        d.copy_(s)


def _host_copy(tree):
    return ckpt.tree_map(
        lambda x: (x.stack() if isinstance(x, Stacked) else x.detach()).to(
            "cpu", copy=True), tree)


def run(
    cfg: LoopConfig,
    data_cfg: DataConfig,
    train_step: Callable,  # (params, opt_state, batch) -> (params, opt, metrics)
    params: Any,
    opt_state: Any,
    log: Callable[[str], None] = print,
    initial: Any = None,
) -> tuple[Any, Any, LoopState]:
    """One worker incarnation: resume from checkpoint (or from
    ``initial``, a host copy of the starting tree, when there is none),
    run to completion or fault."""
    state = LoopState()
    tree = _tree(params, opt_state)
    restored = ckpt.restore_latest(cfg.ckpt_dir, tree)
    if restored is not None:
        start_step, got, extra = restored
        _assign(tree, got)
        del got
        state.step = start_step
        log(f"[loop] restored step {start_step} from {cfg.ckpt_dir}")
    elif initial is not None:
        _assign(tree, initial)

    saver = ckpt.AsyncCheckpointer(cfg.ckpt_dir)
    source = make_source(data_cfg)
    prefetch = Prefetcher(source, start_step=state.step)
    times: list[float] = []
    try:
        while state.step < cfg.total_steps:
            step_no, batch = prefetch.next()
            assert step_no == state.step, "data pipeline out of sync"
            t0 = time.perf_counter()
            params, opt_state, metrics = train_step(params, opt_state, batch)
            loss = float(metrics["loss"])
            dt = time.perf_counter() - t0
            times.append(dt)
            state.losses.append(loss)
            state.step_times.append(dt)
            if len(times) > 5:
                med = float(np.median(times[-50:]))
                if dt > cfg.straggler_factor * med:
                    state.straggler_events += 1
                    log(f"[loop] straggler step {state.step}: "
                        f"{dt:.3f}s vs median {med:.3f}s")
            state.step += 1
            if state.step % cfg.log_every == 0:
                log(f"[loop] step {state.step} loss {loss:.4f} "
                    f"({dt*1e3:.0f} ms)")
            if state.step % cfg.ckpt_every == 0:
                saver.save(state.step, _tree(params, opt_state))
            if state.step in cfg.fail_at_steps:
                raise FaultInjected(f"injected fault after step {state.step}")
        saver.save(state.step, _tree(params, opt_state))
        saver.wait()
    finally:
        prefetch.close()
        # Drain any in-flight async write before this incarnation exits: a
        # real process death takes its writer with it, but here the "crash"
        # is an exception and the daemon thread would survive to race the
        # restarted worker on the same step_XXXXXXXX.tmp directory.
        try:
            saver.wait()
        except Exception:
            pass  # torn-write recovery is restore_latest's job
    return params, opt_state, state


def run_with_restarts(
    cfg: LoopConfig,
    data_cfg: DataConfig,
    train_step: Callable,
    params: Any,
    opt_state: Any,
    log: Callable[[str], None] = print,
) -> tuple[Any, Any, LoopState]:
    """Supervisor: restart the worker from checkpoint on faults."""
    total = LoopState()
    fail_at = set(cfg.fail_at_steps)
    initial = None
    if fail_at and _latest_step(cfg.ckpt_dir) == 0:
        initial = _host_copy(_tree(params, opt_state))
    for attempt in range(cfg.max_restarts + 1):
        try:
            params, opt_state, st = run(
                cfg, data_cfg, train_step, params, opt_state, log, initial
            )
            total.step = st.step
            total.losses.extend(st.losses)
            total.step_times.extend(st.step_times)
            total.straggler_events += st.straggler_events
            return params, opt_state, total
        except FaultInjected as e:
            log(f"[supervisor] fault: {e}; restarting "
                f"({attempt + 1}/{cfg.max_restarts})")
            total.restarts += 1
            # this fault fired; don't fire it again after restart
            fail_at -= {min(fail_at)} if fail_at else set()
            cfg = LoopConfig(**{**cfg.__dict__, "fail_at_steps": tuple(fail_at)})
    raise RuntimeError("exceeded max_restarts")


def _latest_step(ckpt_dir: str) -> int:
    steps = ckpt.available_steps(ckpt_dir)
    return steps[-1] if steps else 0
