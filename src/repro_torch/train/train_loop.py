"""Training loop (port of ``repro.train.train_loop``): the step factory
(gradient accumulation over microbatches), periodic atomic checkpointing,
automatic resume, preemption handling, and a step-time straggler
watchdog.

The loop is loss-function-agnostic: every model family plugs in a
``loss_fn(params, batch) -> (loss, aux)`` over a nest of dicts of tensors.
Gradients come from ``torch.autograd``: each step differentiates the loss
with respect to detached views of the parameters, so the caller's tensors
never carry a graph.  Nothing is compiled: the reference's ``jax.jit`` and
buffer donation have no counterpart (``donate`` is accepted and does
nothing; the update returns new tensors and the caller's old ones are
freed when it drops them).
"""

from __future__ import annotations

import dataclasses
import signal
import time
from typing import Any, Callable, Iterator, Optional

import torch

from repro_torch.train import checkpoint as CKPT
from repro_torch.train import optimizer as OPT


@dataclasses.dataclass
class TrainConfig:
    steps: int = 100
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 50
    keep_ckpts: int = 3
    log_every: int = 10
    microbatches: int = 1             # grad accumulation factor
    straggler_factor: float = 3.0     # watchdog: step > factor * median -> warn


def value_and_grad(loss_fn: Callable, params, *args):
    """``(loss, aux), grads`` of ``loss_fn(params, *args)`` with respect to
    every leaf of ``params`` (a nest of dicts of floating tensors), as
    ``jax.value_and_grad(loss_fn, has_aux=True)``; a leaf the loss does not
    reach gets a zero gradient.  Returns detached tensors."""
    leaves = [p.detach().requires_grad_() for p in OPT._leaves(params)]
    with torch.enable_grad():
        loss, aux = loss_fn(_rebuild(params, leaves), *args)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)]
    aux = {k: v.detach() if torch.is_tensor(v) else v
           for k, v in (aux or {}).items()}
    return (loss.detach(), aux), _rebuild(params, grads)


def _rebuild(tree, leaves: list):
    """``tree``'s structure with ``leaves`` in its leaf order."""
    it = iter(leaves)
    return OPT._map(lambda _: next(it), tree)


def _split(batch, microbatches: int) -> list:
    """The batch's leading axis cut into ``microbatches`` equal slices
    (views), as the reference's ``reshape((micro, B // micro, ...))``."""
    def cut(x, i):
        n = x.shape[0] // microbatches
        if n * microbatches != x.shape[0]:
            raise ValueError(f"a batch of {x.shape[0]} does not split into "
                             f"{microbatches} microbatches")
        return x[i * n:(i + 1) * n]

    return [{k: cut(v, i) for k, v in batch.items()}
            for i in range(microbatches)]


def _accumulate(grads_of: Callable, params, batch, microbatches: int):
    """(loss, grads) averaged over the batch's microbatches, the gradients
    accumulated in float32 (``acc + g / microbatches``) one microbatch at a
    time, as the reference's ``lax.scan``: the activations of one
    microbatch live at once."""
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    loss = None
    acc = OPT._map(zeros, params)
    for mb in _split(batch, microbatches):
        loss_i, grads_i = grads_of(params, mb)
        acc = OPT._map(lambda a, g: a + g / microbatches, acc, grads_i)
        loss = loss_i / microbatches if loss is None else (
            loss + loss_i / microbatches)
        del grads_i
    return loss, acc


def make_train_step(
    loss_fn: Callable,
    opt_cfg: OPT.OptConfig,
    microbatches: int = 1,
    donate: bool = True,
):
    """Build ``step(params, opt_state, batch) -> (params, state, metrics)``.

    With microbatches > 1 the leading batch axis is split and gradients
    are accumulated in float32, one microbatch's activations at a time.
    ``donate`` has no effect (see the module docstring).
    """
    del donate

    def grads_of(params, batch):
        (loss, _aux), grads = value_and_grad(loss_fn, params, batch)
        return loss, grads

    def step(params, opt_state, batch):
        if microbatches == 1:
            (loss, aux), grads = value_and_grad(loss_fn, params, batch)
        else:
            loss, grads = _accumulate(grads_of, params, batch, microbatches)
            aux = {}
        del aux
        params, opt_state, om = OPT.adamw_update(grads, opt_state, params,
                                                 opt_cfg)
        return params, opt_state, {"loss": loss, **om}

    return step


class PreemptionGuard:
    """SIGTERM -> set a flag; the loop checkpoints and exits cleanly.

    This is the cooperative-preemption contract on managed clusters
    (maintenance events deliver SIGTERM with a grace window).  The handler
    stays installed after ``train`` returns, as the reference's does; a
    caller that must keep its own SIGTERM handler restores it.
    """

    def __init__(self):
        self.preempted = False
        self._installed = False

    def install(self):
        if self._installed:
            return
        try:
            signal.signal(signal.SIGTERM, self._handler)
            self._installed = True
        except ValueError:
            pass  # non-main thread (tests): watchdog only

    def _handler(self, signum, frame):  # noqa: ARG002
        self.preempted = True


def train(
    loss_fn: Callable,
    params: Any,
    data_iter: Iterator,
    opt_cfg: OPT.OptConfig,
    cfg: TrainConfig,
    opt_state: Any = None,
    start_step: int = 0,
    hooks: Optional[list[Callable[[int, dict], None]]] = None,
):
    """Run the loop; returns (params, opt_state, history).

    Resume: if ``cfg.ckpt_dir`` holds a valid checkpoint, training state
    (params + optimizer + step) restores from it, onto the devices and
    dtypes of ``params`` and ``opt_state``, and the data iterator is
    expected to be positioned via its own ``start_step`` (see
    ``data.*.batch_iterator``): together they make restarts exact.
    """
    if opt_state is None:
        opt_state = OPT.adamw_init(params)

    step0 = start_step
    if cfg.ckpt_dir:
        restored, meta = CKPT.restore_latest(
            cfg.ckpt_dir, {"params": params, "opt": opt_state}
        )
        if restored is not None:
            params = restored["params"]
            opt_state = restored["opt"]
            step0 = meta["step"]
            print(f"[train] resumed from step {step0}")

    train_step = make_train_step(loss_fn, opt_cfg, cfg.microbatches)
    guard = PreemptionGuard()
    guard.install()

    history = []
    step_times = []
    for step in range(step0, cfg.steps):
        t0 = time.perf_counter()
        batch = next(data_iter)
        params, opt_state, metrics = train_step(params, opt_state, batch)
        dt = time.perf_counter() - t0
        step_times.append(dt)

        # straggler watchdog: flag anomalously slow steps
        if len(step_times) >= 8:
            med = sorted(step_times[-32:])[len(step_times[-32:]) // 2]
            if dt > cfg.straggler_factor * med:
                print(f"[train] straggler step {step}: {dt:.3f}s vs median "
                      f"{med:.3f}s")

        if step % cfg.log_every == 0 or step == cfg.steps - 1:
            m = {k: float(v) for k, v in metrics.items()}
            history.append({"step": step, **m, "sec": dt})
            for h in hooks or []:
                h(step, m)

        must_ckpt = cfg.ckpt_dir and (
            (step + 1) % cfg.ckpt_every == 0 or step == cfg.steps - 1
            or guard.preempted
        )
        if must_ckpt:
            CKPT.save(cfg.ckpt_dir, step + 1,
                      {"params": params, "opt": opt_state})
            CKPT.retain(cfg.ckpt_dir, cfg.keep_ckpts)
        if guard.preempted:
            print(f"[train] preempted at step {step}; checkpointed and "
                  "exiting")
            break

    return params, opt_state, history
