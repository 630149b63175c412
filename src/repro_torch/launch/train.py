"""Flow-matching backbone trainer (the paper's training substrate, eq. 56).

Port of ``repro.launch.train``:

  PYTHONPATH=src python -m repro_torch.launch.train --arch yi-6b --smoke \
      --steps 50 --batch 8 --seq 64 --ckpt-dir build/ckpt --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --arch yi-6b \
      --steps 10 --batch 8 --seq 64

One step is the reference's ``train_step``: ``models.model.cfm_loss`` on the
step's synthetic batch, the gradient of every param leaf (a zero one where
the loss does not reach a leaf, as ``jax.grad`` gives), and AdamW (weight
decay 0.01, the gradient clipped to norm 1.0) at the rate
``warmup_cosine(lr, max(steps // 10, 1), steps)`` read at Adam's count
before the step counts it, so step 0 runs at rate 0, as the reference's
does. The rates are computed up front on the host (``schedule_table``).

The step runs as one program (``serving/programs.py::ProgramCache``): on the
card the first step is the capture's warm-up and every later one replays a
CUDA graph, the host copying in the step's tokens and noise first; on the
CPU, and under ``programs.disabled()``, it runs eagerly. The params, Adam's
moments and its step keep their addresses, and Adam writes them in place a
slice at a time (``optim.adam_update_``). The gradient is taken of each
layer's view of a stacked leaf (``models.model.unbind_layers``) and handed
to Adam as rows: a stacked copy would hold every layer's gradient twice at
its peak, which at yi-6b's full depth leaves the graph no room on the card.
The noise of a step (``CFMNoise``) comes from one ``torch.Generator``
seeded with ``--seed``, the one that drew the weights, or from
``noise_source(step)`` (tests feed the reference's threefry draws through
it).

``--ckpt-dir`` resumes as the reference does: the params only are restored
from the latest checkpoint there, and Adam starts again from zero (its
moments, its count and so its rate schedule). A resumed run draws no
weights: the checkpoint restores into ``models.model.param_template``, so
the params are on the device once, and the noise generator starts at the
seed. Checkpoints are written every
``--ckpt-every`` steps by the port's checkpointer, in the reference's
format, so either package restores the other's. ``--layers N`` cuts the
depth, the width unchanged. On the card a smoke config's 32-wide attention
heads widen to 64, the flash kernel's narrowest (``configs.for_device``).

Every family trains on the card, each kernel of its forward differentiated
by a backward kernel (flash attention at head dims 64, 80 and 128,
``gla_scan``); a configuration whose params, gradients and f32 moments alone
exceed the card's free memory is refused. Nothing falls back to the CPU.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Callable, Optional

import torch

from repro_torch import resolve_device
from repro_torch.checkpoint import checkpointer
from repro_torch.configs import ARCHS, for_device, get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.core.schedulers import Scheduler, get_scheduler
from repro_torch.data.synthetic import DataConfig, SyntheticTokens
from repro_torch.models import model as M
from repro_torch.models.model import CFMNoise, draw_cfm_noise
from repro_torch.optim.adam import (
    AdamState,
    adam_init,
    adam_update_,
    tree_leaves,
    tree_map,
    tree_unflatten,
)
from repro_torch.optim.schedule import schedule_table, warmup_cosine
from repro_torch.serving.programs import ProgramCache

Tensor = torch.Tensor


def make_train_step(cfg: ModelConfig, sched: Scheduler, rates: Tensor, *,
                    grad_clip: float = 1.0):
    """The reference's ``train_step``, in place: ``train_step(params, opt,
    batch, noise)`` takes one AdamW step on ``params`` and ``opt`` at the rate
    ``rates[opt.step]`` (gathered on the device) and returns the loss (0-d)."""

    def train_step(params: dict, opt: AdamState, batch: dict, noise: CFMNoise) -> Tensor:
        # each stacked leaf enters as its layers' views, and the gradient is
        # taken of each view: a layer's gradient is its own tensor, written
        # once, and Adam takes them as rows (no stacked copy of the gradients)
        live = M.unbind_layers(tree_map(lambda p: p.detach().requires_grad_(True), params))
        loss = M.cfm_loss(live, cfg, batch, sched, noise=noise)
        leaves = tree_leaves(live)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        # a leaf the loss does not reach (lm_head) takes a zero gradient, as a
        # view of one zero: no tensor of its size is written
        grads = [torch.zeros((), dtype=p.dtype, device=p.device).expand_as(p) if g is None
                 else g for p, g in zip(leaves, grads)]
        lr = rates.index_select(0, opt.step.reshape(1)).reshape(())
        with torch.no_grad():
            adam_update_(tree_unflatten(live, grads), opt, params, lr, weight_decay=0.01,
                         grad_clip_norm=grad_clip)
        return loss.detach()

    return train_step


class Trainer:
    """One run's params, AdamW state and rate table, and its step as one
    program. ``step(batch, noise)`` returns the loss (0-d, on the device)."""

    def __init__(self, cfg: ModelConfig, sched: Scheduler, params: dict, *, steps: int,
                 lr: float, device):
        self.device = torch.device(device)
        self.params = params
        self.opt = adam_init(params)
        rates = schedule_table(warmup_cosine(lr, max(steps // 10, 1), steps), steps,
                               self.device)
        self._train_step = make_train_step(cfg, sched, rates)
        self.programs = ProgramCache(self.device)
        self._state = tuple(tree_leaves((params, self.opt)))

    def step(self, batch: dict, noise: CFMNoise) -> Tensor:
        keys = tuple(sorted(batch))

        def run(*inputs):
            return self._train_step(self.params, self.opt, dict(zip(keys, inputs)),
                                    CFMNoise(*inputs[len(keys):]))

        return self.programs(("train_step", keys), run,
                             inputs=tuple(batch[k] for k in keys) + tuple(noise),
                             state=self._state)


@dataclasses.dataclass
class TrainRun:
    """What ``train`` did: its ``Trainer`` (the trained params, Adam's state
    and the step's program), each step's loss and wall ms (the step's data
    and noise, the program and the loss read back), and the step it started
    at."""

    trainer: Trainer
    losses: list
    step_ms: list
    start: int

    @property
    def params(self) -> dict:
        return self.trainer.params

    @property
    def opt(self) -> AdamState:
        return self.trainer.opt


def train_state_bytes(cfg: ModelConfig) -> int:
    """Bytes of the params and their gradients (in the params' dtypes) and
    Adam's two f32 moments, from ``models.model.param_template`` (which
    allocates nothing)."""
    return sum(p.numel() * (2 * p.element_size() + 8)
               for p in tree_leaves(M.param_template(cfg)))


def refuse_on_card(cfg: ModelConfig, device) -> None:
    """Exit where ``cfg`` does not train on the card: params, gradients and
    moments beyond the card's free memory."""
    if torch.device(device).type != "cuda":
        return
    dev = resolve_device(device)
    need = train_state_bytes(cfg)
    free, total = torch.cuda.mem_get_info(dev)
    if need > free:
        raise SystemExit(f"{cfg.name} at {cfg.n_layers} layers does not fit: its params, "
                         f"gradients and f32 Adam moments take {need / 1e9:.2f} GB, the card "
                         f"has {free / 1e9:.2f} GB free of {total / 1e9:.2f}; --layers N "
                         "cuts the depth")


def train(arch: str, *, smoke: bool = True, steps: int = 50, batch: int = 8, seq: int = 64,
          lr: float = 3e-4, scheduler: str = "fm_ot", ckpt_dir: Optional[str] = None,
          ckpt_every: int = 50, seed: int = 0, device="cuda", layers: Optional[int] = None,
          noise_source: Optional[Callable[[int], CFMNoise]] = None,
          log=print) -> TrainRun:
    """Train ``arch`` (the reference's ``train``; module docstring)."""
    cfg = for_device(get_config(arch, smoke=smoke), device)
    if layers:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    refuse_on_card(cfg, device)
    dev = resolve_device(device)
    sched = get_scheduler(scheduler)
    generator = torch.Generator(device=dev).manual_seed(seed)
    data = SyntheticTokens(cfg, DataConfig(batch_size=batch, seq_len=seq, seed=seed),
                           device=dev)
    start = 0
    if ckpt_dir and (latest := checkpointer.latest_step(ckpt_dir)) is not None:
        params = checkpointer.restore(checkpointer.step_path(ckpt_dir, latest),
                                      M.param_template(cfg), device=dev)
        start = latest
        log(f"restored step {latest} from {ckpt_dir}")
    else:
        params = M.init_params(generator, cfg, dev)
    trainer = Trainer(cfg, sched, params, steps=steps, lr=lr, device=dev)

    losses, step_ms = [], []
    t0 = time.perf_counter()
    for step in range(start, steps):
        ts = time.perf_counter()
        noise = (CFMNoise(*(x.to(dev) for x in noise_source(step))) if noise_source
                 else draw_cfm_noise(generator, batch, seq, cfg.latent_dim))
        loss = float(trainer.step(data.batch(step), noise))
        step_ms.append((time.perf_counter() - ts) * 1e3)
        losses.append(loss)
        if (step + 1) % 10 == 0 or step == steps - 1:
            log(f"step {step + 1}/{steps} loss={loss:.4f} "
                f"({(time.perf_counter() - t0) / (step - start + 1):.2f}s/step)")
        if ckpt_dir and (step + 1) % ckpt_every == 0:
            checkpointer.save(checkpointer.step_path(ckpt_dir, step + 1), trainer.params)
    return TrainRun(trainer=trainer, losses=losses, step_ms=step_ms, start=start)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--arch", required=True, help=f"one of {', '.join(ARCHS)}")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--scheduler", default="fm_ot")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50,
                    help="save the params every N steps (with --ckpt-dir)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    ap.add_argument("--layers", type=int, default=None,
                    help="train N of the config's layers (the width unchanged)")
    return ap


def main(argv=None) -> TrainRun:
    args = build_parser().parse_args(argv)
    if args.arch not in ARCHS:
        raise SystemExit(f"unknown --arch {args.arch!r}; the port trains {', '.join(ARCHS)}")
    try:
        return train(args.arch, smoke=args.smoke, steps=args.steps, batch=args.batch,
                     seq=args.seq, lr=args.lr, scheduler=args.scheduler,
                     ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every, seed=args.seed,
                     device=args.device, layers=args.layers)
    except RuntimeError as e:
        if "torch.cuda.is_available()" not in str(e):
            raise
        raise SystemExit(str(e)) from None


if __name__ == "__main__":
    main()
