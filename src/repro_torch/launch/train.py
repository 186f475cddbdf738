"""Training driver: config -> model -> synthetic data -> train step (float
or QAT) -> atomic checkpoints with auto-resume -> straggler monitor, on
the GPU.

    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m \\
        --steps 200 --ckpt-dir /tmp/run1 --resume auto

``--quant qat`` trains through the ``abfp_ref`` tile scan (tile 128, gain
8, noise 0.5) with straight-through gradients.  Weights are random from
``--seed``; batch ``step`` is the synthetic pipeline's, so a resumed run
sees the batches it would have seen.  ``--reduced`` takes the smoke-scale
config, and ``--device cpu`` runs it on the CPU (the kernels' plain
versions).  An encoder-decoder or a vision-stub arch trains its text
backbone (the JAX driver's fallback).  Single process.
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from repro_torch import checkpoint as ckpt
from repro_torch.configs import get_config, smoke_config
from repro_torch.core import prng
from repro_torch.core.abfp import QuantConfig
from repro_torch.core.device import resolve_device
from repro_torch.data import DataConfig, batch_at_step
from repro_torch.distributed.fault import StragglerMonitor
from repro_torch.models import init_params, param_count
from repro_torch.optim import AdamW, cosine_one_cycle
from repro_torch.training.train_lib import TrainConfig, make_train_step


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="smollm-360m")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--reduced", action="store_true",
                    help="smoke-scale config (CPU-sized)")
    ap.add_argument("--quant", choices=("float", "qat"), default="float",
                    help="qat: abfp_ref, tile 128, gain 8, noise 0.5, "
                         "straight-through gradients")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--compression", choices=("none", "bf16", "int8"),
                    default="none")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", choices=("auto", "never"), default="auto")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain versions)")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    """Run the driver; returns {"losses": [...], "grad_norms": [...],
    "step_s": [...], "start_step": n, "state": the final TrainState} of
    the steps it ran (host seconds per step, to a synchronized device)."""
    args = parse_args(argv)
    dev = resolve_device(args.device)
    mcfg = smoke_config(args.arch) if args.reduced else get_config(args.arch)
    if mcfg.frontend == "vision_stub" or mcfg.is_encoder_decoder:
        # The synthetic data is token ids: train the text backbone.
        mcfg = dataclasses.replace(mcfg, frontend="none",
                                   is_encoder_decoder=False,
                                   num_encoder_layers=0)
        print("[train] stub-frontend arch: training the text backbone")
    dcfg = DataConfig(vocab_size=mcfg.vocab_size, seq_len=args.seq,
                      global_batch=args.batch, seed=args.seed)
    quant = (QuantConfig(mode="abfp_ref", tile_width=128, gain=8.0,
                         noise_lsb=0.5) if args.quant == "qat"
             else QuantConfig(mode="float"))
    tcfg = TrainConfig(
        microbatches=args.microbatches,
        compression=None if args.compression == "none" else args.compression,
        quant=quant)
    opt = AdamW(schedule=cosine_one_cycle(args.lr, args.steps))
    # The step consumes its state, as the JAX driver's donated jit does.
    init_state, train_step = make_train_step(mcfg, opt, tcfg, device=dev,
                                             donate=True)

    params = init_params(args.seed, mcfg, device=dev)
    print(f"[train] {args.arch} ({'reduced' if args.reduced else 'full'}): "
          f"{param_count(params) / 1e6:.1f}M params, quant={args.quant}, "
          f"device={dev}", flush=True)
    state = init_state(params)

    start_step = 0
    if args.ckpt_dir and args.resume == "auto" \
            and ckpt.latest_step(args.ckpt_dir) is not None:
        state, start_step, _ = ckpt.restore(args.ckpt_dir, state)
        print(f"[train] resumed from step {start_step}", flush=True)

    monitor = StragglerMonitor()
    out = {"losses": [], "grad_norms": [], "step_s": [],
           "start_step": start_step}
    metrics = None
    for step in range(start_step, args.steps):
        batch = batch_at_step(dcfg, step)
        key = prng.fold_in(prng.PRNGKey(args.seed + 1), step)
        t0 = time.perf_counter()
        state, metrics = train_step(state, batch, key)
        loss, gnorm = float(metrics["loss"]), float(metrics["grad_norm"])
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        dt = time.perf_counter() - t0
        out["losses"].append(loss)
        out["grad_norms"].append(gnorm)
        out["step_s"].append(dt)
        if monitor.observe(dt):
            print(f"[train] step {step}: straggler breach ({dt:.2f}s); "
                  f"escalation={monitor.escalation()}", flush=True)
        if step % 10 == 0 or step == args.steps - 1:
            print(f"[train] step {step}: loss={loss:.4f} "
                  f"grad_norm={gnorm:.3f} {dt * 1e3:.0f}ms", flush=True)
        if args.ckpt_dir and (step + 1) % args.ckpt_every == 0:
            path = ckpt.save(args.ckpt_dir, step + 1, state,
                             extra={"data_step": step + 1})
            print(f"[train] checkpoint -> {path}", flush=True)

    if args.ckpt_dir and ckpt.latest_step(args.ckpt_dir) != args.steps:
        ckpt.save(args.ckpt_dir, args.steps, state,
                  extra={"data_step": args.steps})
    if metrics is not None:
        print(f"[train] done: final loss {float(metrics['loss']):.4f}",
              flush=True)
    out["state"] = state
    return out


if __name__ == "__main__":
    main()
