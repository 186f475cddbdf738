"""Serving entry point: a closed-loop batch through the continuous-batching
engine, in float or ABFP numerics, on the GPU.

    PYTHONPATH=src python -m repro_torch.launch.serve --full --fused

``--fused`` serves in ``abfp_fused`` mode: packed weights with per-tile
ADC gains (capped by ``--gain``), an int8 KV cache, and decode ticks
through the fused QKV and int8-KV attention kernels.  ``--quant
abfp-packed`` serves through the packed ABFP kernel alone; the JAX
CLI's ``--quant abfp`` (the ``abfp_ref`` tile scan, a PRNG key per call)
is not served: the engine's passes take seeds from a table.  Weights are
random, from ``--seed``.  ``--device cpu`` runs the kernels' plain
PyTorch versions on the CPU (for small ``--reduced`` configs).

``--wall-clock`` drives the engine on ``time.perf_counter`` (latencies in
seconds, the tick utilization printed); ``--overlap`` (implies
``--wall-clock``) serves through the overlapped runtime: sampling on the
device, passes dispatched up to ``--inflight`` ahead of their delivery.
On a GPU every pass shape is captured into a CUDA graph before the
requests arrive (``ServingEngine.warmup``).

Each request's greedy token ids are printed as
``req <uid>: prompt[<len>] -> [ids]``.
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from typing import List, Optional

import numpy as np

from repro_torch.configs import get_config, list_archs, smoke_config
from repro_torch.core.abfp import QuantConfig
from repro_torch.models import init_params, param_count
from repro_torch.serving import Request, ServingEngine


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-360m",
                    help="model architecture (see repro_torch.configs)")
    ap.add_argument("--reduced", action="store_true", default=True,
                    help="reduced (smoke) shapes — the default")
    ap.add_argument("--full", dest="reduced", action="store_false",
                    help="full-size architecture config")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--capacity", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--quant", choices=("float", "abfp-kernel",
                                        "abfp-packed"),
                    default="float",
                    help="abfp-kernel: the unpacked ABFP kernel, weights "
                         "quantized inside every call; abfp-packed: "
                         "weights quantized once at init, the packed ABFP "
                         "kernel every pass (abfp, the abfp_ref scan, "
                         "trains in repro_torch.launch.train but is not "
                         "served)")
    ap.add_argument("--fused", action="store_true",
                    help="abfp_fused serving: per-tile ADC gains (capped "
                         "by --gain), int8 KV cache, fused QKV and "
                         "int8-KV attention kernels on decode ticks; "
                         "overrides --quant")
    ap.add_argument("--tile", type=int, default=128)
    ap.add_argument("--gain", type=float, default=8.0,
                    help="ADC gain G; with --fused the per-tile gain cap")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--prompt-len", type=int, default=4)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--no-chunked", action="store_true",
                    help="prefill-in-decode: one prompt token per decode "
                         "tick instead of bucketed prefill chunks")
    ap.add_argument("--prefill-chunks", default="16,64,128",
                    help="comma-separated chunk buckets for prefill passes")
    ap.add_argument("--policy", choices=("fcfs", "sjf", "priority"),
                    default="fcfs", help="admission scheduling policy")
    ap.add_argument("--device", default="cuda",
                    help="torch device (cuda, or cpu for the plain versions)")
    ap.add_argument("--wall-clock", action="store_true",
                    help="drive the engine on time.perf_counter instead of "
                         "the simulated tick clock (latencies in SECONDS)")
    ap.add_argument("--overlap", action="store_true",
                    help="overlapped dispatch: sample on the device, "
                         "dispatch pass N+1 before pass N's tokens reach "
                         "the host, deliver them from a background worker; "
                         "implies --wall-clock")
    ap.add_argument("--inflight", type=int, default=4,
                    help="dispatch-ahead depth for --overlap (bound on "
                         "submitted but undelivered passes)")
    return ap


def model_and_quant(args):
    """The ModelConfig and QuantConfig the flags ask for."""
    if args.arch not in list_archs():
        raise SystemExit(f"[serve] unknown arch {args.arch!r}; registered: "
                         f"{', '.join(list_archs())}")
    mcfg = smoke_config(args.arch) if args.reduced else get_config(args.arch)
    mode = {"float": "float", "abfp-kernel": "abfp_kernel",
            "abfp-packed": "abfp_packed"}[args.quant]
    if args.fused:
        # The fused decode kernels attend over the int8 KV cache.
        mcfg = dataclasses.replace(mcfg, kv_quant=True)
        mode = "abfp_fused"
    quant = (QuantConfig(mode=mode, tile_width=args.tile, gain=args.gain,
                         noise_lsb=0.5)
             if mode != "float" else QuantConfig(mode="float"))
    return mcfg, quant


def make_requests(mcfg, args) -> List[Request]:
    rng = np.random.default_rng(args.seed)
    return [Request(uid=i,
                    prompt=rng.integers(1, mcfg.vocab_size,
                                        args.prompt_len).tolist(),
                    max_new_tokens=args.max_new,
                    temperature=args.temperature)
            for i in range(args.requests)]


def main(argv: Optional[List[str]] = None) -> None:
    args = build_parser().parse_args(argv)
    if args.overlap:
        args.wall_clock = True
    mcfg, quant = model_and_quant(args)
    params = init_params(args.seed, mcfg, device=args.device)
    print(f"[serve] {args.arch}: {param_count(params) / 1e6:.1f}M params, "
          f"quant={quant.mode}, policy={args.policy}, device={args.device}")
    eng = ServingEngine(params, mcfg, capacity=args.capacity,
                        max_len=args.max_len, quant=quant, seed=args.seed,
                        chunked=not args.no_chunked, policy=args.policy,
                        prefill_chunks=tuple(
                            int(c) for c in args.prefill_chunks.split(",")),
                        device=args.device,
                        clock=time.perf_counter if args.wall_clock else None,
                        overlap=args.overlap, inflight=args.inflight)
    unit = "s" if args.wall_clock else "ticks"
    if args.wall_clock:
        print(f"[serve] wall clock: overlap="
              f"{'on' if args.overlap else 'off (blocking)'}"
              + (f", inflight={args.inflight}" if args.overlap else ""))
        eng.warmup()        # capture every pass shape before the requests
    reqs = make_requests(mcfg, args)
    t0 = time.time()
    done = eng.run(reqs)
    dt = time.time() - t0
    tokens = sum(len(r.generated) for r in done)
    print(f"[serve] {len(done)} requests, {tokens} tokens in {dt:.1f}s "
          f"({tokens / dt:.1f} tok/s, {eng.ticks} ticks)")
    s = eng.metrics.summary()

    def fmt(d, key):
        v = d[key]
        return "-" if v is None else f"{v:.2f}"

    print(f"[serve] TTFT p50 {fmt(s['ttft'], 'p50')} / p99 "
          f"{fmt(s['ttft'], 'p99')} {unit} | TPOT p50 "
          f"{fmt(s['tpot'], 'p50')} {unit} | E2E p50 {fmt(s['e2e'], 'p50')} "
          f"{unit}")
    if args.wall_clock:
        tu = eng.metrics.tick_utilization()
        tv = tu["value"]
        print(f"[serve] tick utilization "
              f"{'-' if tv is None else f'{tv:.1%}'} "
              f"(device busy {tu['device_busy_s']:.2f}s of "
              f"{tu['active_s']:.2f}s active)")
    eng.close()
    for r in done:
        print(f"  req {r.uid}: prompt[{len(r.prompt)}] -> {r.generated}")


if __name__ == "__main__":
    main()
