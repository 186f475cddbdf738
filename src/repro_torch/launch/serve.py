"""Serving entry point: a closed-loop batch or arrival-driven open-loop
serving through the continuous-batching engine, in float or ABFP
numerics, on the GPU.

Closed loop (admit everything, run to completion):

    PYTHONPATH=src python -m repro_torch.launch.serve --full --fused

Open loop (Poisson arrivals on the simulated clock, a scheduling policy,
SLO metrics), here from a paged KV pool with deadlines:

    PYTHONPATH=src python -m repro_torch.launch.serve --full --fused \\
        --paged --arrival-rate 2 --tenants 2 --deadline 40 \\
        --metrics-out out.json

Trace replay: ``--trace FILE`` where FILE is a JSON list of requests,
each ``{"arrival_time": float, "prompt": [ints]}`` or
``{"arrival_time": float, "prompt_len": int}`` plus optional
``max_new_tokens`` / ``priority`` / ``tenant`` / ``temperature``.
``poisson_workload`` and ``trace_workload`` draw the JAX CLI's
requests from the same ``--seed``.

``--fused`` serves in ``abfp_fused`` mode: packed weights with per-tile
ADC gains (capped by ``--gain``), an int8 KV cache, and unpaged decode
ticks through the fused QKV and int8-KV attention kernels (a paged tick
runs the packed chain, as in the JAX package).  ``--quant abfp-packed``
serves through the packed ABFP kernel alone; ``--quant abfp`` serves the
paper's reference numerics (``abfp_ref``: the tile scan on float
weights, each dense call's key from the pass's key table on the device,
its noise drawn there).  Weights are random, from
``--seed``.  ``--device cpu`` runs the kernels' plain PyTorch versions on
the CPU (for small ``--reduced`` configs).

``--paged`` serves from a shared KV page pool (``--page-size``,
``--pool-pages``) with copy-on-write prefix sharing
(``--no-prefix-cache``), preemption under page pressure
(``--no-preemption``), queue-watermark shedding (``--queue-watermark``),
a degraded mode between pool-pressure watermarks (``--page-watermarks``,
``--degraded-max-new``) and per-tenant page quotas (``--tenant-quota``);
``--deadline`` cancels a request that many ticks (seconds on a wall
clock) after its arrival.

``--fault-rate`` injects seeded faults into the served weights (a
per-tick probability; ``--fault-kinds`` of stuck_col / scale_drift /
shard_drop, ``--fault-seed``); every ``--detect-every`` ticks while a
fault is live the engine fingerprints the array and repairs it, unless
``--no-recovery`` (the degraded-mode baseline for the goodput
comparison).

``--archs a,b,c`` serves a multi-model FLEET (``serving.fleet``): one
lane per arch on a shared clock, ``--capacity`` slots split near-equally
(``--model-split name=slots,...`` overrides lanes), requests routed
round-robin over the lanes with their prompts folded into each lane's
vocabulary, the requests of an encoder-decoder lane given stub audio
features keyed by (``--seed``, uid); it prints one summary line per
lane and ``--metrics-out`` writes ``{"fleet": ..., "conservation":
...}``.  As in the JAX CLI it takes neither the fault flags nor the wall
clock:

    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \\
        --reduced --archs smollm-360m,xlstm-350m

``--mesh dp,tp`` serves tensor-parallel on a (data, model) mesh
(``launch.mesh.make_host_mesh``): every dense weight whose columns split
over the ``tp`` model shards runs one kernel launch per shard at its
global column-block offset, the outputs concatenated in shard order;
greedy streams equal the run without a mesh at any mesh shape.  In this
port a mesh is virtual: every shard lives on ``--device`` (one card, or
the CPU); ``dp`` is validated and read by the spec trees.  It composes
with ``--archs`` (every lane on the mesh), not with the fault flags (the
multi-card slice's):

    PYTHONPATH=src python -m repro_torch.launch.serve --full --fused \
        --arch tinyllama-1.1b --mesh 1,2

``--wall-clock`` drives the engine on ``time.perf_counter`` (latencies in
seconds, the tick utilization printed); ``--overlap`` (implies
``--wall-clock``) serves through the overlapped runtime: sampling on the
device, passes dispatched up to ``--inflight`` ahead of their delivery.
On a GPU every pass shape is captured into a CUDA graph before the
requests arrive (``ServingEngine.warmup``).

The run prints the JAX CLI's summary lines (p50/p99 TTFT, TPOT and
E2E, goodput against ``--slo-ttft``, slot and tick utilization, the
fault counters with ``--fault-rate`` or ``--deadline``, and with
``--paged`` the pool and overload counts), then the first requests'
greedy token ids as ``req <uid>: prompt[<len>] -> [ids]``;
``--metrics-out`` writes the percentile summary as JSON.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time
from typing import List, Optional, Tuple

import numpy as np

from repro_torch.configs import get_config, list_archs, smoke_config
from repro_torch.core import prng
from repro_torch.core.abfp import QuantConfig
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import frontends, init_params, param_count
from repro_torch.serving import (
    EncDecRunner,
    FaultConfig,
    Request,
    ServingEngine,
    runner_for,
)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-360m",
                    help="model architecture (see repro_torch.configs)")
    ap.add_argument("--archs", default=None,
                    help="comma-separated arch list: serve a multi-model "
                         "fleet (one lane per arch on a shared clock; "
                         "requests route round-robin across the models)")
    ap.add_argument("--model-split", default=None,
                    help="'name=slots,...' per-model slot overrides for "
                         "--archs (the remaining capacity splits "
                         "near-equally)")
    ap.add_argument("--reduced", action="store_true", default=True,
                    help="reduced (smoke) shapes — the default")
    ap.add_argument("--full", dest="reduced", action="store_false",
                    help="full-size architecture config")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--capacity", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--quant", choices=("float", "abfp", "abfp-kernel",
                                        "abfp-packed"),
                    default="float",
                    help="abfp: the abfp_ref tile scan (the paper's "
                         "reference numerics, noise drawn on the device); "
                         "abfp-kernel: the unpacked ABFP kernel, weights "
                         "quantized inside every call; abfp-packed: "
                         "weights quantized once at init, the packed ABFP "
                         "kernel every pass")
    ap.add_argument("--fused", action="store_true",
                    help="abfp_fused serving: per-tile ADC gains (capped "
                         "by --gain), int8 KV cache, fused QKV and "
                         "int8-KV attention kernels on unpaged decode "
                         "ticks; overrides --quant")
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
    # Open-loop serving (arrival-driven; omit both for the closed loop).
    ap.add_argument("--arrival-rate", type=float, default=None,
                    help="Poisson arrival rate in requests per simulated "
                         "tick (per second on a wall clock); enables the "
                         "open-loop submit/poll path")
    ap.add_argument("--trace", default=None,
                    help="JSON trace of requests to replay (see the module "
                         "docstring for the schema)")
    ap.add_argument("--policy", choices=("fcfs", "sjf", "priority"),
                    default="fcfs", help="admission scheduling policy")
    ap.add_argument("--tenants", type=int, default=2,
                    help="number of synthetic tenants for Poisson workloads")
    ap.add_argument("--slo-ttft", type=float, default=8.0,
                    help="TTFT SLO in simulated ticks (seconds on a wall "
                         "clock): the goodput threshold")
    ap.add_argument("--metrics-out", default=None,
                    help="write the percentile metrics summary JSON here")
    # Fault injection / SLO-aware recovery (repro_torch.serving.faults).
    ap.add_argument("--fault-rate", type=float, default=None,
                    help="per-tick fault probability; enables seeded "
                         "injection into the served weights")
    ap.add_argument("--fault-kinds", default="stuck_col,scale_drift,"
                                             "shard_drop",
                    help="comma-separated subset of "
                         "stuck_col/scale_drift/shard_drop")
    ap.add_argument("--fault-seed", type=int, default=0,
                    help="seed for the deterministic fault trace")
    ap.add_argument("--no-recovery", action="store_true",
                    help="inject but do not detect/repair (degraded-mode "
                         "baseline for the goodput comparison)")
    ap.add_argument("--detect-every", type=int, default=4,
                    help="fingerprint-probe cadence in engine ticks")
    # Paged KV pool + overload robustness (repro_torch.serving.pages).
    ap.add_argument("--paged", action="store_true",
                    help="serve from a paged KV pool (fixed pages aligned "
                         "to the ABFP tile, slot->page-table indirection, "
                         "copy-on-write prefix sharing) instead of "
                         "per-slot max_len strips")
    ap.add_argument("--page-size", type=int, default=None,
                    help="tokens per KV page (default: the quant tile "
                         "width, or min(16, max_len) in float mode)")
    ap.add_argument("--pool-pages", type=int, default=None,
                    help="total pages in the shared pool (default: "
                         "capacity * ceil(max_len / page_size), the "
                         "unpaged footprint)")
    ap.add_argument("--no-prefix-cache", action="store_true",
                    help="disable cross-request prefix page sharing")
    ap.add_argument("--no-preemption", action="store_true",
                    help="disable evict-to-pool preemption under page "
                         "saturation (victims then wait instead)")
    ap.add_argument("--queue-watermark", type=int, default=None,
                    help="shed newly arrived requests once the arrived "
                         "queue depth reaches this (backpressure; shed "
                         "requests carry a retry_after hint)")
    ap.add_argument("--page-watermarks", default="0.85,0.5",
                    help="hi,lo pool-pressure fractions: degraded mode "
                         "enters at hi and exits at lo (hysteresis)")
    ap.add_argument("--degraded-max-new", type=int, default=None,
                    help="cap max_new_tokens for admissions made while "
                         "degraded")
    ap.add_argument("--tenant-quota", type=int, default=None,
                    help="max pool pages a single tenant may hold "
                         "(projected footprint; noisy-neighbor isolation)")
    ap.add_argument("--deadline", type=float, default=None,
                    help="per-request deadline in ticks (seconds on a wall "
                         "clock) after arrival; expired requests are "
                         "cancelled and counted timed_out")
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
    ap.add_argument("--mesh", default=None,
                    help="dp,tp — serve tensor-parallel on a (data, model) "
                         "mesh whose every position is --device (a virtual "
                         "mesh)")
    return ap


def parse_mesh(arg: Optional[str]) -> Optional[Tuple[int, int]]:
    """'dp,tp' -> (dp, tp); None passes through (the one-device
    engine)."""
    if arg is None:
        return None
    try:
        dp, tp = (int(v) for v in arg.split(","))
    except ValueError:
        raise SystemExit(f"--mesh expects 'dp,tp' (got {arg!r})")
    if dp < 1 or tp < 1:
        raise SystemExit(f"--mesh axes must be >= 1 (got {arg!r})")
    return dp, tp


def resolve_archs(args) -> List[str]:
    """The validated arch list: ``--archs a,b,c`` (fleet) or ``--arch``
    (single).  Unknown names fail fast with the registry listed."""
    names = ([a.strip() for a in args.archs.split(",") if a.strip()]
             if args.archs else [args.arch])
    known = sorted(list_archs())
    bad = [a for a in names if a not in known]
    if bad or not names:
        what = f"unknown arch(es) {bad}" if bad else "no archs given"
        raise SystemExit(
            f"[serve] {what}; registered archs: {', '.join(known)}")
    return names


def parse_model_split(arg: Optional[str]) -> Optional[dict]:
    """'name=slots,name=slots' -> {name: slots}; None passes through."""
    if arg is None:
        return None
    out = {}
    for part in arg.split(","):
        if not part.strip():
            continue
        try:
            name, slots = part.split("=")
            out[name.strip()] = int(slots)
        except ValueError:
            raise SystemExit(
                f"--model-split expects 'name=slots,...' (got {arg!r})")
    return out or None


def attach_features(reqs: List[Request], runners: dict, seed: int) -> None:
    """Stub frontend features for the requests routed to encoder-decoder
    lanes: each request gets its own (enc_len, d_model) audio-frame
    embedding keyed by (seed, uid), as f32 numpy (the JAX CLI's draws)."""
    for r in reqs:
        runner = runners.get(r.model)
        if not isinstance(runner, EncDecRunner):
            continue
        key = prng.fold_in(prng.PRNGKey(seed), r.uid)
        r.features = frontends.audio_stub_features(
            key, 1, runner.enc_len, runner.mcfg.d_model,
            device="cpu")[0].float().numpy()


def model_config(arch: str, args):
    """The ModelConfig of ``arch`` the flags ask for."""
    mcfg = smoke_config(arch) if args.reduced else get_config(arch)
    if args.fused:
        # The fused decode kernels attend over the int8 KV cache.
        mcfg = dataclasses.replace(mcfg, kv_quant=True)
    return mcfg


def quant_config(args) -> QuantConfig:
    """The QuantConfig the flags ask for."""
    mode = {"float": "float", "abfp": "abfp_ref",
            "abfp-kernel": "abfp_kernel",
            "abfp-packed": "abfp_packed"}[args.quant]
    if args.fused:
        mode = "abfp_fused"
    return (QuantConfig(mode=mode, tile_width=args.tile, gain=args.gain,
                        noise_lsb=0.5)
            if mode != "float" else QuantConfig(mode="float"))


def model_and_quant(args):
    """The ModelConfig (of ``--arch``) and QuantConfig the flags ask for."""
    if args.arch not in list_archs():
        raise SystemExit(f"[serve] unknown arch {args.arch!r}; registered: "
                         f"{', '.join(list_archs())}")
    return model_config(args.arch, args), quant_config(args)


def poisson_workload(mcfg, args, rng: np.random.Generator) -> List[Request]:
    """Mixed-tenant Poisson arrivals: exponential inter-arrival gaps at
    ``--arrival-rate`` requests per tick, prompt lengths drawn uniformly
    from [1, 2 * --prompt-len - 1] (the JAX CLI's draws, in order)."""
    gaps = rng.exponential(1.0 / args.arrival_rate, args.requests)
    arrivals = np.cumsum(gaps)
    reqs = []
    for i in range(args.requests):
        plen = int(rng.integers(1, max(2, 2 * args.prompt_len)))
        reqs.append(Request(
            uid=i,
            prompt=rng.integers(1, mcfg.vocab_size, plen).tolist(),
            max_new_tokens=args.max_new,
            temperature=args.temperature,
            arrival_time=float(arrivals[i]),
            priority=int(rng.integers(0, 3)),
            tenant=f"t{int(rng.integers(args.tenants))}"))
    return reqs


def trace_workload(mcfg, args, rng: np.random.Generator) -> List[Request]:
    """The requests of the ``--trace`` JSON file (prompts of entries with
    only a ``prompt_len`` drawn from ``rng``)."""
    with open(args.trace) as f:
        entries = json.load(f)
    reqs = []
    for i, e in enumerate(entries):
        prompt = e.get("prompt")
        if prompt is None:
            plen = int(e.get("prompt_len", args.prompt_len))
            prompt = rng.integers(1, mcfg.vocab_size, plen).tolist()
        reqs.append(Request(
            uid=i, prompt=list(prompt),
            max_new_tokens=int(e.get("max_new_tokens", args.max_new)),
            temperature=float(e.get("temperature", args.temperature)),
            arrival_time=float(e.get("arrival_time", 0.0)),
            priority=int(e.get("priority", 0)),
            tenant=str(e.get("tenant", "default"))))
    return reqs


def serve_fleet(built: dict, quant: QuantConfig, mesh, args) -> None:
    """Multi-model fleet serving: one lane per ``--archs`` entry on a
    shared clock, requests routed round-robin over the models (the
    requests of encoder-decoder lanes get stub frontend features)."""
    runners = {name: runner_for(cfg) for name, (_, cfg) in built.items()}
    eng = ServingEngine(
        models={name: (p, cfg, runners[name])
                for name, (p, cfg) in built.items()},
        capacity=args.capacity,
        model_split=parse_model_split(args.model_split),
        max_len=args.max_len, quant=quant, seed=args.seed,
        chunked=not args.no_chunked, policy=args.policy,
        prefill_chunks=tuple(int(c) for c in args.prefill_chunks.split(",")),
        device=args.device, mesh=mesh, paged=args.paged,
        page_size=args.page_size, pool_pages=args.pool_pages,
        prefix_cache=not args.no_prefix_cache)
    lanes = {n: l_.capacity for n, l_ in eng.lanes.items()}
    print(f"[serve] fleet: {len(built)} models, slots {lanes}, "
          f"quant={args.quant}, policy={args.policy}")
    if next(iter(eng.lanes.values())).device.type == "cuda":
        eng.warmup()        # capture every lane's passes before requests

    rng = np.random.default_rng(args.seed)
    names = list(built)
    if args.arrival_rate is not None or args.trace is not None:
        reqs = (trace_workload(built[names[0]][1], args, rng) if args.trace
                else poisson_workload(built[names[0]][1], args, rng))
    else:
        reqs = [Request(uid=i,
                        prompt=rng.integers(
                            1, built[names[0]][1].vocab_size,
                            args.prompt_len).tolist(),
                        max_new_tokens=args.max_new,
                        temperature=args.temperature)
                for i in range(args.requests)]
    for i, r in enumerate(reqs):
        r.model = names[i % len(names)]
        # Prompts must fit every lane's vocabulary.
        vmax = built[r.model][1].vocab_size
        r.prompt = [t % (vmax - 1) + 1 for t in r.prompt]
    attach_features(reqs, runners, args.seed)

    t0 = time.time()
    done = eng.run(reqs)
    dt = time.time() - t0
    eng.close()
    tokens = sum(len(r.generated) for r in done)
    print(f"[serve] fleet: {len(done)} requests, {tokens} tokens in "
          f"{dt:.1f}s ({tokens / max(dt, 1e-9):.1f} tok/s, "
          f"{eng.ticks} ticks)")

    def fmt(d, key):
        v = d[key]
        return "-" if v is None else f"{v:.2f}"

    summaries = eng.summary()
    cons = eng.conservation()
    for name in names:
        s, c = summaries[name], cons[name]
        print(f"  {name}: TTFT p50 {fmt(s['ttft'], 'p50')} / "
              f"p99 {fmt(s['ttft'], 'p99')} | TPOT p50 "
              f"{fmt(s['tpot'], 'p50')} | completed "
              f"{c['completed']}/{c['submitted']} "
              f"(conservation_ok {c['ok']})")
    if args.metrics_out:
        with open(args.metrics_out, "w") as f:
            json.dump({"fleet": {n: summaries[n] for n in names},
                       "conservation": cons}, f, indent=2, default=str)
        print(f"[serve] wrote {args.metrics_out}")


def main(argv: Optional[List[str]] = None) -> None:
    args = build_parser().parse_args(argv)
    if args.overlap:
        args.wall_clock = True
    mesh_shape = parse_mesh(args.mesh)
    mesh = None if mesh_shape is None else make_host_mesh(*mesh_shape,
                                                          args.device)
    if args.archs is not None:
        archs = resolve_archs(args)
        if args.fault_rate is not None:
            raise SystemExit("[serve] --archs (fleet mode) does not "
                             "compose with fault injection flags yet")
        quant = quant_config(args)
        if args.fused:
            args.quant = "abfp-fused"
        built = {}
        for a in archs:
            cfg = model_config(a, args)
            built[a] = (init_params(args.seed, cfg, device=args.device), cfg)
        serve_fleet(built, quant, mesh, args)
        return
    mcfg, quant = model_and_quant(args)
    try:
        wm_hi, wm_lo = (float(v) for v in args.page_watermarks.split(","))
    except ValueError:
        raise SystemExit(f"--page-watermarks expects 'hi,lo' "
                         f"(got {args.page_watermarks!r})")
    params = init_params(args.seed, mcfg, device=args.device)
    mesh_note = (f", mesh=({mesh_shape[0]}x{mesh_shape[1]} data x model)"
                 if mesh is not None else "")
    print(f"[serve] {args.arch}: {param_count(params) / 1e6:.1f}M params, "
          f"quant={quant.mode}, policy={args.policy}{mesh_note}, "
          f"device={args.device}")
    faults = None
    if args.fault_rate is not None:
        faults = FaultConfig(
            rate=args.fault_rate,
            kinds=tuple(k for k in args.fault_kinds.split(",") if k),
            seed=args.fault_seed)
        print(f"[serve] fault injection: rate={args.fault_rate}/tick, "
              f"kinds={args.fault_kinds}, seed={args.fault_seed}, "
              f"recovery={'off' if args.no_recovery else 'on'}")
    if args.paged:
        print(f"[serve] paged KV pool: page_size="
              f"{args.page_size or 'auto'}, pool_pages="
              f"{args.pool_pages or 'auto'}, prefix_cache="
              f"{not args.no_prefix_cache}, preemption="
              f"{not args.no_preemption}, watermarks=({wm_hi}, {wm_lo})")
    eng = ServingEngine(params, mcfg, capacity=args.capacity,
                        max_len=args.max_len, quant=quant, seed=args.seed,
                        chunked=not args.no_chunked, policy=args.policy,
                        prefill_chunks=tuple(
                            int(c) for c in args.prefill_chunks.split(",")),
                        device=args.device, mesh=mesh,
                        faults=faults, recovery=not args.no_recovery,
                        detect_every=args.detect_every,
                        paged=args.paged, page_size=args.page_size,
                        pool_pages=args.pool_pages,
                        prefix_cache=not args.no_prefix_cache,
                        preemption=False if args.no_preemption else None,
                        queue_watermark=args.queue_watermark,
                        page_watermarks=(wm_hi, wm_lo),
                        degraded_max_new=args.degraded_max_new,
                        tenant_quota=args.tenant_quota,
                        clock=time.perf_counter if args.wall_clock else None,
                        overlap=args.overlap, inflight=args.inflight)
    unit = "s" if args.wall_clock else "ticks"
    if args.wall_clock:
        print(f"[serve] wall clock: overlap="
              f"{'on' if args.overlap else 'off (blocking)'}"
              + (f", inflight={args.inflight}" if args.overlap else ""))
        eng.warmup()        # capture every pass shape before the requests
    rng = np.random.default_rng(args.seed)

    if args.arrival_rate is not None or args.trace is not None:
        reqs = (trace_workload(mcfg, args, rng) if args.trace
                else poisson_workload(mcfg, args, rng))
        if args.wall_clock:
            # Arrivals are offsets; the wall clock reads an arbitrary
            # epoch, so rebase them onto now.
            base = time.perf_counter()
            for r in reqs:
                r.arrival_time = base + (r.arrival_time or 0.0)
        if args.deadline is not None:
            for r in reqs:
                r.deadline = (r.arrival_time or 0.0) + args.deadline
        for r in reqs:
            eng.submit(r)
        span = (max(r.arrival_time for r in reqs)
                - min(r.arrival_time for r in reqs)) if reqs else 0.0
        print(f"[serve] open-loop: {len(reqs)} requests arriving over "
              f"{span:.1f} {unit}, {args.tenants} tenants")
        t0 = time.time()
        done = eng.drain()
    else:
        reqs = [Request(uid=i,
                        prompt=rng.integers(1, mcfg.vocab_size,
                                            args.prompt_len).tolist(),
                        max_new_tokens=args.max_new,
                        temperature=args.temperature)
                for i in range(args.requests)]
        t0 = time.time()
        done = eng.run(reqs)
    dt = time.time() - t0
    eng.close()

    tokens = sum(len(r.generated) for r in done)
    print(f"[serve] {len(done)} requests, {tokens} tokens in {dt:.1f}s "
          f"({tokens / dt:.1f} tok/s, {eng.ticks} ticks)")
    s = eng.metrics.summary()
    ttft, tpot, e2e = s["ttft"], s["tpot"], s["e2e"]

    def fmt(d, key):
        v = d[key]
        return "-" if v is None else f"{v:.2f}"

    print(f"[serve] TTFT p50 {fmt(ttft, 'p50')} / p99 {fmt(ttft, 'p99')} "
          f"{unit} | TPOT p50 {fmt(tpot, 'p50')} / p99 {fmt(tpot, 'p99')} "
          f"{unit} | E2E p50 {fmt(e2e, 'p50')} / p99 {fmt(e2e, 'p99')} "
          f"{unit}")
    good = eng.metrics.goodput(args.slo_ttft)
    util = s["utilization"]["mean"]
    print(f"[serve] goodput {good if good is None else round(good, 3)} "
          f"req/{unit.rstrip('s') or 's'} (TTFT<={args.slo_ttft}), "
          f"slot utilization "
          f"{'-' if util is None else f'{util:.0%}'}, max queue depth "
          f"{s['queue_depth']['max']}")
    if args.wall_clock:
        tu = s["tick_utilization"]
        tv = tu["value"]
        print(f"[serve] tick utilization "
              f"{'-' if tv is None else f'{tv:.1%}'} "
              f"(device busy {tu['device_busy_s']:.2f}s of "
              f"{tu['active_s']:.2f}s active)")
    req_s = s["requests"]
    cons = eng.metrics.conservation()
    if args.fault_rate is not None or args.deadline is not None:
        f = s["faults"]
        print(f"[serve] faults: {f['injected']} injected "
              f"({f['injected_stuck_col']} stuck_col, "
              f"{f['injected_scale_drift']} scale_drift, "
              f"{f['injected_shard_drop']} shard_drop), "
              f"{f['detected']} detected, {f['cols_remapped']} cols "
              f"remapped, {f['tiles_requantized']} tiles requantized, "
              f"{f['reshards']} reshards")
        print(f"[serve] timed_out {req_s['timed_out']}, requeued "
              f"{req_s['requeued']}, corrupted {req_s['corrupted']}, "
              f"conservation_ok {cons['ok']}")
    if args.paged:
        pool = s["pool"]
        print(f"[serve] pool: pressure mean {pool['pressure_mean']:.2f} / "
              f"max {pool['pressure_max']:.2f}, prefix hits "
              f"{pool['prefix_hits']}, cow copies {pool['cow_copies']}, "
              f"degraded ticks {pool['degraded_ticks']}")
        print(f"[serve] overload: shed {req_s['shed']}, preempted "
              f"{req_s['preempted']}, resumed {req_s['resumed']}, "
              f"preempt_ok {cons['preempt_ok']}")
    if args.metrics_out:
        eng.metrics.to_json(args.metrics_out, policy=args.policy,
                            quant=args.quant if not args.fused
                            else "abfp-fused",
                            slo_ttft=args.slo_ttft,
                            goodput_per_tick=good)
        print(f"[serve] wrote {args.metrics_out}")
    for r in done[:3]:
        print(f"  req {r.uid}: prompt[{len(r.prompt)}] -> {r.generated}")


if __name__ == "__main__":
    main()
