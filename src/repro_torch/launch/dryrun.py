"""Multi-pod dry run: the counterpart of the JAX package's
``launch/dryrun.py``.

For every (architecture x input shape x mesh) cell the JAX package lowers
and compiles the step over placeholder devices and reads the compiler's
memory and cost analyses.  The port traces the step on the ``meta`` device
instead (``launch.cost_analysis.traced_costs``): the same cells
(params from ``models.abstract_params``, the state, the inputs of
``input_specs``), nothing allocated, no card needed, and it writes the
same artifact fields into ``experiments/dryrun_torch/<cell>.json``
(``$REPRO_TORCH_DRYRUN_ART_DIR`` overrides).  The figures are a cost
analysis of the port's own ops, not of XLA's HLO: where they differ from
JAX's the difference is the ops', not the count's (see
``cost_analysis``).

Cells:
  train_4k      -> train_step (AdamW + ZeRO-1 moments + remat + 4
                   microbatches, the state donated) through
                   ``make_train_step(mesh=)``
  prefill_32k   -> ``forward(mesh=)``, then the last position's logits
  decode_32k    -> ``decode_step(mesh=)`` over a 32k decode state
                   (donated)
  long_500k     -> ``decode_step(mesh=)`` at 524,288 positions (ssm /
                   hybrid only)

``--quant abfp`` traces the paper's ABFP numerics (``abfp_ref``: tile
128, gain 8, 8/8/8 bits, 0.5 LSB of ADC noise; QAT for train cells).
The artifact keeps JAX's fields with ``fits_80g`` for ``fits_16g`` (one
H100's 80 GB), ``compile_seconds`` the trace's seconds and
``flops_naive`` / ``hbm_bytes_naive`` -1.0 (no compiler analysis), and
adds ``per_device_rule`` with ``by_class``, the whole mesh's FLOPs and
bytes by class.  The rule (``per_device_rule``) names what the cell's
figures divide: "batch+model+moe" where the mesh route splits every dense
weight, the attention and the recurrences over 'model' as GSPMD does
under JAX's spec trees (every cell; a decode cell with ``--kv-quant``
names its int8-KV attention whole).

Usage:
  python -m repro_torch.launch.dryrun --arch tinyllama-1.1b --shape train_4k
  python -m repro_torch.launch.dryrun --all [--multi-pod] [--quant abfp]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
import traceback
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.configs.base import (
    SHAPES,
    ShapeConfig,
    get_config,
    list_archs,
)
from repro_torch.core import prng
from repro_torch.core.abfp import QuantConfig
from repro_torch.distributed.sharding import (
    P,
    Mesh,
    abfp_param_spec_tree,
    batch_spec,
    decode_state_spec_tree,
    map_with_path,
    param_spec_tree,
    zero1_state_sharding,
)
from repro_torch.launch import cost_analysis
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models.layers import Numerics
from repro_torch.models.lm import (
    abstract_params,
    decode_step,
    forward,
    init_decode_state,
    init_params,
    lm_head_logits,
)
from repro_torch.optim.optimizers import AdamW, AdamWState, constant
from repro_torch.training.train_lib import (
    CE_CHUNK,
    TrainConfig,
    TrainState,
    make_train_step,
)

ART_DIR = os.environ.get("REPRO_TORCH_DRYRUN_ART_DIR") or os.path.join(
    os.path.dirname(__file__), "..", "..", "..", "experiments",
    "dryrun_torch")


# What an artifact's per-device figures divide (``cost_analysis``): the
# batch over the data axes, MoE experts over 'model', and, where the cell
# runs the mesh route, every dense weight that JAX's spec tree splits.
RULE_MODEL = "batch+model+moe"


def per_device_rule(mcfg, kind: str) -> str:
    """The per-device rule a cell of ``kind`` follows for ``mcfg``: a
    decode cell with an int8 KV cache runs its attention whole."""
    if kind == "decode" and mcfg.kv_quant:
        return RULE_MODEL + "; int8 KV attention whole"
    return RULE_MODEL


def _quant_cfg(quant: str) -> QuantConfig:
    if quant == "float":
        return QuantConfig(mode="float")
    # Paper-faithful ABFP: tile 128, gain 8, 8/8/8 bits, 0.5 LSB ADC noise.
    return QuantConfig(mode="abfp_ref", tile_width=128, gain=8.0,
                       bits_w=8, bits_x=8, bits_y=8, noise_lsb=0.5)


def _shape(shape) -> ShapeConfig:
    return SHAPES[shape] if isinstance(shape, str) else shape


def input_specs(arch: str, shape, mcfg=None) -> dict:
    """Every model input of the cell as a ``meta`` tensor of JAX's shape
    and dtype (``shape``: a name of ``SHAPES`` or a ``ShapeConfig``;
    ``mcfg`` in place of the arch's config)."""
    mcfg = mcfg or get_config(arch)
    sc = _shape(shape)
    b, s = sc.global_batch, sc.seq_len

    def spec(shape, dtype):
        return torch.empty(shape, dtype=dtype, device="meta")

    out: dict = {}
    if sc.kind == "train":
        if mcfg.frontend == "vision_stub":
            out["embeds"] = spec((b, s, mcfg.d_model), torch.bfloat16)
            out["labels"] = spec((b, s), torch.int32)
        else:
            out["tokens"] = spec((b, s + 1), torch.int32)
        if mcfg.is_encoder_decoder:
            out["encoder_features"] = spec((b, s, mcfg.d_model),
                                           torch.bfloat16)
    elif sc.kind == "prefill":
        if mcfg.frontend == "vision_stub":
            out["tokens"] = spec((b, s, mcfg.d_model), torch.bfloat16)
        else:
            out["tokens"] = spec((b, s), torch.int32)
        if mcfg.is_encoder_decoder:
            out["encoder_features"] = spec((b, s, mcfg.d_model),
                                           torch.bfloat16)
    else:  # decode
        out["token"] = spec((b,), torch.int32)
    return out


def _materialize(specs: dict, vocab: int, device, seed: int) -> dict:
    """Real inputs of ``input_specs``' shapes on ``device``: token ids
    uniform below ``vocab``, float features standard normal, from
    ``seed``."""
    gen = torch.Generator().manual_seed(seed)
    out = {}
    for k, v in specs.items():
        if v.is_floating_point():
            t = torch.randn(v.shape, generator=gen).to(v.dtype)
        else:
            t = torch.randint(0, vocab, v.shape, generator=gen,
                              dtype=v.dtype)
        out[k] = t.to(device)
    return out


def make_mesh(shape, device="meta") -> Mesh:
    """A mesh of ``shape`` over the last ``len(shape)`` of ("pod", "data",
    "model") with every position on ``device`` (``--mesh-shape``)."""
    shape = tuple(int(v) for v in shape)
    devices = np.empty(shape, dtype=object)
    devices.fill(torch.device(device))
    return Mesh(devices, ("pod", "data", "model")[-len(shape):])


@dataclasses.dataclass
class Cell:
    """One cell, ready to run: ``fn(*args)`` is the step; ``arg_specs``
    mirrors ``args`` with each tensor's spec on ``mesh``; the batch's row
    and token counts feed the per-device rule; a train cell's
    ``grad_specs`` (its param specs and its moments' ZeRO-1 specs) place
    its gradient reduction."""
    fn: Any
    args: tuple
    arg_specs: tuple
    mesh: Mesh
    batch_rows: tuple
    token_rows: tuple
    mcfg: Any
    grad_specs: Optional[tuple] = None

    @property
    def head_rows(self) -> tuple:
        """The batch's row counts times the query and KV head counts."""
        heads = {self.mcfg.num_heads, self.mcfg.num_kv_heads}
        return tuple(sorted({r * h for r in self.batch_rows for h in heads}))


def build_cell(arch: str, shape, mesh: Mesh, quant: str = "float", *,
               device="meta", kv_quant: bool = False,
               compression: Optional[str] = None, microbatches: int = 4,
               seed: int = 0, mcfg=None) -> Cell:
    """The cell's step and arguments, as the JAX package's ``_run_cell``
    builds them: on ``meta`` (``abstract_params``, empty inputs) for the
    trace, or on another device with random weights from ``seed`` and
    random inputs (``mcfg`` replaces the arch's config, e.g. a smoke
    config)."""
    sc = _shape(shape)
    mcfg = dataclasses.replace(mcfg or get_config(arch),
                               remat=(sc.kind == "train"), kv_quant=kv_quant)
    qc = _quant_cfg(quant)
    meta = torch.device(device).type == "meta"
    params = (abstract_params(mcfg) if meta
              else init_params(seed, mcfg, device=device))
    pspec = (abfp_param_spec_tree(params, mesh) if quant == "abfp"
             else param_spec_tree(params, mesh))
    specs = input_specs(arch, sc, mcfg)
    batch = specs if meta else _materialize(specs, mcfg.vocab_size, device,
                                            seed + 1)
    key = prng.PRNGKey(seed)
    data = int(np.prod([mesh.shape[a] for a in ("pod", "data")
                        if a in mesh.axis_names]))
    b, s = sc.global_batch, sc.seq_len
    rows = (b,) if b % data == 0 else ()

    if sc.kind == "train":
        opt = AdamW(schedule=constant(1e-6))
        tcfg = TrainConfig(microbatches=microbatches, quant=qc,
                           compression=compression)
        init_state, train_step = make_train_step(
            mcfg, opt, tcfg, device=device, donate=True, mesh=mesh)
        state = init_state(params)
        z1 = map_with_path(lambda path, ns: ns.spec,
                           zero1_state_sharding(params, mesh, pspec))
        state_spec = TrainState(
            params=pspec,
            opt_state=AdamWState(step=P(), mu=z1, nu=z1, master=z1),
            ef=None if state.ef is None else type(state.ef)(pspec),
            step=P())
        batch_specs = {k: batch_spec(mesh, tuple(v.shape))
                       for k, v in batch.items()}
        mb = b // microbatches
        rows = (b, mb) if mb % data == 0 and rows else ()
        # Tokens: a microbatch's, the batch's, and a microbatch's per call
        # of the loss's chunked LM head.
        chunk = CE_CHUNK if s % CE_CHUNK == 0 else s
        return Cell(train_step, (state, batch, key),
                    (state_spec, batch_specs, None), mesh, rows,
                    (mb * s, b * s, mb * chunk) if rows else (), mcfg,
                    grad_specs=(pspec, z1))

    if sc.kind == "prefill":
        def prefill(params, batch, key):
            with torch.no_grad():
                nx = Numerics(qc, key)
                hidden, _ = forward(
                    params, batch["tokens"], mcfg, nx,
                    encoder_features=batch.get("encoder_features"),
                    return_hidden=True, mesh=mesh)
                return lm_head_logits(params, hidden[:, -1:], mcfg, nx,
                                      mesh=mesh)[:, 0]

        batch_specs = {k: batch_spec(mesh, tuple(v.shape))
                       for k, v in batch.items()}
        return Cell(prefill, (params, batch, key),
                    (pspec, batch_specs, None), mesh, rows,
                    (b * s,) if rows else (), mcfg)

    state = init_decode_state(mcfg, b, s, device=device)
    enc_kv = enc_spec = None
    if mcfg.is_encoder_decoder:
        kh, hd = mcfg.num_kv_heads, mcfg.resolved_head_dim
        if meta:
            kv = [torch.empty((b, s, kh, hd), dtype=torch.bfloat16,
                              device="meta") for _ in range(2)]
            enc_kv = [tuple(kv) for _ in range(mcfg.num_layers)]
        else:
            gen = torch.Generator().manual_seed(seed + 2)
            enc_kv = [tuple(torch.randn((b, s, kh, hd), generator=gen).to(
                torch.bfloat16).to(device) for _ in range(2))
                for _ in range(mcfg.num_layers)]
        axis = "model" if hd % mesh.shape["model"] == 0 else None
        bax = batch_spec(mesh, (b,))[0]
        enc_spec = [(P(bax, None, None, axis),) * 2] * mcfg.num_layers

    def decode(params, state, token, key, enc_kv=None):
        with torch.no_grad():
            return decode_step(params, state, token, mcfg,
                               Numerics(qc, key), enc_kv=enc_kv, mesh=mesh)

    return Cell(decode, (params, state, batch["token"], key, enc_kv),
                (pspec, decode_state_spec_tree(state, mesh),
                 batch_spec(mesh, (b,)), None, enc_spec), mesh, rows, (),
                mcfg)


def trace_cell(cell: Cell) -> dict:
    """``cost_analysis.traced_costs`` of the cell's step on its mesh."""
    return cost_analysis.traced_costs(
        cell.fn, *cell.args, mesh=cell.mesh, batch_rows=cell.batch_rows,
        token_rows=cell.token_rows, head_rows=cell.head_rows,
        arg_specs=cell.arg_specs, grad_specs=cell.grad_specs)


def _run_cell(arch: str, shape_name: str, mesh: Mesh, mesh_name: str,
              quant: str, save: bool = True, kv_quant: bool = False,
              compression: Optional[str] = None, microbatches: int = 4,
              tag: str = "") -> dict:
    t0 = time.time()
    sc = SHAPES[shape_name]
    cell = build_cell(arch, sc, mesh, quant, kv_quant=kv_quant,
                      compression=compression, microbatches=microbatches)
    costs = trace_cell(cell)
    compile_s = time.time() - t0
    mem = costs["memory"]
    live = costs["live_bytes"]
    colls = costs["collectives"]
    result = {
        "arch": arch, "shape": shape_name, "mesh": mesh_name,
        "quant": quant + tag, "kind": sc.kind, "chips": int(mesh.size),
        "flops_per_device": costs["flops"],
        "hbm_bytes_per_device": costs["hbm_bytes"],
        "hbm_bytes_pessimistic": costs["hbm_bytes_pessimistic"],
        "flops_naive": -1.0,
        "hbm_bytes_naive": -1.0,
        "collectives": colls,
        "memory": mem,
        "live_bytes_per_device": int(live),
        "fits_80g": bool(live <= mesh_lib.HBM_PER_CHIP),
        "compile_seconds": round(compile_s, 1),
        "flops_global": costs["flops_global"],
        "hbm_bytes_global": costs["hbm_bytes_global"],
        "per_device_rule": per_device_rule(cell.mcfg, sc.kind),
        "by_class": costs["by_class"],
    }
    print(f"[dryrun] {arch} x {shape_name} x {mesh_name} ({quant}): "
          f"traced in {compile_s:.0f}s; live/device = {live/2**30:.2f} GiB; "
          f"flops/device = {result['flops_per_device']:.3e}; "
          f"coll bytes/device = {colls['total']['bytes']:.3e}")
    print(f"  memory: {mem}")
    if save:
        os.makedirs(ART_DIR, exist_ok=True)
        fname = f"{arch}__{shape_name}__{mesh_name}__{quant}{tag}.json"
        with open(os.path.join(ART_DIR, fname), "w") as f:
            json.dump(result, f, indent=1)
    return result


def runnable_cells():
    """The 40-cell grid minus the JAX package's documented skips."""
    cells = []
    for arch in list_archs():
        mcfg = get_config(arch)
        for shape_name in SHAPES:
            if shape_name == "long_500k" and \
                    not mcfg.supports_long_context_decode:
                continue  # full-attention archs skip long_500k
            cells.append((arch, shape_name))
    return cells


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--quant", choices=("float", "abfp"), default="float")
    ap.add_argument("--mesh-shape", default=None,
                    help="override, e.g. '4,2' (mini test)")
    ap.add_argument("--kv-quant", action="store_true",
                    help="int8-ABFP KV cache (decode cells)")
    ap.add_argument("--compression", choices=("bf16", "int8"), default=None,
                    help="DP gradient compression (train cells)")
    ap.add_argument("--microbatches", type=int, default=4)
    ap.add_argument("--tag", default="",
                    help="suffix for the artifact filename")
    ap.add_argument("--continue-on-error", action="store_true")
    args = ap.parse_args()

    if args.mesh_shape:
        shape = tuple(int(x) for x in args.mesh_shape.split(","))
        mesh = make_mesh(shape)
        mesh_name = "x".join(map(str, shape))
    else:
        mesh = mesh_lib.make_production_mesh(multi_pod=args.multi_pod)
        mesh_name = "2x16x16" if args.multi_pod else "16x16"

    cells = runnable_cells() if args.all else [(args.arch, args.shape)]
    failures = []
    t0 = time.time()
    for arch, shape_name in cells:
        try:
            _run_cell(arch, shape_name, mesh, mesh_name, args.quant,
                      kv_quant=args.kv_quant, compression=args.compression,
                      microbatches=args.microbatches, tag=args.tag)
        except Exception as e:  # noqa: BLE001
            failures.append((arch, shape_name, repr(e)))
            print(f"[dryrun] FAILED {arch} x {shape_name}: {e}")
            traceback.print_exc()
            if not args.continue_on_error:
                return 1
    if failures:
        print(f"[dryrun] {len(failures)} failures: {failures}")
        return 1
    print(f"[dryrun] all {len(cells)} cells traced OK on {mesh_name} "
          f"in {time.time() - t0:.0f}s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
