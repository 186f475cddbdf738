"""DecoderRunner, RecurrentRunner and EncDecRunner: the seam between
``ServingEngine`` and ``repro_torch.models``.

A runner owns what the engine must know about one model family: how to
allocate the batched decode state (``init_state``, unpaged or PAGED), the
pass of each shape the engine runs (``make_pass``: the decode tick
``("decode",)`` or a chunk pass ``("prefill", bucket)``; either with
``"draw"`` appended when a row samples at a temperature), the slot-state
edits run between passes (``make_reset`` at admission, ``make_attach``
for a prefix-cache hit, ``make_copy_page`` for a copy-on-write split) and
what a request costs in pages (``capacity_cost``), and the decode state's
place on a mesh (``state_spec``, ``shard_state``).  ``DecoderRunner``
serves full-attention decoders, MoE ones included, ``RecurrentRunner``
the recurrent and hybrid families (fixed-size state per slot),
``EncDecRunner`` the encoder-decoders: an admission pass ``("admit",)``
encodes a request's features into its slot's cross-attention K/V
(``state["enc"]``), which every later pass reads.  Passes and the edits
update the decode state in place: every state tensor keeps its storage.

Static buffers
--------------
Each pass shape owns its inputs and outputs (``PassIO``), allocated once
on the engine's device: one int32 word array holds the tokens, the
per-row token counts, the previous-sample mask, the sampling inputs and
the pass's noise table (the seed table; in ``abfp_ref`` mode the key
table, two words per dense call), and the host fills it with ONE copy per
pass from pinned memory (``Staging``); under paging it also holds the (B, MP)
page table, which the pass body copies into ``state["page_table"]``
before the layers read it, so a replay runs under each pass's table;
``prev`` takes the previous pass's device sample by a device-to-device
copy; ``logits`` (B, V) f32 and ``sampled``
(B,) int32 are written by the pass.  The pass body reads nothing else
that varies, so a CUDA graph captured from it replays with each pass's
values (``serving.engine``).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.device import DeviceLike
from repro_torch.models.lm import (
    decode_step,
    encode,
    encode_cross_kv,
    init_decode_state,
    n_pass_words,
    pass_numerics,
    pass_words,
    prefill,
    sample_tokens,
)
from repro_torch.serving.pages import pages_needed

Tensor = torch.Tensor

# The int32 words of a pass's inputs, in order; "tokens" holds B x width
# words, "seeds" the noise table (seeds, or key words), "table" the B x MP
# page table (none unpaged), every other field B.
FIELDS = ("tokens", "n_tokens", "prev_mask", "temps", "uids", "idxs",
          "seeds", "table")


def _field_sizes(capacity: int, width: int, n_seeds: int,
                 max_pages: int) -> Dict[str, int]:
    sizes = {f: capacity for f in FIELDS}
    sizes.update(tokens=capacity * width, seeds=n_seeds,
                 table=capacity * max_pages)
    return sizes


class PassIO:
    """The static inputs and outputs of one pass shape on ``device``:
    ``capacity`` rows of ``width`` tokens (1 for the decode tick), a noise
    table of ``n_seeds`` words and, under paging, a (capacity,
    ``max_pages``) page table.  ``words`` is the int32 array the host
    fills; the named fields are views of it (``temps`` as f32)."""

    def __init__(self, capacity: int, width: int, n_seeds: int, vocab: int,
                 device, max_pages: int = 0):
        b = capacity
        sizes = _field_sizes(capacity, width, n_seeds, max_pages)
        self.capacity, self.width = capacity, width
        self.offsets: Dict[str, Tuple[int, int]] = {}
        at = 0
        for f in FIELDS:
            self.offsets[f] = (at, at + sizes[f])
            at += sizes[f]
        self.words = torch.zeros(at, dtype=torch.int32, device=device)
        view = {f: self.words[a:e] for f, (a, e) in self.offsets.items()}
        self.tokens = view["tokens"].view(b, width)
        self.n_tokens = view["n_tokens"]
        self.prev_mask = view["prev_mask"]
        self.temps = view["temps"].view(torch.float32)
        self.uids = view["uids"]
        self.idxs = view["idxs"]
        self.seeds = view["seeds"]
        self.table = view["table"].view(b, max_pages) if max_pages else None
        self.prev = torch.zeros(b, dtype=torch.int32, device=device)
        self.logits = torch.zeros((b, vocab), dtype=torch.float32,
                                  device=device)
        self.sampled = torch.zeros(b, dtype=torch.int32, device=device)

    @staticmethod
    def n_words(capacity: int, width: int, n_seeds: int,
                max_pages: int = 0) -> int:
        """The int32 words of a pass shape's inputs."""
        return sum(_field_sizes(capacity, width, n_seeds,
                                max_pages).values())

    def pack(self, **fields) -> np.ndarray:
        """The host word array of one pass from numpy fields (missing
        fields are 0; ``temps`` is stored by its f32 bits)."""
        out = np.zeros(self.words.numel(), np.int32)
        for f, v in fields.items():
            a, e = self.offsets[f]
            v = np.asarray(v)
            out[a:e] = (v.astype(np.float32).view(np.int32) if f == "temps"
                        else v.astype(np.int32)).reshape(-1)
        return out


class Staging:
    """A ring of ``depth`` host buffers (pinned on a GPU) for the one
    host-to-device copy of each pass.  A buffer is rewritten only after
    the copy that last read it has run (its CUDA event)."""

    def __init__(self, words: int, depth: int, device):
        self.cuda = torch.device(device).type == "cuda"
        self.bufs = [torch.zeros(words, dtype=torch.int32,
                                 pin_memory=self.cuda)
                     for _ in range(max(2, depth))]
        self.events = [None] * len(self.bufs)
        self.i = 0

    def copy(self, host: np.ndarray, dst: Tensor) -> None:
        i = self.i
        self.i = (i + 1) % len(self.bufs)
        if self.events[i] is not None:
            self.events[i].synchronize()
        buf = self.bufs[i][:host.size]
        buf.numpy()[:] = host
        dst.copy_(buf, non_blocking=True)
        if self.cuda:
            ev = torch.cuda.Event()
            ev.record()
            self.events[i] = ev


class DecoderRunner:
    """Decoder-only full-attention LM: KV caches grow per token and may
    live in the shared page pool."""

    #: The decode state grows with the sequence (the engine bounds a
    #: request by ``max_len`` or the page budget).
    fixed_state = False
    #: Prefix pages may be shared across requests.
    prefix_cache_ok = True
    #: Admission runs a pass of its own (``("admit",)``).
    needs_admission = False

    def __init__(self, mcfg: ModelConfig):
        self.mcfg = mcfg

    @property
    def paged_ok(self) -> bool:
        """Append-only full-attention KV caches may page."""
        return self.mcfg.attention_type == "full"

    def init_state(self, capacity: int, max_len: int,
                   device: DeviceLike = None, *,
                   page_size: Optional[int] = None,
                   pool_pages: Optional[int] = None) -> dict:
        return init_decode_state(self.mcfg, capacity, max_len, device,
                                 page_size=page_size, pool_pages=pool_pages)

    def n_seeds(self, quant) -> int:
        """The int32 words of a pass's noise table under ``quant``
        (``models.lm.n_pass_words``: a seed per dense call, a key of two
        words per call in ``abfp_ref`` mode)."""
        return n_pass_words(self.mcfg, quant)

    def seed_table(self, key, quant) -> np.ndarray:
        """The noise table of a pass under the root ``key``, as int32
        words (``models.lm.pass_words``)."""
        return pass_words(self.mcfg, quant, key)

    def accepts(self, req) -> bool:
        """Model-specific request validation beyond the engine's
        ``fits()``: a decoder takes any request."""
        return True

    def capacity_cost(self, total_tokens: int, page_size: int) -> int:
        """Pages a request of ``total_tokens`` (prompt + max_new) occupies
        at full length."""
        return pages_needed(total_tokens, page_size)

    def state_spec(self, state: dict, mesh) -> dict:
        """The decode state's specs on ``mesh``: slots over the data axes
        (``distributed.sharding.serving_state_spec_tree``)."""
        from repro_torch.distributed.sharding import serving_state_spec_tree
        return serving_state_spec_tree(state, mesh)

    def shard_state(self, state: dict, mesh) -> dict:
        """Place the decode state on ``mesh``.  Every position of a mesh
        of this port is the state's own device (a virtual mesh), so the
        placement keeps the state where it is: its specs are computed and
        validated, and a mesh on another device raises."""
        self.state_spec(state, mesh)
        devs = {t.device for t in state_tensors(state)}
        if not mesh.device_set() <= devs:
            raise ValueError(f"the mesh's devices {mesh.device_set()} are "
                             f"not the state's {devs}")
        return state

    def make_pass(self, shape_key: tuple, params, quant, seed: int,
                  capacity: int, device, sample: bool = True,
                  max_pages: int = 0, mesh=None
                  ) -> Tuple[PassIO, Callable[[dict], None]]:
        """The static buffers and the body of one pass shape: ``("decode",)``
        or ``("prefill", bucket)``, with ``"draw"`` appended for a pass in
        which some row samples at a temperature.

        ``body(state)`` runs the pass on ``state`` (in place) reading only
        the ``PassIO``: each row's input token is ``prev`` where
        ``prev_mask`` is set (the previous pass's device sample) and its
        host token otherwise; a prefill row takes ``n_tokens`` tokens of its
        chunk.  Noise seeds come from ``seeds``; with ``max_pages`` (a paged
        state) the body first copies ``table`` into ``state["page_table"]``.
        The body writes the
        logits at each row's last real token and, with ``sample``, the
        next token sampled on the device (the overlapped engine's tokens;
        the blocking engine samples on the host and skips it): the argmax,
        or under ``"draw"`` ``models.sample_tokens`` (JAX's Gumbel-max
        draw for temperature rows, the argmax for the others; its threefry
        is about 550 small kernels, which a greedy pass skips).  With a
        ``mesh`` every dense call of the body runs tensor-parallel
        (``models.layers.Numerics``)."""
        decode = shape_key[0] == "decode"
        draw = shape_key[-1] == "draw"
        width = 1 if decode else int(shape_key[1])
        io = PassIO(capacity, width, self.n_seeds(quant),
                    self.mcfg.vocab_size, device, max_pages)
        mcfg = self.mcfg

        def body(state: dict) -> None:
            if io.table is not None:
                state["page_table"].copy_(io.table)
            first = torch.where(io.prev_mask != 0, io.prev, io.tokens[:, 0])
            nx = pass_numerics(quant, io.seeds, mcfg, mesh=mesh)
            enc_kv = self.enc_kv(state)
            if decode:
                logits, _ = decode_step(params, state, first, mcfg, nx,
                                        enc_kv=enc_kv)
            else:
                toks = torch.cat([first[:, None], io.tokens[:, 1:]], dim=1)
                logits, _ = prefill(params, state, toks, io.n_tokens, mcfg,
                                    nx, enc_kv=enc_kv)
            io.logits.copy_(logits)
            if sample and draw:
                io.sampled.copy_(sample_tokens(logits, io.temps, io.uids,
                                               io.idxs, seed))
            elif sample:
                io.sampled.copy_(torch.argmax(logits, dim=-1))

        return io, body

    def enc_kv(self, state: dict):
        """The cross K/V the passes read from the state: none here."""
        return None

    def make_reset(self):
        """The slot reset ``(state, i) -> state``: every per-slot entry of
        row i (caches and ring buffers, lengths, recurrent state, position)
        back to its initial value, in place: sLSTM's stabilizer ``m`` (rank
        3 with the batch axis) to -1e30, everything else to 0, the JAX
        package's fill rule.  The page pools are global (other slots hold
        their pages) and the page table is the engine's (filled by every
        pass), so both stay."""
        def _reset(state, i):
            for layer in state["layers"]:
                for part in layer.values():
                    for name, t in part.items():
                        if not name.endswith("_pages"):
                            t[i] = -1e30 if name == "m" and t.ndim == 3 else 0
            state["position"][i] = 0
            return state

        return _reset

    def make_attach(self):
        """The prefix-cache attach ``(state, i, length) -> state``: slot i
        starts mid-sequence, its cache lengths and rope position at
        ``length`` (the shared prefix), in place."""
        def _attach(state, i, length):
            for layer in state["layers"]:
                if "kv" in layer:
                    layer["kv"]["length"][i] = length
            state["position"][i] = length
            return state

        return _attach

    def make_copy_page(self):
        """The copy-on-write page copy ``(state, src, dst) -> state``: page
        ``src`` duplicated into ``dst`` in every layer's pools, in place."""
        def _copy_page(state, src, dst):
            for layer in state["layers"]:
                for name, t in layer.get("kv", {}).items():
                    if name.endswith("_pages"):
                        t[dst].copy_(t[src])
            return state

        return _copy_page


class RecurrentRunner(DecoderRunner):
    """The ssm and hybrid families (xlstm, recurrentgemma): recurrent
    folds and ring-buffer window caches are FIXED-SIZE per slot, so a
    request costs no pages (``capacity_cost`` 0), is admissible at any
    total length, and runs unpaged (``paged_ok`` False)."""

    paged_ok = False
    fixed_state = True

    def capacity_cost(self, total_tokens: int, page_size: int) -> int:
        return 0


class AdmitIO:
    """The static inputs of the admission pass on ``device``, one int32
    word array as ``PassIO``'s: the request's ``features`` (enc_len,
    d_model) in the activation dtype (stored by their bits), the ``slot``
    index and the pass's seed table."""

    def __init__(self, enc_len: int, d_model: int, dtype, n_seeds: int,
                 device):
        nbytes = enc_len * d_model * torch.empty((), dtype=dtype
                                                 ).element_size()
        if nbytes % 4:
            raise ValueError("the features must fill whole int32 words")
        sizes = {"features": nbytes // 4, "slot": 1, "seeds": n_seeds}
        self.offsets: Dict[str, Tuple[int, int]] = {}
        at = 0
        for f, n in sizes.items():
            self.offsets[f] = (at, at + n)
            at += n
        self.words = torch.zeros(at, dtype=torch.int32, device=device)
        view = {f: self.words[a:e] for f, (a, e) in self.offsets.items()}
        self.dtype = dtype
        self.features = view["features"].view(dtype).view(enc_len, d_model)
        self.slot = view["slot"]
        self.seeds = view["seeds"]

    def pack(self, features: Tensor, slot: int,
             seeds: Optional[np.ndarray] = None) -> np.ndarray:
        """The host word array of one admission: ``features`` a CPU tensor
        (cast to the activation dtype here, as the encoder casts them)."""
        out = np.zeros(self.words.numel(), np.int32)
        a, e = self.offsets["features"]
        out[a:e] = features.to(self.dtype).contiguous().view(
            torch.int32).reshape(-1).numpy()
        out[self.offsets["slot"][0]] = slot
        if seeds is not None:
            a, e = self.offsets["seeds"]
            out[a:e] = seeds
        return out


class EncDecRunner(DecoderRunner):
    """Whisper-style encoder-decoder.  Admission runs ONE encoder pass
    over the request's frontend features (``make_pass(("admit",), ...)``)
    and writes the resulting cross-attention K/V into the slot's rows of
    ``state["enc"]``, in place (a captured decode or prefill pass keeps
    reading the same storage); decode then proceeds as a decoder-only
    model's, every pass reading each layer's K/V.  The self-attention KV
    pages as a decoder's does, but prefix-page sharing is off: a
    decoder's KV depends on the request's audio.

    ``enc_len`` is the fixed encoder frame count; a request must carry
    ``features`` of shape (enc_len, d_model)."""

    needs_admission = True
    prefix_cache_ok = False

    DEFAULT_ENC_LEN = 64

    def __init__(self, mcfg: ModelConfig, enc_len: int = DEFAULT_ENC_LEN):
        if not mcfg.is_encoder_decoder:
            raise ValueError(f"{mcfg.name} is not an encoder-decoder")
        super().__init__(mcfg)
        self.enc_len = int(enc_len)

    def accepts(self, req) -> bool:
        feats = getattr(req, "features", None)
        if feats is None:
            return False
        return (tuple(getattr(feats, "shape", ()))
                == (self.enc_len, self.mcfg.d_model))

    def init_state(self, capacity: int, max_len: int,
                   device: DeviceLike = None, *,
                   page_size: Optional[int] = None,
                   pool_pages: Optional[int] = None) -> dict:
        """The decoder's state plus ``state["enc"]``: per decoder layer the
        cross ``k`` and ``v`` of every slot, (capacity, enc_len, KH, D) in
        the activation dtype."""
        state = super().init_state(capacity, max_len, device,
                                   page_size=page_size,
                                   pool_pages=pool_pages)
        mcfg = self.mcfg
        shape = (capacity, self.enc_len, mcfg.num_kv_heads,
                 mcfg.resolved_head_dim)
        dev = state["position"].device
        state["enc"] = [
            {n: torch.zeros(shape, dtype=mcfg.activation_dtype, device=dev)
             for n in ("k", "v")} for _ in range(mcfg.num_layers)]
        return state

    def enc_kv(self, state: dict):
        return [(e["k"], e["v"]) for e in state["enc"]]

    def make_pass(self, shape_key: tuple, params, quant, seed: int,
                  capacity: int, device, sample: bool = True,
                  max_pages: int = 0, mesh=None):
        """As ``DecoderRunner.make_pass``, plus the admission pass
        ``("admit",)``: ``(AdmitIO, body)``, whose body encodes
        ``io.features`` (``models.lm.encode``, encoder layer g under fold
        1000 + g) and writes its cross K/V (``encode_cross_kv``, the root's
        calls 0 and 1) into row ``io.slot`` of every ``state["enc"]``
        entry.  The slot and the seeds are device data, so one capture
        serves every admission."""
        if shape_key[0] != "admit":
            return super().make_pass(shape_key, params, quant, seed,
                                     capacity, device, sample, max_pages,
                                     mesh)
        mcfg = self.mcfg
        io = AdmitIO(self.enc_len, mcfg.d_model, mcfg.activation_dtype,
                     self.n_seeds(quant), device)

        def body(state: dict) -> None:
            nx = pass_numerics(quant, io.seeds, mcfg, mesh=mesh)
            enc_out = encode(params, io.features[None], mcfg, nx)
            slot = io.slot.long()
            for e, (k, v) in zip(state["enc"],
                                 encode_cross_kv(params, enc_out, mcfg, nx)):
                e["k"].index_copy_(0, slot, k.to(e["k"].dtype))
                e["v"].index_copy_(0, slot, v.to(e["v"].dtype))

        return io, body


def state_tensors(state) -> list:
    """Every tensor of a decode state, in a fixed order."""
    if isinstance(state, dict):
        return [t for k in sorted(state) for t in state_tensors(state[k])]
    if isinstance(state, list):
        return [t for v in state for t in state_tensors(v)]
    return [state]


def runner_for(mcfg: ModelConfig, **kwargs) -> DecoderRunner:
    """The runner of a config, as the JAX package's ``runner_for`` picks
    it, passing ``kwargs`` on: ``EncDecRunner`` (``enc_len``) for an
    encoder-decoder,
    ``RecurrentRunner`` when the block pattern holds a non-attention kind
    (``attention_type`` hybrid or recurrent), else ``DecoderRunner`` (MoE
    decoders and stub-frontend ones included); anything the port does not
    serve raises."""
    from repro_torch.models.lm import check_supported
    check_supported(mcfg, serving=True)
    if mcfg.is_encoder_decoder:
        return EncDecRunner(mcfg, **kwargs)
    if mcfg.attention_type in ("hybrid", "recurrent"):
        return RecurrentRunner(mcfg, **kwargs)
    return DecoderRunner(mcfg, **kwargs)
