"""AOT export of the recognizer as a self-contained serving bundle
(counterpart of `early_exit_tpu/serving/export.py`).

The end-to-end program (waveform -> log-mel -> all-exit encoder ->
greedy CTC tokens + per-exit confidence) is captured by `torch.export`
once per padded (B, S) bucket, with the weights and the block kernel's
folded layout held as the program's constants: the counterpart of the
JAX package's StableHLO. For the "cuda" platform AOTInductor also
compiles each captured program into a package. The kernels are
`torch.library` ops (`ops/kernels/library.py`), so a graph holds the
block kernel as one node per block, and a compiled program calls it
through the dispatcher.

A consumer (`ExportedRecognizer`) runs a bundle with no model code:
torch, numpy and the op registration, which builds or loads the
kernels' libraries at their first CUDA launch. On CUDA it runs the
AOTInductor packages (`aoti_load_package`), on the CPU the captured
programs (`torch.export.load(...).module()`).

Bundle format, a plain zip archive:
  manifest.json                    shapes, model and audio metadata, the
                                   platforms and the ops the programs call
  programs/<platform>/<key>.pt2    `torch.export.save` of each program
  aoti/<key>.pt2                   AOTInductor package (platform "cuda")
  vocab.json (optional)            id -> piece table for `detokenize`

Keys, as in the JAX package: "<B>x<S>" (a bucket), "poly" (symbolic
(b, s), min_samples <= s <= symbolic_max_samples), "gated/<B>x<S>",
"cascade_a/<B>x<S>", "cascade_b/<B>x<S>"; the gated poly program is one
program an exit, "gated/poly/<e>" (`GatedFirstExit`).

Program contracts (all outputs int32 but conf):
  all-exit:  (wav f32 (B, S), n_samples i32 (B,)) ->
             tokens (E, B, T'), n_tok (E, B), conf f32 (E, B)
  gated:     (wav, n_samples, threshold f32 ()) ->
             tokens (B, T'), n_tok (B,), chosen_exit (B,) 1-based
  cascade_a: (wav, n_samples, thresholds f32 (E,)) ->
             tokens (B, T'), n_tok (B,), chosen (B,), accepted (B,),
             sub_len (B,), h_k (B, T', D)
  cascade_b: (h_k (b, T', D), sub_len (b,), thresholds (E,)) ->
             tokens (b, T'), n_tok (b,), chosen (b,); b symbolic, 1..B

Two faults of the JAX export are not repeated: `cascade()` on a shape
only the poly program covers raises a ValueError naming the cascade
shapes, and phase B runs the packed escalated rows (a multiple of
`PACK_BATCH`, at most the bucket's B), not the full batch.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import io
import json
import multiprocessing
import os
import tempfile
import time
import zipfile
from concurrent.futures import ProcessPoolExecutor
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from early_exit_tpu_torch import runtime
from early_exit_tpu_torch.ops import ctc, frontend
from early_exit_tpu_torch.ops.kernels import conformer_block as kcb
from early_exit_tpu_torch.ops.kernels import library
from early_exit_tpu_torch.serving.packing import PACK_BATCH, pack_escalation_indices

_FORMAT = "eet-torch-export-1"


@dataclasses.dataclass
class ExportBundle:
    manifest: dict
    programs: Dict[str, Dict[str, bytes]]   # platform -> key -> torch.export.save
    packages: Dict[str, bytes] = dataclasses.field(default_factory=dict)  # AOTI, cuda
    vocab: Optional[list] = None


def _shape_key(b: int, s: int) -> str:
    return f"{int(b)}x{int(s)}"


# ---------------------------------------------------------------- programs

class _Program(nn.Module):
    """A serving program over `model`, which it closes over (it is not a
    submodule): only the tensors the program reads become constants of
    the captured graph. The kernel layout of every fused stack of the
    model (`model.stacks()`: the flagship's and the splitformer's one, the
    zipformer's six), folded once here, is held as buffers and pinned into
    the stacks while the program runs, so the graph holds no folding ops.
    `layers` keeps the blocks of the first stack that a cascade phase runs
    (default all)."""

    def __init__(self, model, audio_cfg, gate_score: str, layers=None):
        super().__init__()
        object.__setattr__(self, "model", model)
        self.acfg = audio_cfg
        self.gate_score = gate_score
        self.layout = None
        if model.cfg.fused_block:
            self.layout = nn.ModuleList()
            for s, stack in enumerate(model.stacks()):
                names = kcb.OP_ORDER_INT8 if stack.cfg.quant == "int8" else kcb.PARAM_ORDER
                used = range(len(stack.blocks)) if layers is None or s else layers
                blocks = nn.ModuleList()
                for i, f in enumerate(stack.folded()):
                    m = nn.Module()
                    for n in names if i in used else ():
                        m.register_buffer(n, f[n])
                    blocks.append(m)
                self.layout.append(blocks)

    @contextlib.contextmanager
    def _pinned(self):
        if self.layout is None:
            yield
            return
        stacks = self.model.stacks()
        for stack, blocks in zip(stacks, self.layout):
            stack.pin_folded([dict(m.named_buffers()) for m in blocks])
        try:
            yield
        finally:
            for stack in stacks:
                stack.pin_folded(None)

    def _features(self, wav, n_samples):
        feats = frontend.mel_spectrogram(wav, self.acfg, method=self.acfg.mel_method)
        return feats, frontend.mel_lengths(n_samples, self.acfg.hop_length)


class ServeProgram(_Program):
    """The all-exit program: every exit's greedy tokens and confidence."""

    def forward(self, wav, n_samples):
        from early_exit_tpu_torch.models.early_exit_gate import exit_confidence
        feats, lengths = self._features(wav, n_samples)
        with self._pinned():
            logp, sub_len = self.model.apply(feats, lengths)
        E, B, Tp, V = logp.shape
        mask = torch.arange(Tp, device=wav.device)[None, :] < sub_len[:, None]
        flat = logp.reshape(E * B, Tp, V)
        toks, n_tok = ctc.greedy_decode(flat, sub_len.repeat(E),
                                        blank=self.model.cfg.blank_id)
        conf = exit_confidence(flat, mask.repeat(E, 1), self.gate_score)
        return (toks.reshape(E, B, Tp).to(torch.int32),
                n_tok.reshape(E, B).to(torch.int32),
                conf.reshape(E, B).to(torch.float32))


class GatedServeProgram(_Program):
    """The work-avoiding variant: `gated_apply`'s exit-by-exit conds stop
    running the trunk once every row clears the runtime threshold."""

    def forward(self, wav, n_samples, threshold):
        from early_exit_tpu_torch.models.early_exit_gate import gated_apply
        feats, lengths = self._features(wav, n_samples)
        with self._pinned():
            logp, chosen, sub_len, _ = gated_apply(
                self.model, feats, lengths, threshold=threshold,
                item_mask=(n_samples > 0).to(torch.float32), score=self.gate_score)
        toks, n_tok = ctc.greedy_decode(logp, sub_len, blank=self.model.cfg.blank_id)
        return toks.to(torch.int32), n_tok.to(torch.int32), chosen.to(torch.int32)


class GatedFirstExit(_Program):
    """The stepped gated program: one program an exit, with no
    `torch.cond`, which `ExportedRecognizer.gated` steps on the host while
    a row is not done, as `gated_apply`'s conds run them. The poly
    programs of every model take this form: AOTInductor (torch 2.11)
    cannot compile the splitformer's cond program (ROADMAP C8), and on an
    H100 the flagship's stepped program beats its cond program when the
    rows stop at an early exit (the cond program's skipped branches still
    copy the whole carry) and is slower when every row runs every exit
    (one program call and one greedy decode an exit): `chip_smoke.py`
    phase 11 times both (PERF.md). This is exit 1: the features, the
    embedding, what the later exits
    read (the mask, the sub-lengths, the splitformer's branch operands),
    exit 1's blocks (and branch), head and gate (`gate_exit`). (wav,
    n_samples, threshold ()) -> (hidden, chosen_lp, chosen_exit, done,
    mask, sub_len, *branch operands (down, ds_mask, up, or none), tokens,
    n_tok), the greedy tokens of chosen_lp."""

    def __init__(self, model, audio_cfg, gate_score, e: int = 0):
        npe = model.cfg.n_enc_layers_per_exit
        super().__init__(model, audio_cfg, gate_score, range(e * npe, (e + 1) * npe))
        self.e = e

    def _exit(self, h, chosen_lp, chosen_exit, done, mask, sub_len, ops, threshold):
        from early_exit_tpu_torch.models.early_exit_gate import gate_exit
        with self._pinned():
            h, chosen_lp, chosen_exit, done = gate_exit(
                self.model, self.e, h, chosen_lp, chosen_exit, done, mask, threshold,
                score=self.gate_score, temperature=None, branch_ops=ops)
        toks, n_tok = ctc.greedy_decode(chosen_lp, sub_len, blank=self.model.cfg.blank_id)
        return h, chosen_lp, chosen_exit, done, toks.to(torch.int32), n_tok.to(torch.int32)

    def forward(self, wav, n_samples, threshold):
        feats, lengths = self._features(wav, n_samples)
        h, sub_len, mask = self.model.frontend_embed(feats, lengths)
        B, T, _ = h.shape
        ops = (self.model.branch_operands(T, lengths, sub_len)
               if self.model.cfg.model_type == "splitformer" else ())
        mask, *ops = (t.clone(memory_format=torch.contiguous_format) for t in (mask, *ops))
        done = (n_samples > 0).to(torch.float32) < 0.5       # padding rows are done
        chosen_lp = torch.zeros(B, T, self.model.cfg.vocab_size, device=wav.device)
        chosen_exit = torch.zeros(B, dtype=torch.int32, device=wav.device)
        h, chosen_lp, chosen_exit, done, toks, n_tok = self._exit(
            h, chosen_lp, chosen_exit, done, mask, sub_len, ops, threshold)
        return (h, chosen_lp, chosen_exit, done, mask, sub_len, *ops, toks, n_tok)


class GatedNextExit(GatedFirstExit):
    """Exit e + 1 > 1 of the stepped gated program (`GatedFirstExit`) of a
    model with no branch: (hidden, chosen_lp, chosen_exit, done, mask,
    sub_len, threshold) -> (hidden, chosen_lp, chosen_exit, done, tokens,
    n_tok)."""

    def forward(self, h, chosen_lp, chosen_exit, done, mask, sub_len, threshold):
        return self._exit(h, chosen_lp, chosen_exit, done, mask, sub_len, (), threshold)


class GatedNextBranchExit(GatedFirstExit):
    """`GatedNextExit` of the splitformer, which takes its branch's
    operands (down, ds_mask, up) before the threshold."""

    def forward(self, h, chosen_lp, chosen_exit, done, mask, sub_len, down, ds_mask, up,
                threshold):
        return self._exit(h, chosen_lp, chosen_exit, done, mask, sub_len,
                          (down, ds_mask, up), threshold)


class CascadeA(_Program):
    """Cascade phase A (`serving/cascade.py::shallow_apply`): exits 1..k
    on every row; depth and temperatures baked, thresholds at run time."""

    def __init__(self, model, audio_cfg, gate_score, k, temperatures):
        super().__init__(model, audio_cfg, gate_score, self._layers(model, int(k)))
        self.k, self.temperatures = int(k), temperatures

    @staticmethod
    def _layers(model, k):
        return range(k * model.cfg.n_enc_layers_per_exit)

    def forward(self, wav, n_samples, thresholds):
        from early_exit_tpu_torch.serving import cascade
        feats, lengths = self._features(wav, n_samples)
        with self._pinned():
            logp, chosen, accepted, sub_len, h_k = cascade.shallow_apply(
                self.model, feats, lengths, k=self.k, threshold=thresholds,
                score=self.gate_score, temperatures=self.temperatures,
                item_mask=(n_samples > 0).to(torch.float32))
        toks, n_tok = ctc.greedy_decode(logp, sub_len, blank=self.model.cfg.blank_id)
        return (toks.to(torch.int32), n_tok.to(torch.int32), chosen.to(torch.int32),
                accepted.to(torch.int32), sub_len.to(torch.int32), h_k)


class CascadeB(CascadeA):
    """Cascade phase B (`continue_apply`): exits k+1..E from phase A's
    hidden state, for the packed escalated rows only."""

    @staticmethod
    def _layers(model, k):
        return range(k * model.cfg.n_enc_layers_per_exit,
                     model.cfg.n_enc_exits * model.cfg.n_enc_layers_per_exit)

    def forward(self, h_k, sub_len, thresholds):
        from early_exit_tpu_torch.serving import cascade
        with self._pinned():
            logp, chosen = cascade.continue_apply(
                self.model, h_k, sub_len, k=self.k, threshold=thresholds,
                score=self.gate_score, temperatures=self.temperatures)
        toks, n_tok = ctc.greedy_decode(logp, sub_len, blank=self.model.cfg.blank_id)
        return toks.to(torch.int32), n_tok.to(torch.int32), chosen.to(torch.int32)


def make_serve_fn(model, audio_cfg, *, gate_score: str = "maxprob") -> ServeProgram:
    """The all-exit program as an `nn.Module` (eval mode)."""
    return ServeProgram(model.eval(), audio_cfg, gate_score)


def make_gated_serve_fn(model, audio_cfg, *,
                        gate_score: str = "maxprob") -> GatedServeProgram:
    """The gated program: (wav, n_samples, threshold ()) -> (tokens,
    n_tok, chosen_exit)."""
    return GatedServeProgram(model.eval(), audio_cfg, gate_score)


def make_cascade_fns(model, audio_cfg, *, k: int, gate_score: str = "maxprob",
                     gate_temperatures=None) -> Tuple[CascadeA, CascadeB]:
    """The two cascade programs; phase-A depth k and the temperatures are
    baked, the per-exit thresholds stay a runtime (E,) tensor."""
    model = model.eval()
    return (CascadeA(model, audio_cfg, gate_score, k, gate_temperatures),
            CascadeB(model, audio_cfg, gate_score, k, gate_temperatures))


# ---------------------------------------------------------------- export

def _ops_called(ep) -> Dict[str, int]:
    """Nodes per `eet::` op in a captured program, cond branches included."""
    count: Dict[str, int] = {}
    for gm in ep.graph_module.modules():
        if not isinstance(gm, torch.fx.GraphModule):
            continue
        for node in gm.graph.nodes:
            t = node.target
            if (node.op == "call_function" and isinstance(t, torch._ops.OpOverload)
                    and t.namespace == library.NAMESPACE):
                name = f"{t.namespace}::{t._opname}"
                count[name] = count.get(name, 0) + 1
    return count


def _capture(program, args, dynamic_shapes=None, *, size_oblivious=False):
    """torch.export of program at args. size_oblivious: a size check that
    the tracer meets (is this axis 1, so a view or a broadcast?) takes the
    answer that holds for every size, and adds no guard, so a program over
    a symbolic time axis also serves the lengths where an axis has one
    frame (the poly program from hop * 10 samples: T' = 2, the
    splitformer's branch and the zipformer's deepest stage 1)."""
    # torch.export traces a cond through dynamo, whose cache from an
    # earlier capture at other shapes could specialize this one
    torch._dynamo.reset()
    with torch.no_grad(), torch.fx.experimental._config.patch(
            backed_size_oblivious=size_oblivious):
        ep = torch.export.export(program, args, dynamic_shapes=dynamic_shapes,
                                 strict=False)
    _spell_sym_sums(ep)
    return ep


def _spell_sym_sums(ep) -> None:
    """Each `torch.sym_sum` node (dynamo writes a size sum inside a cond
    branch so, e.g. a strided slice's length 1 + T) as a chain of plain
    `+`, which `torch.export.save` can serialize."""
    import operator

    def val(t):
        return t.meta["val"] if isinstance(t, torch.fx.Node) else t

    for gm in ep.graph_module.modules():
        if not isinstance(gm, torch.fx.GraphModule):
            continue
        changed = False
        for node in list(gm.graph.nodes):
            if node.op != "call_function" or node.target is not torch.sym_sum:
                continue
            terms = list(node.args[0])
            acc = terms[0]
            with gm.graph.inserting_before(node):
                for i, t in enumerate(terms[1:]):
                    total = val(acc) + val(t)
                    acc = gm.graph.create_node("call_function", operator.add, (acc, t),
                                               name=f"{node.name}_plus{i}")
                    acc.meta["val"] = total
            node.replace_all_uses_with(acc)
            gm.graph.erase_node(node)
            changed = True
        if changed:
            gm.recompile()


def _saved(ep) -> bytes:
    buf = io.BytesIO()
    torch.export.save(ep, buf)
    return buf.getvalue()


def _compile_file(ep_path: str, path: str, threads: int) -> float:
    """Compile the program saved at ep_path into an AOTInductor package
    at path, in a worker process with `threads` compile threads; returns
    the seconds the compile took.

    The generated code rounds where the eager ops round and contracts no
    multiply-add (`emulate_precision_casts`): the bf16 trunk amplifies a
    last-place difference of its input, so a program that fused the
    frontend's arithmetic otherwise decides other exits than the eager
    path next to a threshold. The C++ wrapper is built by the `g++` on
    PATH, the compiler PyTorch's own libraries are built against, not by
    $CXX: a package built by another toolchain's libstdc++ can crash the
    process that loads it."""
    torch._inductor.config.compile_threads = threads
    runtime.exact_float32()
    ep = torch.export.load(ep_path)
    t0 = time.perf_counter()
    with torch._inductor.config.patch({"cpp.cxx": (None, "g++"),
                                       "emulate_precision_casts": True}):
        torch._inductor.aoti_compile_and_package(ep, package_path=path)
    return time.perf_counter() - t0


def _compile_all(saved: Dict[str, bytes], tmp: str) -> Dict[str, Tuple[bytes, float]]:
    """AOTInductor packages of the saved programs, compiled at once: one
    spawned process each, sharing the host's cores. Returns key ->
    (package, compile seconds)."""
    ctx = multiprocessing.get_context("spawn")
    threads = max(1, (os.cpu_count() or 1) // len(saved))
    jobs = {}
    with ProcessPoolExecutor(max_workers=len(saved), mp_context=ctx) as pool:
        for key, blob in saved.items():
            stem = os.path.join(tmp, key.replace("/", "_"))
            with open(stem + ".ep.pt2", "wb") as f:
                f.write(blob)
            jobs[key] = pool.submit(_compile_file, stem + ".ep.pt2", stem + ".pt2",
                                    threads)
        secs = {key: job.result() for key, job in jobs.items()}
    out = {}
    for key in saved:
        with open(os.path.join(tmp, key.replace("/", "_") + ".pt2"), "rb") as f:
            out[key] = (f.read(), secs[key])
    return out


def _on(model, dev: torch.device):
    """The model on dev: itself when it is there, else a copy."""
    if next(model.parameters()).device == dev:
        return model
    return copy.deepcopy(model).to(dev)


def export_recognizer(model, audio_cfg, shapes: Sequence[Tuple[int, int]] = (), *,
                      platforms: Sequence[str] = ("cuda",),
                      gate_score: str = "maxprob",
                      symbolic_max_samples: Optional[int] = None,
                      gated: bool = False,
                      cascade_k: Optional[int] = None,
                      gate_temperatures=None,
                      tokenizer=None,
                      compile_aoti: bool = True) -> ExportBundle:
    """Capture the serving programs for each (B, S) bucket, on each
    platform ("cpu", "cuda"), and compile them with AOTInductor for
    "cuda" (which needs a GPU). shapes: padded (batch, samples) buckets; a
    runner pads a smaller input up to the closest covering bucket.

    symbolic_max_samples: also one program over symbolic (b, s) with
    hop * 10 <= s <= symbolic_max_samples (and its gated variant with
    gated), for any model: the JAX package's bound, which the manifest
    records as `min_samples`. The program takes every length in
    that range as it is; only a shorter request is padded up to the bound,
    as the JAX package's runner pads it. On the CPU a fused stack runs the
    block kernel's plain version only up to T' = 512, as the JAX package:
    the bound must keep the model's largest stack length (`_stack_frames`)
    there, or export raises. The gated poly program is one program an exit
    ("gated/poly/<e>", `GatedFirstExit`), stepped by
    `ExportedRecognizer.gated`, for every model.

    Any CTC model of the registry exports its all-exit program (the
    zipformer's has one exit). gated: also the gated programs (threshold
    a runtime scalar), for `GATED_MODEL_TYPES`. cascade_k: also the two
    cascade programs (the flagship only) at that phase-A depth, for
    each bucket (not for the poly program), with gate_temperatures baked.
    compile_aoti=False leaves the "cuda" programs uncompiled, for
    `compile_bundles` to compile several bundles' at once.
    """
    from early_exit_tpu_torch.models import registry
    cfg = model.cfg
    if gated:
        registry.require_gated(cfg)
    if cascade_k is not None:
        registry.require_cascade(cfg)
    E = cfg.n_enc_exits
    hop = int(audio_cfg.hop_length)
    if not shapes and symbolic_max_samples is None:
        raise ValueError("export_recognizer: need shapes and/or "
                         "symbolic_max_samples")
    unknown = set(platforms) - {"cpu", "cuda"}
    if unknown:
        raise ValueError(f"export_recognizer: unknown platforms {sorted(unknown)}; "
                         f"the port exports for 'cpu' and 'cuda'")
    if symbolic_max_samples is not None:
        from early_exit_tpu_torch.models.conformer import FUSED_MAX_T
        s_min = hop * 10
        if symbolic_max_samples < s_min:
            raise ValueError(f"symbolic_max_samples must be >= {s_min}")
        t_max = max(_stack_frames(cfg, symbolic_max_samples, hop))
        if "cpu" in platforms and cfg.fused_block and t_max > FUSED_MAX_T:
            s_top = s_min
            while max(_stack_frames(cfg, s_top + hop, hop)) <= FUSED_MAX_T:
                s_top += hop
            raise ValueError(
                f"symbolic_max_samples={symbolic_max_samples} gives T' up to "
                f"{t_max}; on the CPU the fused stack takes T' <= {FUSED_MAX_T} "
                f"(the JAX package's rule), so the poly program's bound must "
                f"stay within {s_top + hop - 1} samples")
    programs: Dict[str, Dict[str, bytes]] = {}
    meta_shapes: Dict[str, dict] = {}
    ops: Dict[str, Dict[str, int]] = {}
    for plat in platforms:
        dev = runtime.resolve_device(plat)
        if dev.type == "cuda":
            runtime.exact_float32()
        m = _on(model, dev)
        serve = make_serve_fn(m, audio_cfg, gate_score=gate_score)
        gated_p = make_gated_serve_fn(m, audio_cfg, gate_score=gate_score) \
            if gated else None
        casc = None
        if cascade_k is not None:
            casc = make_cascade_fns(m, audio_cfg, k=cascade_k, gate_score=gate_score,
                                    gate_temperatures=gate_temperatures)
        thr = torch.zeros((), device=dev)
        thr_v = torch.zeros(E, device=dev)
        eps: Dict[str, object] = {}
        for b, s in shapes:
            key = _shape_key(b, s)
            wav = torch.zeros(b, s, device=dev)
            n = torch.full((b,), s, dtype=torch.int32, device=dev)
            eps[key] = _capture(serve, (wav, n))
            if gated_p is not None:
                eps["gated/" + key] = _capture(gated_p, (wav, n, thr))
            if casc is not None:
                a_ep = _capture(casc[0], (wav, n, thr_v))
                eps["cascade_a/" + key] = a_ep
                with torch.no_grad():
                    *_, sl, h_k = casc[0](wav, n, thr_v)
                dyn = None
                if b > 1:
                    nb = torch.export.Dim("b", min=1, max=b)
                    dyn = ({0: nb}, {0: nb}, None)
                eps["cascade_b/" + key] = _capture(casc[1], (h_k, sl, thr_v), dyn)
        if symbolic_max_samples is not None:
            # DYNAMIC: guards that hold over the whole range (sizes != 1,
            # which the solver cannot prove through the floor divisions)
            # become the program's runtime checks instead of errors
            nb = torch.export.Dim.DYNAMIC(min=1)
            ns = torch.export.Dim.DYNAMIC(min=s_min, max=int(symbolic_max_samples))
            s_ex = max(s_min, min(int(symbolic_max_samples), 4 * s_min))
            wav = torch.zeros(2, s_ex, device=dev)
            n = torch.full((2,), s_ex, dtype=torch.int32, device=dev)
            eps["poly"] = _capture(serve, (wav, n), ({0: nb, 1: ns}, {0: nb}),
                                   size_oblivious=True)
            if gated_p is not None:
                eps.update(_capture_gated_exits(m, audio_cfg, gate_score, wav, n, nb, ns))
        programs[plat] = {k: _saved(ep) for k, ep in eps.items()}
        ops[plat] = {k: _ops_called(ep) for k, ep in eps.items()}
    # shapes per bucket, and the exits, from the captured all-exit
    # programs' outputs (the zipformer has one exit over its own T'')
    for b, s in shapes:
        toks, n_tok, conf = _out_shapes(eps[_shape_key(b, s)])
        meta_shapes[_shape_key(b, s)] = {
            "wav": [b, s], "tokens": toks, "n_tok": n_tok, "conf": conf}
    n_exits = _out_shapes(eps[_shape_key(*shapes[0]) if shapes else "poly"])[2][0]
    if symbolic_max_samples is not None:
        meta_shapes["poly"] = {"wav": ["b", "s"], "min_samples": s_min,
                               "max_samples": int(symbolic_max_samples)}
    vocab = None
    if tokenizer is not None and hasattr(tokenizer, "id_to_piece"):
        vocab = [tokenizer.id_to_piece(i) for i in range(tokenizer.get_piece_size())]
    manifest = {
        "format": _FORMAT,
        "platforms": list(platforms),
        "gate_score": gate_score,
        "gated": bool(gated),
        "cascade_k": int(cascade_k) if cascade_k is not None else None,
        "blank_id": int(cfg.blank_id),
        "n_exits": int(n_exits),
        "sample_rate": int(audio_cfg.sample_rate),
        "hop_length": hop,
        "shapes": meta_shapes,
        "model": {"d_model": int(cfg.d_model), "vocab": int(cfg.vocab_size)},
        "ops": sorted({name for per in ops.values() for c in per.values()
                       for name in c}),
        "op_nodes": ops,
        "aoti_compile_s": {},
        "has_vocab": vocab is not None,
    }
    bundle = ExportBundle(manifest=manifest, programs=programs, packages={},
                          vocab=vocab)
    if "cuda" in platforms and compile_aoti:
        compile_bundles({"": bundle})
    return bundle


def _capture_gated_exits(model, audio_cfg, gate_score, wav, n, nb, ns) -> dict:
    """The stepped gated poly program, one program an exit
    (`GatedFirstExit`, then `GatedNextExit` or, for the splitformer,
    `GatedNextBranchExit`): "gated/poly/<e>", e = 0 .. E-1. The later
    exits' T' (and the branch's ceil(T'/2)) are dimensions of their own,
    captured on the example outputs of the exits before them."""
    E = model.cfg.n_enc_exits
    thr = torch.zeros((), device=wav.device)
    first = GatedFirstExit(model, audio_cfg, gate_score)
    eps = {"gated/poly/0": _capture(first, (wav, n, thr), ({0: nb, 1: ns}, {0: nb}, None),
                                    size_oblivious=True)}
    with torch.no_grad():
        h, lp, chosen, done, mask, sub_len, *ops = first(wav, n, thr)[:-2]
    dyn = torch.export.Dim.DYNAMIC
    nt, nd = dyn(min=1), dyn(min=1)
    op_shapes = ({0: nd}, {0: nb, 1: nd}, {0: nt}) if ops else ()
    shapes = ({0: nb, 1: nt}, {0: nb, 1: nt}, {0: nb}, {0: nb}, {0: nb, 1: nt}, {0: nb},
              *op_shapes, None)
    step_cls = GatedNextBranchExit if ops else GatedNextExit
    for e in range(1, E):
        step = step_cls(model, audio_cfg, gate_score, e)
        args = (h, lp, chosen, done, mask, sub_len, *ops, thr)
        eps[f"gated/poly/{e}"] = _capture(step, args, shapes, size_oblivious=True)
        with torch.no_grad():
            h, lp, chosen, done, _, _ = step(*args)
    return eps


def compile_bundles(bundles: Dict[str, ExportBundle]) -> None:
    """The AOTInductor packages of the "cuda" programs of several bundles
    (name -> bundle), compiled at once (`_compile_all`: one spawned
    process a program), into each bundle and its manifest's
    `aoti_compile_s`."""
    saved = {f"{name}:{key}": blob for name, b in bundles.items()
             for key, blob in b.programs["cuda"].items()}
    with tempfile.TemporaryDirectory(prefix="eet_aoti_") as tmp:
        for k, (blob, secs) in _compile_all(saved, tmp).items():
            name, key = k.split(":", 1)
            bundles[name].packages[key] = blob
            bundles[name].manifest["aoti_compile_s"][key] = secs


def _out_shapes(ep):
    """The shapes of a captured program's outputs (a symbolic size as its
    name)."""
    out = next(n for n in ep.graph.nodes if n.op == "output").args[0]
    return [[d if isinstance(d, int) else str(d) for d in n.meta["val"].shape]
            for n in out]


def _stack_frames(cfg, s: int, hop: int) -> list:
    """Every time axis that the model's stacks run at for an s-sample
    input: centred mel frames, then the VALID k=3 stride-2 convolutions
    (two; the zipformer's one) give T'; the splitformer's branch runs at
    ceil(T'/2), the zipformer's stages at ceil(T'/factor) and its exit at
    ceil(T'/2)."""
    from early_exit_tpu_torch.models import splitformer, zipformer
    t = 1 + s // hop
    for _ in range(1 if cfg.model_type == "early_zipformer" else 2):
        t = (t - 3) // 2 + 1
    factors = {"splitformer": (splitformer.FACTOR,),
               "early_zipformer": (*zipformer.FACTORS, 2)}.get(cfg.model_type, ())
    return [t] + [-(-t // f) for f in factors]


def save_bundle(path: str, bundle: ExportBundle) -> None:
    with zipfile.ZipFile(path, "w", zipfile.ZIP_STORED) as z:
        z.writestr("manifest.json", json.dumps(bundle.manifest, indent=1))
        for plat, progs in bundle.programs.items():
            for key, blob in progs.items():
                z.writestr(f"programs/{plat}/{key}.pt2", blob)
        for key, blob in bundle.packages.items():
            z.writestr(f"aoti/{key}.pt2", blob)
        if bundle.vocab is not None:
            z.writestr("vocab.json", json.dumps(bundle.vocab))


def load_bundle(path: str) -> ExportBundle:
    with zipfile.ZipFile(path) as z:
        names = z.namelist()
        if "manifest.json" not in names:
            raise ValueError(f"not an eet export bundle: {path}")
        manifest = json.loads(z.read("manifest.json"))
        if manifest.get("format") != _FORMAT:
            raise ValueError(f"not an eet export bundle: {path}")
        programs: Dict[str, Dict[str, bytes]] = {}
        packages: Dict[str, bytes] = {}
        for name in names:
            if not name.endswith(".pt2"):
                continue
            if name.startswith("programs/"):
                plat, key = name[len("programs/"):-4].split("/", 1)
                programs.setdefault(plat, {})[key] = z.read(name)
            elif name.startswith("aoti/"):
                packages[name[len("aoti/"):-4]] = z.read(name)
        vocab = json.loads(z.read("vocab.json")) if "vocab.json" in names else None
    return ExportBundle(manifest=manifest, programs=programs, packages=packages,
                        vocab=vocab)


# ---------------------------------------------------------------- consumer

class ExportedRecognizer:
    """Runs a saved bundle with no model code: pads a waveform batch up to
    the smallest covering bucket, else calls the poly program on it as it
    is (a request under the program's `min_samples`, hop * 10, padded up
    to it as the JAX package's runner pads it), numpy in, numpy out. On
    CUDA (the default device) it runs the AOTInductor packages, on the
    CPU the captured programs; a bundle with no program for the device's
    platform raises. Programs are loaded at first use. `close()` removes
    the packages' extracted files."""

    def __init__(self, path: str, device=None):
        self.bundle = load_bundle(path)
        self.device = runtime.resolve_device(device)
        self.platform = self.device.type
        allowed = [p.lower() for p in self.manifest["platforms"]]
        if self.platform not in allowed:
            raise ValueError(
                f"bundle was exported for {sorted(allowed)} but this recognizer "
                f"runs on '{self.platform}'; re-export with --export_platforms "
                f"{self.platform},... or pass device= one of {sorted(allowed)}")
        if self.platform == "cuda":
            runtime.exact_float32()
        self._progs = self.bundle.programs[self.platform]
        self._fns: Dict[str, object] = {}
        self._tmp: Optional[tempfile.TemporaryDirectory] = None
        self._shapes = sorted(
            tuple(int(v) for v in k.split("x")) for k in self._progs
            if k != "poly" and "/" not in k)
        self._cascade_shapes = sorted(
            tuple(int(v) for v in k.split("/")[1].split("x")) for k in self._progs
            if k.startswith("cascade_a/"))
        self._poly = (self.manifest["shapes"].get("poly")
                      if "poly" in self._progs else None)

    @property
    def manifest(self) -> dict:
        return self.bundle.manifest

    def close(self) -> None:
        self._fns.clear()
        if self._tmp is not None:
            self._tmp.cleanup()
            self._tmp = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def _pick(self, b: int, s: int) -> Tuple[int, int]:
        fits = [(pb, ps) for pb, ps in self._shapes if pb >= b and ps >= s]
        if fits:
            return min(fits, key=lambda t: (t[0] * t[1], t))
        if self._poly is not None and s <= self._poly["max_samples"]:
            return (b, max(s, self._poly["min_samples"]))
        raise ValueError(
            f"no exported shape covers batch={b} samples={s}; "
            f"available: {self._shapes}" + (" + poly" if self._poly is not None else ""))

    def _fn(self, key: str):
        if key not in self._fns:
            if self.platform == "cuda":
                if self._tmp is None:
                    self._tmp = tempfile.TemporaryDirectory(prefix="eet_bundle_")
                path = os.path.join(self._tmp.name, key.replace("/", "_") + ".pt2")
                with open(path, "wb") as f:
                    f.write(self.bundle.packages[key])
                self._fns[key] = torch._inductor.aoti_load_package(path)
            else:
                ep = torch.export.load(io.BytesIO(self._progs[key]))
                self._fns[key] = ep.module()
        return self._fns[key]

    def _padded(self, wav: np.ndarray, n_samples: np.ndarray):
        wav = np.asarray(wav, np.float32)
        n_samples = np.asarray(n_samples, np.int32)
        b, s = wav.shape
        pb, ps = self._pick(b, s)
        if (pb, ps) != (b, s):
            wav = np.pad(wav, ((0, pb - b), (0, ps - s)))
            n_samples = np.pad(n_samples, (0, pb - b))
        key = _shape_key(pb, ps) if (pb, ps) in self._shapes else "poly"
        return (key, torch.from_numpy(wav).to(self.device),
                torch.from_numpy(n_samples).to(self.device), b)

    @torch.no_grad()
    def __call__(self, wav: np.ndarray, n_samples: np.ndarray):
        """wav (B, S) float32, n_samples (B,) -> (tokens (E, B, T'),
        n_tok (E, B), conf (E, B)) trimmed back to the true batch."""
        key, wav, n_samples, b = self._padded(wav, n_samples)
        toks, n_tok, conf = self._fn(key)(wav, n_samples)
        return (toks[:, :b].cpu().numpy(), n_tok[:, :b].cpu().numpy(),
                conf[:, :b].cpu().numpy())

    @torch.no_grad()
    def gated(self, wav: np.ndarray, n_samples: np.ndarray, threshold: float):
        """Confidence-gated decode (bundle exported with gated=True): the
        program stops at the first exit where every row clears
        `threshold`. Returns (tokens (B, T'), n_tok (B,), chosen_exit (B,)
        1-based)."""
        if not self.manifest.get("gated"):
            raise ValueError("bundle was exported without gated=True")
        key, wav, n_samples, b = self._padded(wav, n_samples)
        thr = torch.tensor(float(threshold), dtype=torch.float32, device=self.device)
        if f"gated/{key}/0" in self._progs:
            toks, n_tok, chosen = self._gated_exits(key, wav, n_samples, thr)
        else:
            toks, n_tok, chosen = self._fn("gated/" + key)(wav, n_samples, thr)
        return (toks[:b].cpu().numpy(), n_tok[:b].cpu().numpy(),
                chosen[:b].cpu().numpy())

    def _gated_exits(self, key, wav, n_samples, thr):
        """A gated program of one program an exit (`GatedFirstExit`): the
        next exit runs while a row is not done, as `gated_apply`'s conds
        run it (one read of `done` an exit)."""
        h, lp, chosen, done, mask, sub_len, *ops, toks, n_tok = self._fn(f"gated/{key}/0")(
            wav, n_samples, thr)
        for e in range(1, self.manifest["n_exits"]):
            if bool(done.all()):
                break
            h, lp, chosen, done, toks, n_tok = self._fn(f"gated/{key}/{e}")(
                h, lp, chosen, done, mask, sub_len, *ops, thr)
        return toks, n_tok, chosen

    @torch.no_grad()
    def cascade(self, wav: np.ndarray, n_samples: np.ndarray,
                thresholds: Sequence[float]):
        """Two-phase re-batched gated decode (bundle exported with
        cascade_k): phase A on the whole bucket; only the accept mask
        crosses to the host; the unaccepted rows are packed (a multiple of
        PACK_BATCH rows, at most the bucket's B) and only they run phase B
        from phase A's hidden state, gathered on the device. thresholds:
        the per-exit (E,) operating point.

        Returns (tokens (B, T'), n_tok (B,), chosen_exit (B,) 1-based,
        escalated (B,) bool)."""
        if self.manifest.get("cascade_k") is None:
            raise ValueError("bundle was exported without cascade_k")
        E = self.manifest["n_exits"]
        thr = np.asarray(thresholds, np.float32)
        if thr.shape != (E,):
            raise ValueError(f"thresholds must be shape ({E},); got {tuple(thr.shape)}")
        b_in, s_in = np.shape(wav)
        key, wav, n_samples, b = self._padded(wav, n_samples)
        if key == "poly":
            raise ValueError(
                f"no cascade program covers batch={b_in} samples={s_in}: the "
                f"cascade is exported for the buckets {self._cascade_shapes} "
                f"only, not for the poly program")
        thr = torch.from_numpy(thr).to(self.device)
        toks, n_tok, chosen, accepted, sub_len, h_k = self._fn(
            "cascade_a/" + key)(wav, n_samples, thr)
        escalated = ~accepted[:b].cpu().numpy().astype(bool)
        idx, real = pack_escalation_indices(~escalated, PACK_BATCH)
        idx = idx[:h_k.shape[0]]       # padding only: rows beyond the bucket's B
        if idx.size:
            n_real = int(real.sum())
            idx_d = torch.from_numpy(idx).long().to(self.device)
            bt, bn, bc = self._fn("cascade_b/" + key)(
                h_k.index_select(0, idx_d), sub_len.index_select(0, idx_d), thr)
            rows = idx_d[:n_real]
            toks[rows], n_tok[rows], chosen[rows] = bt[:n_real], bn[:n_real], bc[:n_real]
        return (toks[:b].cpu().numpy(), n_tok[:b].cpu().numpy(),
                chosen[:b].cpu().numpy(), escalated)

    def detokenize(self, ids: Sequence[int]) -> str:
        """Greedy-output ids -> text via the bundled vocab table (the
        SentencePiece surface-piece concatenation rule)."""
        vocab = self.bundle.vocab
        if vocab is None:
            raise ValueError("bundle was exported without a vocab table")
        text = "".join(vocab[int(i)] for i in ids
                       if not (len(vocab[int(i)]) > 2 and vocab[int(i)][0] == "<"
                               and vocab[int(i)][-1] == ">"))
        return text.replace("▁", " ").strip()
