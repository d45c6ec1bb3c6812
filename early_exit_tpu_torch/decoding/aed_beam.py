"""AED beam search with a KV cache (counterpart of
`early_exit_tpu/decoding/aed_beam.py`, the reference's
`BeamInference.beam_search`, util/beam_infer.py:198-307).

Every rule of the JAX package's search:
- K lanes per utterance, all starting from [SOS]; only lane 0 is live at
  step 0 (the others score -1e30);
- each step divides the decoder's last-position log-probs by the length
  penalty ((5 + (i + 1)) / 6)^alpha and adds them to the running scores;
  a retired lane keeps one candidate, its own score at the PAD column;
  the K best of the K x V candidates go on, chosen as `lax.top_k`
  chooses (the lower flat index first among equal scores);
- a lane that picks EOS at step i > min_length (strictly; per
  utterance) retires; its tokens and length freeze;
- the self-attention caches follow each lane's parent;
- max_length steps always run; the best lane is the first of the highest
  final scores.

The port decodes a whole batch at once: B x K lanes in one decoder step,
each utterance's lanes competing only among themselves (the JAX package
vmaps the single-utterance search). Eager PyTorch: one decoder step is
a few hundred small launches, so the search is host-bound by design.
"""

from __future__ import annotations

from typing import List

import torch

from early_exit_tpu_torch.models.transformer_decoder import DecoderStack, init_cache
from early_exit_tpu_torch.nn import core

NEG = -1e30


def length_penalty(length, alpha: float) -> torch.Tensor:
    """((5 + len) / 6)^alpha in float32 (util/beam_infer.py:194-195)."""
    return ((5.0 + torch.as_tensor(length, dtype=torch.float32)) / 6.0) ** alpha


def top_k_stable(x: torch.Tensor, k: int):
    """The k largest of each row of x (N, M), the lower index first among
    equal values (`lax.top_k`'s order, which `torch.topk` does not
    promise on CUDA). Returns (values, indices), each (N, k)."""
    values, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[:, :k], idx[:, :k]


@torch.no_grad()
def beam_search(dec: DecoderStack, out_w: torch.Tensor, out_b: torch.Tensor,
                emb: torch.Tensor, final_ln, memory: torch.Tensor,
                min_lengths: torch.Tensor, cfg, *, beam_size: int,
                max_length: int, pen_alpha: float = 1.0):
    """Beam-decode B utterances with one decoder.

    memory: (B, T', D) encoder states; min_lengths: (B,) per-utterance
    minimum lengths. Returns (tokens (B, K, max_length+1) with the leading
    SOS, lengths (B, K), scores (B, K), best (B,))."""
    B, _, D = memory.shape
    K, V, M = beam_size, cfg.vocab_size, max_length + 1
    dev = memory.device
    cd = cfg.dtype
    pe = core.sinusoidal_pe(M, D, device=dev)
    mem_kv = dec.memory_kv(memory, cd)

    tokens = torch.full((B, K, M), cfg.pad_id, dtype=torch.int32, device=dev)
    tokens[:, :, 0] = cfg.bos_id
    lengths = torch.ones(B, K, dtype=torch.int32, device=dev)
    scores = torch.full((B, K), NEG, device=dev)
    scores[:, 0] = 0.0
    done = torch.zeros(B, K, dtype=torch.bool, device=dev)
    cache = init_cache(len(dec.layers), B * K, M, D, device=dev)
    min_lengths = min_lengths.to(dev).reshape(B, 1)
    # a retired lane's one candidate: its score at the PAD column
    done_row = torch.full((V,), NEG, device=dev)
    done_row[cfg.pad_id] = 0.0
    lane0 = (torch.arange(B, device=dev) * K)[:, None]               # (B, 1)
    cols = torch.arange(M, device=dev)

    for i in range(max_length):
        x_t = core.embedding_lookup(emb, tokens[:, :, i].reshape(B * K, 1)) + pe[i]
        h = dec.step(x_t, final_ln, cache, mem_kv, compute_dtype=cd)
        logits = core.linear(h, out_w, out_b, compute_dtype=cd)
        logp = torch.log_softmax(logits.float(), dim=-1).reshape(B, K, V)
        logp = logp / length_penalty(i + 1.0, pen_alpha)
        cand = torch.where(done[..., None], scores[..., None] + done_row,
                           scores[..., None] + logp)
        scores, flat = top_k_stable(cand.reshape(B, K * V), K)
        parent = torch.div(flat, V, rounding_mode="floor")
        tok = (flat % V).to(torch.int32)
        tokens = tokens.gather(1, parent[..., None].expand(B, K, M))
        lengths = lengths.gather(1, parent)
        was_done = done.gather(1, parent)
        at_next = (cols == i + 1) & ~was_done[..., None]
        tokens = torch.where(at_next, tok[..., None], tokens)
        lengths = torch.where(was_done, lengths, lengths + 1)
        done = was_done | (tok == cfg.eos_id) & (i > min_lengths)
        DecoderStack.reorder_cache(cache, (parent + lane0).reshape(-1))
    return tokens, lengths, scores, scores.argmax(dim=-1)


def _exit_decoder(model, n_exit: int):
    e = n_exit - 1
    return (model.decoders[e], model.out_w[e], model.out_b[e], model.emb,
            model.final_ln)


def beam_search_exit_batch(model, memories: torch.Tensor, min_lengths, *,
                           n_exit: int, beam_size: int, max_length: int,
                           pen_alpha: float = 1.0):
    """Beam-decode every utterance of a batch from exit n_exit (1-based) of
    a `FullConformer`. memories: (B, T', D) that exit's encoder states;
    min_lengths: (B,) (the max_length is shared: bucket it at the caller).
    Returns (tokens (B, K, max_length+1), lengths (B, K), scores (B, K),
    best (B,))."""
    min_lengths = torch.as_tensor(min_lengths, dtype=torch.int64)
    return beam_search(*_exit_decoder(model, n_exit), memories, min_lengths,
                       model.cfg, beam_size=beam_size, max_length=max_length,
                       pen_alpha=pen_alpha)


def beam_search_exit(model, memory: torch.Tensor, *, n_exit: int, beam_size: int,
                     max_length: int, min_length: int, pen_alpha: float = 1.0):
    """One utterance: memory (1, T', D). Returns (tokens (K,
    max_length+1), lengths (K,), scores (K,), best ())."""
    out = beam_search_exit_batch(model, memory, [min_length], n_exit=n_exit,
                                 beam_size=beam_size, max_length=max_length,
                                 pen_alpha=pen_alpha)
    return tuple(t[0] for t in out)


def trim_hypothesis(tokens, length, *, eos_id: int, bos_id: int) -> List[int]:
    """A lane's ids without the SOS, the EOS kept when it has one (the
    reference's best_combined holds the EOS it appended)."""
    return [int(t) for t in tokens[1:int(length)]]
