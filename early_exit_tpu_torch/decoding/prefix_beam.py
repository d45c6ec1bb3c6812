"""Batched CTC prefix beam search with blank-skip pruning, on the device
(counterpart of `early_exit_tpu/decoding/prefix_beam.py`).

The JAX package's replacement of torchaudio's `cuda_ctc_decoder`
(util/beam_infer.py:79-80, 102-112), in the same arithmetic:

- `beam` lanes a batch item; prefixes live in a (beam, max_out) buffer;
- each frame, each lane gives one "stay" candidate (blank and repeat of
  the last token, prefix unchanged) and `topn` "extend" candidates (the
  frame's top non-blank tokens): beam x (topn + 1) candidates;
- equal prefixes merge in the log semiring through an equality matrix;
  the key is two independent 32-bit rolling hashes plus (length, last
  token), so a false merge needs a collision in both hash streams;
- a frame whose blank probability exceeds `blank_skip_threshold` is taken
  as pure blank (the cuda_ctc_decoder's fast path);
- per-item input lengths freeze the carry.

The JAX `lax.scan` over time is a Python loop over frames of batched
tensor operations on the log-probs' device, with no host synchronisation
inside it: the skip and the freeze are selects, as `lax.cond` becomes
under the JAX package's `vmap`. The hashes are uint32 values held in
int64 and reduced mod 2^32 after every step; the product by the second
multiplier (2654435761, above 2^31) is split in two 16-bit halves so
that no intermediate leaves int64. Where `lax.top_k` breaks ties by the
lower index (the frame's top tokens, the surviving prefixes, the n-best),
a stable descending sort does the same.
"""

from __future__ import annotations

import math

import torch

NEG = -1e30
# two rolling-hash streams: h <- h * M + (tok + A) mod 2^32
_HASH = ((1000003, 1), (2654435761, 0x9E3779B9))
_MASK = 0xFFFFFFFF


def _hash_step(h: torch.Tensor, tok: torch.Tensor, mult: int, add: int) -> torch.Tensor:
    """(h * mult + tok + add) mod 2^32 for uint32 values held in int64."""
    hi, lo = mult >> 16, mult & 0xFFFF
    prod = h * lo + (((h * hi) & 0xFFFF) << 16)      # both terms < 2^48
    return (prod + ((tok + add) & _MASK)) & _MASK


def _top(x: torch.Tensor, k: int):
    """lax.top_k along the last axis: the k largest, ties to the lower index."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def prefix_beam_search(log_probs: torch.Tensor, lengths: torch.Tensor, *,
                       beam_size: int = 10, blank: int = 0,
                       blank_skip_threshold: float = 0.95, topn: int = 16,
                       max_out: int | None = None, nbest: int = 1):
    """log_probs: (B, T, V) log-softmax emissions; lengths: (B,).

    nbest=1: returns (tokens (B, max_out) int32 blank-padded, n_tokens
    (B,) int32, scores (B,) float32, the total log-prob of the best
    prefix). nbest>1: (tokens (B, nbest, max_out), n_tokens (B, nbest),
    scores (B, nbest)), best first."""
    lp_all = log_probs.float()
    B, T, V = lp_all.shape
    dev = lp_all.device
    if max_out is None:
        max_out = T
    topn = min(topn, V - 1)
    nbest = min(nbest, beam_size)
    K, log_skip = beam_size, math.log(blank_skip_threshold)
    C = K * (topn + 1)
    lengths = lengths.to(dev)

    prefix = torch.full((B, K, max_out), blank, dtype=torch.int64, device=dev)
    plen = torch.zeros((B, K), dtype=torch.int64, device=dev)
    phash = torch.zeros((B, K, 2), dtype=torch.int64, device=dev)
    last = torch.full((B, K), -1, dtype=torch.int64, device=dev)
    p_b = torch.full((B, K), NEG, device=dev)
    p_b[:, 0] = 0.0
    p_nb = torch.full((B, K), NEG, device=dev)

    neg = torch.tensor(NEG, device=dev)
    parent = torch.arange(K, device=dev).repeat_interleave(topn + 1)       # (C,)
    is_ext = (torch.arange(C, device=dev) % (topn + 1)) != 0               # (C,)
    pos = torch.arange(max_out, device=dev)
    c_range = torch.arange(C, device=dev)
    rows = torch.arange(B, device=dev)[:, None]

    for t in range(T):
        lp_t = lp_all[:, t]                                   # (B, V)
        lp_blank = lp_t[:, blank]                             # (B,)

        # pure-blank frame
        skip_pb = torch.logaddexp(p_b, p_nb) + lp_blank[:, None]

        # full frame: the frame's top non-blank tokens
        lp_nb = lp_t.clone()
        lp_nb[:, blank] = NEG
        tok_lp, tok_id = _top(lp_nb, topn)                    # (B, topn)
        lp_last = torch.where(last >= 0, lp_t.gather(1, last.clamp(0, V - 1)), neg)
        stay_pb = torch.logaddexp(p_b, p_nb) + lp_blank[:, None]
        stay_pnb = p_nb + lp_last
        is_repeat = tok_id[:, None, :] == last[:, :, None]    # (B, K, topn)
        base = torch.where(is_repeat, p_b[..., None],
                           torch.logaddexp(p_b, p_nb)[..., None])
        ext_pnb = base + tok_lp[:, None, :]
        cand_pb = torch.cat([stay_pb[..., None],
                             torch.full((B, K, topn), NEG, device=dev)], -1).reshape(B, C)
        cand_pnb = torch.cat([stay_pnb[..., None], ext_pnb], -1).reshape(B, C)
        ext_tok = torch.cat([torch.full((B, K, 1), -1, dtype=torch.int64, device=dev),
                             tok_id[:, None, :].expand(B, K, topn)], -1).reshape(B, C)

        par_plen = plen[:, parent]                            # (B, C)
        c_plen = torch.clamp(par_plen + is_ext, max=max_out)
        tok_u = ext_tok.clamp_min(0)
        par_hash = phash[:, parent]                           # (B, C, 2)
        c_hash = torch.stack([
            torch.where(is_ext, _hash_step(par_hash[..., i], tok_u, m, a), par_hash[..., i])
            for i, (m, a) in enumerate(_HASH)], -1)
        c_last = torch.where(is_ext, ext_tok, last[:, parent])
        # extensions that would overflow the buffer are dropped
        overflow = is_ext & (par_plen >= max_out)
        cand_pnb = torch.where(overflow, neg, cand_pnb)
        at_pos = pos == par_plen.clamp(0, max_out - 1)[..., None]       # (B, C, max_out)
        c_prefix = torch.where(at_pos & (is_ext & ~overflow)[..., None],
                               ext_tok[..., None], prefix[:, parent])

        # merge equal prefixes (2 x hash, length, last) in log space
        key_eq = ((c_hash[:, :, None, 0] == c_hash[:, None, :, 0])
                  & (c_hash[:, :, None, 1] == c_hash[:, None, :, 1])
                  & (c_plen[:, :, None] == c_plen[:, None, :])
                  & (c_last[:, :, None] == c_last[:, None, :]))           # (B, C, C)
        comb_pb = torch.logsumexp(torch.where(key_eq, cand_pb[:, None, :], neg), -1)
        comb_pnb = torch.logsumexp(torch.where(key_eq, cand_pnb[:, None, :], neg), -1)
        owner = torch.argmax(key_eq.to(torch.int8), dim=-1)              # first equal
        is_owner = owner == c_range
        comb_pb = torch.where(is_owner, comb_pb, neg)
        comb_pnb = torch.where(is_owner, comb_pnb, neg)

        # prune to K
        _, top_idx = _top(torch.logaddexp(comb_pb, comb_pnb), K)         # (B, K)
        full = (c_prefix[rows, top_idx], c_plen.gather(1, top_idx),
                c_hash[rows, top_idx], c_last.gather(1, top_idx),
                comb_pb.gather(1, top_idx), comb_pnb.gather(1, top_idx))

        skip = (lp_blank > log_skip)[:, None]
        skipped = (prefix, plen, phash, last, skip_pb, torch.full_like(p_nb, NEG))
        active = (t < lengths)[:, None]
        out = []
        for old, f, s in zip((prefix, plen, phash, last, p_b, p_nb), full, skipped):
            pad = (slice(None), slice(None)) + (None,) * (f.dim() - 2)
            new = torch.where(skip[pad], s, f)
            out.append(torch.where(active[pad], new, old))
        prefix, plen, phash, last, p_b, p_nb = out

    scores, order = _top(torch.logaddexp(p_b, p_nb), nbest)   # lanes hold distinct prefixes
    toks = prefix[rows, order].to(torch.int32)
    n = plen.gather(1, order).to(torch.int32)
    if nbest == 1:
        return toks[:, 0], n[:, 0], scores[:, 0]
    return toks, n, scores
