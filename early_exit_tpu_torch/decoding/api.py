"""One front door over the port's decoders (counterpart of
`early_exit_tpu/decoding/api.py`, the reference's `BeamInference`
surface, util/beam_infer.py:34-82):

    suite = DecoderSuite(model_cfg, beam_size=10,
                         lexicon_path=..., tokens_path=...)
    suite.greedy(log_probs, lengths)          # greedy CTC
    suite.ctc_prefix(log_probs, lengths)      # prefix beam, on the device
    suite.ctc_lexicon(log_probs, lengths)     # lexicon beam (C++, host)
    suite.aed_beam(model, memory, n_exit, ...)  # AED beam, KV-cached
    suite.align(emission, tokens)             # forced alignment
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from early_exit_tpu_torch.configs import ModelConfig
from early_exit_tpu_torch.decoding import aed_beam, forced_align, prefix_beam
from early_exit_tpu_torch.ops import ctc


class DecoderSuite:
    def __init__(self, model_cfg: ModelConfig, *, beam_size: int = 10,
                 pen_alpha: float = 1.0, blank_skip_threshold: float = 0.95,
                 word_score: float = 0.0, nbest: int = 1,
                 lexicon_path: Optional[str] = None,
                 tokens_path: Optional[str] = None,
                 lm_path: Optional[str] = None, lm_weight: float = 1.0):
        self.cfg = model_cfg
        self.beam_size = beam_size
        self.pen_alpha = pen_alpha
        self.blank_skip_threshold = blank_skip_threshold
        self.nbest = nbest
        self._trie = None
        if lexicon_path and tokens_path:
            from early_exit_tpu_torch.decoding.lexicon_beam import LexiconBeamDecoder
            from early_exit_tpu_torch.decoding.ngram_lm import ArpaLM
            self._trie = LexiconBeamDecoder.from_files(
                lexicon_path, tokens_path, beam_size=beam_size, word_score=word_score,
                lm=ArpaLM(lm_path) if lm_path else None, lm_weight=lm_weight)

    def greedy(self, log_probs: torch.Tensor, lengths: torch.Tensor):
        """(B, T, V), (B,) -> (tokens (B, T), n_tokens (B,))."""
        return ctc.greedy_decode(log_probs, lengths, blank=self.cfg.blank_id)

    def ctc_prefix(self, log_probs: torch.Tensor, lengths: torch.Tensor):
        """Batched prefix beam with blank skip -> (tokens, n_tokens, scores);
        with nbest > 1 each has a (B, nbest, ...) rank axis."""
        return prefix_beam.prefix_beam_search(
            log_probs, lengths, beam_size=self.beam_size, blank=self.cfg.blank_id,
            blank_skip_threshold=self.blank_skip_threshold, nbest=self.nbest)

    def ctc_lexicon(self, log_probs, lengths=None) -> List[str]:
        """Lexicon beam on host log-probs -> word transcripts."""
        if self._trie is None:
            raise RuntimeError("DecoderSuite built without a lexicon and tokens")
        lp = torch.as_tensor(log_probs).float().cpu().numpy()
        return self._trie.decode_batch(lp, None if lengths is None
                                       else np.asarray(torch.as_tensor(lengths).cpu()))

    def aed_beam(self, model, memory: torch.Tensor, n_exit: int, *,
                 max_length: int, min_length: int):
        """One utterance's beam at exit n_exit of a `FullConformer`: memory
        (1, T', D) -> (tokens (K, max_length+1), lengths, scores, best)."""
        return aed_beam.beam_search_exit(
            model, memory, n_exit=n_exit, beam_size=self.beam_size,
            max_length=max_length, min_length=min_length, pen_alpha=self.pen_alpha)

    def align(self, emission, tokens):
        """Forced alignment -> (start frames, end frames, path score)."""
        return forced_align.forced_align(emission, tokens, blank=self.cfg.blank_id)
