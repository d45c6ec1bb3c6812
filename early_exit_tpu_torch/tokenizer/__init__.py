"""Decode-only SentencePiece reader (the port's own copy)."""

from early_exit_tpu_torch.tokenizer.spm import SentencePieceDecoder, load_decoder

__all__ = ["SentencePieceDecoder", "load_decoder"]
