"""SentencePiece reader (decode for any model, encode for BPE) and the
legacy character tokenizer: the port's own copies."""

from early_exit_tpu_torch.tokenizer.bpe import SentencePieceBPE, load_tokenizer
from early_exit_tpu_torch.tokenizer.chars import CharTokenizer
from early_exit_tpu_torch.tokenizer.spm import SentencePieceDecoder, load_decoder

__all__ = ["CharTokenizer", "SentencePieceBPE", "SentencePieceDecoder",
           "load_decoder", "load_tokenizer"]
