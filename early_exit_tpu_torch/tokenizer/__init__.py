"""SentencePiece tokenizers of all four model types (Python engines and the
C++ engine) and the legacy character tokenizer: the port's own copies."""

from early_exit_tpu_torch.tokenizer.bpe import SentencePieceBPE
from early_exit_tpu_torch.tokenizer.chars import CharTokenizer
from early_exit_tpu_torch.tokenizer.spm import load_decoder, load_tokenizer

__all__ = ["CharTokenizer", "SentencePieceBPE", "load_decoder", "load_tokenizer"]
