"""The whole slice at full width on the committed flagship, in the bf16
inference profile (bf16 compute, residual and softmax, DFT mel): the
port's entry point (`Recognizer.from_flagship("cpu")`) against the JAX
package's forward on the two utterances of
tests/test_torch_early_conformer.py.

Tolerance: token disagreement <= 1% per exit, i.e. identical tokens on
two utterances, for both the fused dispatch (the block kernel's plain
version against the TPU kernel in interpret mode) and the unfused path
(against XLA); the final exit's texts through the port's tokenizer equal
JAX's, and stay within 50% WER of the transcripts.
"""

import pytest

from early_exit_tpu.configs import ModelConfig as JaxModelConfig
from early_exit_tpu.tokenizer.bpe import load_tokenizer
from early_exit_tpu_torch.serving.recognizer import Recognizer
from test_torch_early_conformer import _edits, _jax_run, _tokens, bundle  # noqa: F401


@pytest.mark.parametrize("fused", [True, False])
def test_bf16_profile_tokens_match_jax(bundle, fused):
    """The port's entry point on the CPU (the inference profile, DFT mel)
    against the JAX package's forward in the same profile."""
    _, _, jt, jn = _jax_run(bundle, JaxModelConfig(
        attn_softmax_dtype="bfloat16", fused_block=fused), "dft")
    out = Recognizer.from_flagship("cpu", fused=fused)\
        .transcribe(bundle["wav"], bundle["counts"])
    assert len(out.texts) == 6 and all(len(t) == 2 for t in out.texts)
    ours = _tokens(out.tokens.numpy(), out.n_tokens.numpy())
    theirs = _tokens(jt, jn)
    for e in range(6):
        edits = sum(_edits(a, b) for a, b in zip(ours[e], theirs[e]))
        total = sum(max(len(b), 1) for b in theirs[e])
        assert edits <= 0.01 * total, (e + 1, ours[e], theirs[e])
    # the final exit transcribes through both tokenizers to the same text
    jtok = load_tokenizer(bundle["tok"], prefer_native=False)
    texts = out.texts[-1]
    assert texts == [jtok.decode(t) for t in theirs[-1]]
    refs = [u.transcript for u in bundle["utts"]]
    assert sum(_edits(t.split(), r.split()) for t, r in zip(texts, refs)) \
        <= 0.5 * sum(len(r.split()) for r in refs)
