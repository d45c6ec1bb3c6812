"""The port's loader for the native library (counterpart of
`early_exit_tpu/_native.py`).

`csrc/` at the repository root holds the C++ host components that both
packages call through ctypes: the FLAC decoder, the lexicon snapper, the
lexicon-constrained CTC beam search and its ARPA LM, the SentencePiece
engine (`tokenizer/native.py`) and its trainers. The library is
built from the same sources as the JAX package's (`csrc/**/*.cc` but the
`*_cli.cc` programs), with g++, into the port's own directory
`build/torch_native/`, and so is the `eet_spm` program (`build_cli`,
from `csrc/tokenizer/spm_cli.cc` and the sources the JAX package links
it with); each is named by a hash of its sources and flags so that a
stale build is never used. The objects compile in parallel; the link
writes a temporary file that `os.replace` moves into place, under a
file lock, so processes that build at once (parallel test workers)
neither race nor run or read a partial file. A failed build raises with
the compiler's output.
"""

from __future__ import annotations

import ctypes
import fcntl
import glob
import hashlib
import os
import subprocess
import tempfile
import threading

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_REPO, "csrc")
BUILD_DIR = os.path.join(_REPO, "build", "torch_native")
FLAGS = ["-O3", "-std=c++17", "-fPIC"]
CLI_FLAGS = ["-O3", "-std=c++17"]

_lock = threading.Lock()
_lib = None


def sources():
    srcs = sorted(glob.glob(os.path.join(CSRC, "**", "*.cc"), recursive=True))
    # files with a main() build into CLI programs, not the library
    return [s for s in srcs if not s.endswith("_cli.cc")]


def _hashed(stem: str, srcs, flags) -> str:
    """build/torch_native/<stem>-<hash of flags, sources and headers>."""
    h = hashlib.sha256(" ".join(flags).encode())
    for path in list(srcs) + sorted(glob.glob(os.path.join(CSRC, "**", "*.h"),
                                              recursive=True)):
        h.update(path[len(CSRC):].encode())
        with open(path, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"{stem}-{h.hexdigest()[:16]}")


def lib_path() -> str:
    return _hashed("libeet_native", sources(), FLAGS) + ".so"


def cli_sources():
    """The `eet_spm` program's sources, as the JAX package builds it."""
    tok = os.path.join(CSRC, "tokenizer")
    return [os.path.join(tok, f) for f in (
        "spm_cli.cc", "bpe_tokenizer.cc", "bpe_trainer.cc", "unigram_trainer.cc",
        "charsmap_builder.cc")]


def cli_path() -> str:
    return _hashed("eet_spm", cli_sources(), CLI_FLAGS)


def _run(cmds) -> None:
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
             for c in cmds]
    errors = []
    for cmd, p in zip(cmds, procs):
        out = p.communicate()[0].decode(errors="replace")
        if p.returncode:
            errors.append(f"{' '.join(cmd)} (rc={p.returncode}):\n{out}")
    if errors:
        raise RuntimeError("building the native code failed:\n" + "\n".join(errors))


def _build_once(out: str, srcs, flags, link) -> str:
    """out, built unless it is there: each source compiled to an object in
    parallel, linked by `link` (extra g++ arguments) into a temporary
    file that `os.replace` moves into place, under the directory's file
    lock, so no process ever runs or loads a half-written file."""
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(os.path.join(BUILD_DIR, ".lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if os.path.exists(out):          # another process built it meanwhile
            return out
        with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
            objs = [os.path.join(tmp, f"{i}.o") for i in range(len(srcs))]
            _run([["g++", *flags, "-c", "-o", o, s] for o, s in zip(objs, srcs)])
            part = os.path.join(tmp, "out")
            _run([["g++", *link, "-o", part, *objs]])
            os.replace(part, out)
    return out


def build() -> str:
    """Build the library unless it is there; returns its path."""
    return _build_once(lib_path(), sources(), FLAGS, ["-shared"])


def build_cli() -> str:
    """Build the `eet_spm` program (train / encode / decode / normalize)
    unless it is there; returns its path."""
    return _build_once(cli_path(), cli_sources(), CLI_FLAGS, [])


def get_lib() -> ctypes.CDLL:
    """The loaded library, built at first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            _configure(lib)
            _lib = lib
        return _lib


def _configure(lib: ctypes.CDLL) -> None:
    c = ctypes
    vp, i, f, cp = c.c_void_p, c.c_int, c.c_float, c.c_char_p
    ip, fp = c.POINTER(c.c_int), c.POINTER(c.c_float)
    sigs = {
        # lexicon snapper
        "eet_lex_create": (vp, []), "eet_lex_free": (None, [vp]),
        "eet_lex_add": (None, [vp, cp]), "eet_lex_contains": (i, [vp, cp]),
        "eet_lex_closest": (i, [vp, cp, cp, i]),
        # FLAC decoder
        "eet_flac_decode": (vp, [cp]), "eet_flac_num_samples": (c.c_long, [vp]),
        "eet_flac_sample_rate": (i, [vp]), "eet_flac_channels": (i, [vp]),
        "eet_flac_copy": (None, [vp, c.POINTER(c.c_int32)]),
        "eet_flac_free": (None, [vp]),
        # lexicon-constrained CTC beam search
        "eet_trie_create": (vp, [i]), "eet_trie_free": (None, [vp]),
        "eet_trie_add_word": (None, [vp, ip, i, i]),
        "eet_trie_decode": (i, [vp, fp, i, i, i, f, i, f, ip, i, fp]),
        "eet_trie_decode_nbest": (i, [vp, fp, i, i, i, f, i, f, i, ip, i, ip, fp]),
        "eet_trie_set_lm": (None, [vp, vp, f, ip, i]),
        # ARPA n-gram LM
        "eet_lm_load": (vp, [cp]), "eet_lm_free": (None, [vp]),
        "eet_lm_order": (i, [vp]), "eet_lm_vocab_size": (i, [vp]),
        "eet_lm_word_id": (i, [vp, cp]),
        "eet_lm_score_sequence": (f, [vp, ip, i, i]),
        # SentencePiece engine, all four model types
        "eet_bpe_load": (vp, [cp]), "eet_bpe_free": (None, [vp]),
        "eet_bpe_piece_size": (i, [vp]), "eet_bpe_special": (i, [vp, i]),
        "eet_bpe_piece_type": (i, [vp, i]),
        "eet_bpe_id_to_piece": (i, [vp, i, cp, i]),
        "eet_bpe_encode_n": (i, [vp, cp, c.c_long, ip, i]),
        "eet_bpe_decode": (i, [vp, ip, i, cp, i]),
        "eet_bpe_normalize": (i, [vp, cp, cp, i]),
        # its trainers: corpus, prefix, vocab, unk/bos/eos/pad ids, the
        # user-defined pieces, model type, rule name, rule TSV, byte fallback
        "eet_spm_train_norm_ex": (i, [cp, cp, i, i, i, i, i, cp, i, cp, cp, i]),
        # a normalization rule TSV -> charsmap blob file; its size
        "eet_charsmap_compile": (c.c_long, [cp, cp]),
    }
    for name, (res, args) in sigs.items():
        fn = getattr(lib, name)
        fn.restype = res
        fn.argtypes = args
