"""Drive the PyTorch/CUDA port's main path on one GPU and check it.

    python3 chip_smoke.py

Phases (any failure exits non-zero, with no result line):
  1. build both CUDA kernels from `early_exit_tpu_torch/csrc` with nvcc
     (sm_90a, one nvcc per source, in parallel);
  2. hold each kernel against its plain PyTorch version on the card, at
     the flagship's weights and main-path shapes (B=8, T'=249, ragged
     lengths with one short and one empty item), and the block kernel
     again past the TPU kernel's T' <= 512 (B=2, 60 s and 45 s, T'=1499);
     the block kernel with the other softmax dtype must fall outside the
     tolerance, which shows the tolerance sees a moved rounding point;
  3. the main path end to end: `Recognizer.from_flagship("cuda")` on 128
     in-distribution ~10 s requests, launch counts read around that run;
     its greedy tokens against the same path built from the kernels'
     plain versions and against the unfused PyTorch path, each held to
     <= 1% token disagreement pooled over the exits (bench.py's
     contract) and <= 1% at every exit that transcribes (in-distribution
     WER within bench.py's 30% sanity bound); and the final-exit WER
     against that bound. Against the plain versions every exit is held
     to 1%. Exit 1 of the flagship decodes at ~90% WER on near-tie
     logits, where the plain-version path and the unfused path, neither
     of which runs a kernel, already disagree by about 1%; so against the
     unfused path exit 1 is held to the pooled contract only, and the
     no-kernel pair's rates are printed beside it;
  4. times at B=128 x 10 s (T'=249): each kernel, its plain version, a
     library yardstick (the block composed of torch ops with cuBLAS,
     SDPA and cuDNN; the heads as torch.matmul + argmax) and its bound;
     the end-to-end forward in audio-seconds per second;
  5. torch.profiler over a few end-to-end forwards of phase 4: device
     time per kernel and the device-busy share.

The line before the last is the `kernels` JSON; the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
PEAK_BF16 = 989e12      # H100 SXM dense bf16 FLOP/s (NVIDIA data sheet)
PEAK_BYTES = 3.35e12    # H100 SXM HBM3 bytes/s
SANE_DENSE_WER = 30.0   # bench.py's in-distribution sanity bound
# bf16 tolerance of the block kernel against its plain version, in bf16
# ulps of the plain value (2^-7 below |y| = 1) and in the share of values
# that differ at all. The two sum the softmax denominator over T' keys in
# different float32 orders, so a rare row's bf16 denominator moves by an
# ulp, and more rows as T' grows. On an H100 the sound kernel gave 1 ulp
# and 0.07% of values at T'=249, 3 ulps and 2.2% at T'=1499; the kernel
# with the float32 softmax against the bf16 plain version gave 5 ulps and
# 7.8%, and 6.25 ulps and 21%.
BLOCK_MAX_ULPS = 4
BLOCK_DIFFERING = 0.05
TOKEN_DISAGREE = 0.01


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def card_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    if r.returncode != 0 or not r.stdout.strip():
        fail(f"nvidia-smi failed: {r.stderr.strip()}")
    return r.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def edit_distance(a, b) -> int:
    import numpy as np
    d = np.arange(len(b) + 1)
    for i in range(1, len(a) + 1):
        prev, d[0] = d.copy(), i
        for j in range(1, len(b) + 1):
            d[j] = min(prev[j] + 1, d[j - 1] + 1,
                       prev[j - 1] + (a[i - 1] != b[j - 1]))
    return int(d[len(b)])


def disagreement(tok_a, n_a, tok_b, n_b):
    """Per exit (edits, reference tokens) of a's greedy tokens against b's."""
    out = []
    for e in range(tok_a.shape[0]):
        edits = total = 0
        for i in range(tok_a.shape[1]):
            x = tok_a[e, i, :n_a[e, i]].tolist()
            y = tok_b[e, i, :n_b[e, i]].tolist()
            edits += edit_distance(x, y)
            total += max(len(y), 1)
        out.append((edits, total))
    return out


def main() -> None:
    if not os.path.isdir(os.path.join(HERE, "early_exit_tpu_torch")):
        fail("early_exit_tpu_torch/ not found beside chip_smoke.py; run it "
             "from a checkout of the repository")
    sys.path.insert(0, HERE)
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false")

    from early_exit_tpu_torch import checkpoint, runtime
    from early_exit_tpu_torch.data.synthetic import synth_batch
    from early_exit_tpu_torch.ops import ctc, frontend
    from early_exit_tpu_torch.ops.kernels import KERNEL_SOURCES, _build
    from early_exit_tpu_torch.ops.kernels import conformer_block as kcb
    from early_exit_tpu_torch.ops.kernels import head_argmax as kha
    from early_exit_tpu_torch.serving.recognizer import Recognizer, wer_pct

    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(card)            # nvidia-smi's name and power limit, as it gives them
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python "
          f"{sys.version.split()[0]}")
    runtime.exact_float32()
    dev = torch.device("cuda")

    # ---- 1. build
    t0 = time.perf_counter()
    _build.build_all(KERNEL_SOURCES)
    print(f"build: {time.perf_counter() - t0:.1f} s (nvcc, sm_90a)")
    for name in KERNEL_SOURCES:
        with open(_build.lib_path(name) + ".log") as f:
            regs = [ln.split(":", 1)[1].strip() for ln in f
                    if "Used" in ln and "registers" in ln]
        print(f"ptxas {name}: {regs}")

    # ---- flagship, both paths, and the in-distribution requests
    rec_k = Recognizer.from_flagship("cuda", fused=True)
    rec_u = Recognizer.from_flagship("cuda", fused=False)
    model, cfg, acfg = rec_k.model, rec_k.model.cfg, rec_k.acfg
    knobs = checkpoint.load_calib().get("bench_eval", {})
    B, N = 128, 10 * acfg.sample_rate
    wav_np, counts_np, refs = synth_batch(knobs, B, seed=4242)
    wav = np.zeros((B, N), np.float32)
    m = min(N, wav_np.shape[1])
    wav[:, :m] = wav_np[:, :m]
    wav = torch.as_tensor(wav, device=dev)
    counts = torch.as_tensor(np.minimum(counts_np, N), device=dev)
    kw = dict(n_heads=cfg.n_heads, kernel_size=cfg.depthwise_kernel_size,
              compute_dtype=cfg.dtype, residual_dtype=cfg.rdtype,
              attn_softmax_dtype=cfg.sm_dtype)
    folded = model.stack.folded()
    heads_w = model.heads_w.to(torch.bfloat16)
    heads_b = model.heads_b.to(torch.bfloat16)

    def embed(w, c):
        """mel -> subsampling + PE: (x, sub_len, mask, lengths int32)."""
        feats = frontend.mel_spectrogram(w, acfg, method="dft")
        x, sub_len, mask = model.frontend_embed(
            feats, frontend.mel_lengths(c, acfg.hop_length))
        return x.contiguous(), sub_len, mask, mask.sum(1, dtype=torch.int32)

    def exit_hidden(m, w, c):
        """(E, B, T', D) bf16 exit hiddens of model m's trunk."""
        x, _, mask, _ = embed(w, c)
        _, hs = m.stack(x, mask, collect_outputs=True,
                        collect_every=cfg.n_enc_layers_per_exit)
        return hs.to(torch.bfloat16).contiguous()

    def block_vs_plain(x, lengths, what, **over):
        """Block kernel (kw overridden by `over`) against the plain version
        in the main path's profile: (max|d|, within the tolerance)."""
        y_k = kcb.conformer_block(folded[0], x, lengths, **{**kw, **over})
        y_p = kcb.conformer_block_plain(folded[0], x, lengths, **kw)
        torch.cuda.synchronize()
        if not torch.isfinite(y_k.float()).all():
            fail(f"conformer_block kernel gave non-finite values ({what})")
        if (y_k[lengths == 0] != 0).any():
            fail("conformer_block kernel: an empty item is not all zeros")
        d = (y_k.float() - y_p.float()).abs()
        err, mean = float(d.max()), float(d.mean())
        # bf16 ulp of each plain value (8 significant bits), 2^-7 at |y| < 1
        ulp = torch.exp2(torch.floor(torch.log2(
            y_p.float().abs().clamp_min(1.0))) - 7)
        ulps, frac = float((d / ulp).max()), float((d > 0).float().mean())
        print(f"conformer_block vs plain, {what} (B={x.shape[0]}, "
              f"T'={x.shape[1]}, lengths {lengths.tolist()}): max|d| {err} "
              f"mean|d| {mean} max ulps {ulps} values differing {frac} "
              f"(tolerance {BLOCK_MAX_ULPS} ulps, {BLOCK_DIFFERING})")
        return err, ulps <= BLOCK_MAX_ULPS and frac <= BLOCK_DIFFERING

    # ---- 2. each kernel against its plain version, B=8, one short item
    with torch.no_grad():
        c8 = counts[:8].clone()
        c8[-1] = acfg.sample_rate          # a 1 s request among ~10 s ones
        c8[-2] = 0                         # and an empty one
        x8, _, _, len8 = embed(wav[:8], c8)
        # past the TPU kernel's T' <= 512: 60 s and 45 s of the requests
        # laid end to end
        long_c = torch.tensor([60, 45], device=dev) * acfg.sample_rate
        xl, _, _, lenl = embed(wav[:12].reshape(2, -1), long_c)
        other = (torch.float32 if cfg.sm_dtype == torch.bfloat16
                 else torch.bfloat16)
        r = [block_vs_plain(x8, len8, "main-path shape"),
             block_vs_plain(xl, lenl, "past T'=512"),
             block_vs_plain(x8, len8, f"kernel with {other} softmax",
                            attn_softmax_dtype=other),
             block_vs_plain(xl, lenl, f"past T'=512, kernel with {other} softmax",
                            attn_softmax_dtype=other)]
        if not (r[0][1] and r[1][1]):
            fail("conformer_block kernel disagrees with its plain version")
        if r[2][1] or r[3][1]:
            fail("the block tolerance cannot tell the softmax dtypes apart")
        blk_err = max(r[0][0], r[1][0])

        h8 = exit_hidden(rec_u.model, wav[:8], c8)
        ids_k = kha.head_argmax(h8, heads_w, heads_b)
        ids_p = kha.head_argmax_plain(h8, heads_w, heads_b)
        torch.cuda.synchronize()
        logits = (torch.matmul(h8.float(), heads_w.float()[:, None])
                  .to(torch.bfloat16) + heads_b[:, None, None]).float()
        l_k = logits.gather(-1, ids_k.long()[..., None])
        l_p = logits.gather(-1, ids_p.long()[..., None])
        n_diff = int((ids_k != ids_p).sum())
        n_nontie = int(((ids_k != ids_p) & (l_k[..., 0] != l_p[..., 0])).sum())
        head_err = float((l_k - l_p).abs().max())
        print(f"head_argmax vs plain (E=6, B=8, T'={h8.shape[2]}): "
              f"{n_diff} ids differ, {n_nontie} not at exact bf16 ties")
        if n_nontie:
            fail("head_argmax kernel id differs from the plain version at a non-tie")

    # ---- 3. the main path end to end, launch counts around it
    def plain_path_ids(w, c):
        """The kernel path rebuilt from the kernels' plain versions."""
        x, sub_len, _, lengths = embed(w, c)
        hs = []
        for i, f in enumerate(folded):
            x = kcb.conformer_block_plain(f, x, lengths, **kw)
            if (i + 1) % cfg.n_enc_layers_per_exit == 0:
                hs.append(x)
        return kha.head_argmax_plain(torch.stack(hs), heads_w, heads_b), sub_len

    def greedy(ids, sub_len):
        E, Bn, T = ids.shape
        t, n = ctc.greedy_decode_ids(ids.reshape(E * Bn, T), sub_len.repeat(E))
        return t.reshape(E, Bn, T).cpu(), n.reshape(E, Bn).cpu()

    with torch.no_grad():
        kcb.conformer_block.launches = 0
        kha.head_argmax.launches = 0
        out_k = rec_k.transcribe(wav, counts)
        torch.cuda.synchronize()
        launches = {"conformer_block": kcb.conformer_block.launches,
                    "head_argmax": kha.head_argmax.launches}
        print(f"main path launches: {launches}")
        if launches["conformer_block"] != len(folded) or launches["head_argmax"] != 1:
            fail(f"the main path did not run through both kernels: {launches}")
        out_u = rec_u.transcribe(wav, counts)
        tok_p, n_p = greedy(*plain_path_ids(wav, counts))
    ladder = [round(wer_pct(refs, t), 2) for t in out_k.texts]
    ladder_u = [round(wer_pct(refs, t), 2) for t in out_u.texts]
    print(f"exit WER ladder, kernel path (B={B}): {ladder}")
    print(f"exit WER ladder, unfused path: {ladder_u}")
    for i in range(3):
        print(f"EXPECTED: {refs[i]}")
        print(f"EXIT_6:   {out_k.texts[-1][i]}")
    vs_plain = disagreement(out_k.tokens, out_k.n_tokens, tok_p, n_p)
    vs_unfused = disagreement(out_k.tokens, out_k.n_tokens,
                              out_u.tokens, out_u.n_tokens)
    # two bf16 schedules with no kernel in either, for scale
    no_kernel = disagreement(tok_p, n_p, out_u.tokens, out_u.n_tokens)
    print(f"token disagreement, plain-version path vs unfused path (no "
          f"kernel): per exit {[f'{e}/{t}' for e, t in no_kernel]}")
    # the kernel against its plain versions: <= 1% at every exit; against
    # the unfused path: <= 1% pooled and at every exit that transcribes
    for what, dis, every in (("plain versions", vs_plain, True),
                             ("unfused path", vs_unfused, False)):
        pooled = sum(e for e, _ in dis) / sum(t for _, t in dis)
        print(f"token disagreement, kernel path vs {what}: per exit "
              f"{[f'{e}/{t}' for e, t in dis]}, pooled {100 * pooled:.3f}%")
        if pooled > TOKEN_DISAGREE:
            fail(f"kernel path disagrees with the {what} by > 1% pooled")
        for i, ((e, t), wer) in enumerate(zip(dis, ladder)):
            if (every or wer <= SANE_DENSE_WER) and e > TOKEN_DISAGREE * t:
                fail(f"kernel path disagrees with the {what} by > 1% at "
                     f"exit {i + 1}")
    if ladder[-1] > SANE_DENSE_WER:
        fail(f"final-exit WER {ladder[-1]}% > {SANE_DENSE_WER}%: broken harness")

    # ---- 4. times at B=128 x 10 s, full-length requests
    with torch.no_grad():
        full = torch.full_like(counts, N)
        x, _, _, lengths = embed(wav, full)
        f0 = folded[0]
        R, D, T = B * x.shape[1], x.shape[2], x.shape[1]
        Fd, H, K = cfg.d_feed_forward, cfg.n_heads, cfg.depthwise_kernel_size
        blk_flops = (2 * R * D * (4 * Fd + 3 * D + D + 2 * D + D)
                     + 4 * B * H * T * T * (D // H) + 2 * R * D * K)
        w_bytes = sum(t.numel() * t.element_size() for t in f0.values())
        blk_bytes = 2 * R * D * 2 + w_bytes + B * 4
        blk = dict(
            ms=cuda_ms(lambda: kcb.conformer_block(f0, x, lengths, **kw)),
            plain_ms=cuda_ms(lambda: kcb.conformer_block_plain(f0, x, lengths, **kw), 5, 1),
            library_ms=cuda_ms(lambda: block_library(f0, x, lengths, H)),
            bound=(blk_flops / PEAK_BF16, blk_bytes / PEAK_BYTES))
        hid = exit_hidden(model, wav, full)
        E = hid.shape[0]
        V = heads_w.shape[-1]
        head_flops = 2 * E * R * D * V
        head_bytes = hid.numel() * 2 + heads_w.numel() * 2 + heads_b.numel() * 2 + E * R * 4
        head = dict(
            ms=cuda_ms(lambda: kha.head_argmax(hid, heads_w, heads_b)),
            plain_ms=cuda_ms(lambda: kha.head_argmax_plain(hid, heads_w, heads_b)),
            library_ms=cuda_ms(lambda: torch.argmax(
                torch.matmul(hid, heads_w[:, None]) + heads_b[:, None, None], -1)),
            bound=(head_flops / PEAK_BF16, head_bytes / PEAK_BYTES))

        def forward(rec):
            ids, sub_len = rec.exit_ids(wav, full)
            E_, B_, T_ = ids.shape
            return ctc.greedy_decode_ids(ids.reshape(E_ * B_, T_), sub_len.repeat(E_))

        e2e_ms = cuda_ms(lambda: forward(rec_k), 10, 2)
        e2e_u_ms = cuda_ms(lambda: forward(rec_u), 10, 2)
    audio_s = B * N / acfg.sample_rate
    print(f"times on {card} (B={B}, T'={T}, CUDA events):")
    for name, t in (("conformer_block", blk), ("head_argmax", head)):
        by = "operations" if t["bound"][0] >= t["bound"][1] else "bytes"
        t["bound_ms"], t["bound_by"] = 1e3 * max(t["bound"]), by
        print(f"  {name}: kernel {t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, "
              f"library {t['library_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms "
              f"({by}: {t['bound'][0] * 1e3:.4f} ms ops, {t['bound'][1] * 1e3:.4f} ms bytes)")
    print(f"  end to end, kernel path: {e2e_ms:.3f} ms per {B} x 10 s = "
          f"{audio_s / (e2e_ms / 1e3):.1f} audio-s/s")
    print(f"  end to end, unfused path: {e2e_u_ms:.3f} ms = "
          f"{audio_s / (e2e_u_ms / 1e3):.1f} audio-s/s")
    profile_forward(lambda: forward(rec_k), card, B)

    rows = []
    for name, t, err, line in (
            ("conformer_block", blk, blk_err,
             "early_exit_tpu/ops/pallas/conformer_block.py:368"),
            ("head_argmax", head, head_err,
             "early_exit_tpu/ops/pallas/head_argmax.py:53")):
        rows.append({"name": name, "route": "cuda",
                     "source": f"early_exit_tpu_torch/csrc/{name}.cu",
                     "replaces": line, "launches": launches[name],
                     "max_abs_err": err, "ms": t["ms"],
                     "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                     "bound_by": t["bound_by"], "library_ms": t["library_ms"]})
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))


def profile_forward(forward, card: str, B: int, iters: int = 3) -> None:
    """Phase 5: device time per kernel name over `iters` forwards (each
    B x 10 s), and the share of the wall time the device was busy."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with torch.no_grad(), profile(activities=[ProfilerActivity.CPU,
                                              ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            forward()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / iters
    rows = sorted(((ev.key, ev.self_device_time_total / 1e3 / iters,
                    ev.count // iters) for ev in prof.key_averages()
                   if ev.device_type == DeviceType.CUDA),   # kernels only
                  key=lambda r: -r[1])
    busy = sum(r[1] for r in rows)
    print(f"profile on {card} (B={B} x 10 s, torch.profiler): wall "
          f"{wall_ms:.3f} ms per forward, device busy {busy:.3f} ms "
          f"({100 * busy / wall_ms:.1f}%)")
    print(f"{'ms/forward':>11} {'calls':>6}  kernel")
    for name, ms, n in rows[:25]:
        print(f"{ms:11.4f} {n:6d}  {name[:110]}")


def block_library(f, x, lengths, n_heads):
    """Yardstick: the same block composed of library calls (cuBLAS bf16
    products, SDPA, cuDNN depthwise conv, torch LayerNorm). Timed here
    only; the port never calls it."""
    import torch
    import torch.nn.functional as F
    B, T, D = x.shape
    valid = torch.arange(T, device=x.device)[None, :] < lengths[:, None]

    def ln(v, g, b):
        return F.layer_norm(v, (D,), g.to(v.dtype), b.to(v.dtype))

    def ffn(v, pre):
        y = F.silu(torch.matmul(ln(v, f[pre + "_ln_g"], f[pre + "_ln_b"]),
                                f[pre + "_w1"]) + f[pre + "_b1"])
        return torch.matmul(y, f[pre + "_w2"]) + f[pre + "_b2"]

    x = x + 0.5 * ffn(x, "ffn1")
    qkv = torch.matmul(ln(x, f["attn_ln_g"], f["attn_ln_b"]), f["wqkv"]) + f["bqkv"]
    q, k, v = (t.reshape(B, T, n_heads, D // n_heads).transpose(1, 2)
               for t in qkv.split(D, -1))
    o = F.scaled_dot_product_attention(q, k, v, attn_mask=valid[:, None, None, :])
    x = x + torch.matmul(o.transpose(1, 2).reshape(B, T, D), f["wo"]) + f["bo"]
    y = torch.matmul(ln(x, f["conv_ln_g"], f["conv_ln_b"]), f["pw1_w"]) + f["pw1_b"]
    y = F.glu(y, dim=-1) * valid[..., None]
    k_ = f["dw_w"].shape[0]
    y = F.conv1d(y.transpose(1, 2), f["dw_w"].t()[:, None, :], f["dw_b"].to(y.dtype),
                 padding=(k_ - 1) // 2, groups=D).transpose(1, 2)
    y = F.silu(y * f["bn_scale"].to(y.dtype) + f["bn_shift"].to(y.dtype))
    x = x + torch.matmul(y, f["pw2_w"]) + f["pw2_b"]
    x = x + 0.5 * ffn(x, "ffn2")
    return ln(x, f["final_ln_g"], f["final_ln_b"]) * valid[..., None]


if __name__ == "__main__":
    main()
