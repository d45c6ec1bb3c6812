"""Multi-process validation of data and tensor parallelism in training
(counterpart of the JAX package's `tools/multiprocess_smoke.py`).

    python -m early_exit_tpu_torch.multiprocess_smoke [--device cpu|cuda]
    python -m early_exit_tpu_torch.multiprocess_smoke --flagship

(--device defaults to cuda, and raises without a GPU.)

The parent builds the tiny flagship (the JAX tool's configuration) and
one global batch of 8 synthetic utterances, runs 2 train steps on one
rank, then spawns 4 rank processes on a free TCP port (bound to port 0)
that run the same 2 steps on two meshes in turn: data=2 x model=2, and
replica=2 x data=1 x model=2. Sharding must not change the math: each
mesh's step-1 loss and grad norm lie within rtol 1e-4 of the single
rank's, its step-2 loss within 2e-3 (the JAX package's tolerances,
`tests/test_sharding.py`). One torch thread a rank; gloo on the CPU,
NCCL on CUDA (which needs a card a rank).

--flagship (CUDA) takes the committed flagship's weights at its widths
(d 256, ffn 2048, 12 blocks, 6 exits, V 256) and 16 synthetic requests
of the calibration's distribution (T = 900 frames), dropout 0, float32
and bf16 (the train CLI's default dtype), and runs 4 steps each on one
rank, and on the meshes data=4, data=2 x model=2, model=4 and data=2 of
4 ranks (NCCL, a card a rank, where 4 cards are visible; else gloo, the
ranks sharing the card), printing each step's loss, grad norm and
seconds; float32 meshes are held to the JAX tolerances. As bf16 rounds
other sums under another layout, its readings stand beside one rank's
drift from itself under the same math (the rows reversed, 16 padding
rows appended for other product shapes, four seeded row orders), with
the first step's largest gradient leaves.

`run_world` and `run_scenario` are the machinery: a job of scenarios
(model and train configuration, mesh, steps, a checkpoint to start
from and a directory to save to), run by every rank of one world, the
mesh's first rank writing each scenario's losses, grad norms and
BatchNorm state. The tests and `chip_smoke.py` spawn their worlds
through them.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import socket
import subprocess
import sys
import tempfile
import time
from typing import Dict, List, Optional

import torch
import torch.distributed as dist

from early_exit_tpu_torch import interop, parallel, runtime
from early_exit_tpu_torch.configs import ModelConfig, TrainConfig
from early_exit_tpu_torch.models.registry import build_model
from early_exit_tpu_torch.training import checkpoint
from early_exit_tpu_torch.training.trainer import Trainer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GLOBAL_BATCH = 8
STEPS = 2
SEED = 0
# the JAX package's tolerances (tests/test_sharding.py)
LOSS_RTOL = 1e-4            # the first step's loss and grad norm
NEXT_LOSS_RTOL = 2e-3       # the next step's loss
TINY_ARGS = ["--decoder_mode", "ctc", "--synthetic_data", "true", "--d_model", "32",
             "--n_enc_exits", "2", "--n_enc_layers_per_exit", "1", "--n_heads", "4",
             "--d_feed_forward", "64", "--depthwise_kernel_size", "7",
             "--batch_size", str(GLOBAL_BATCH), "--n_batch_split", "1"]


def free_port() -> int:
    """A TCP port that was free a moment ago (bound to port 0)."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_scenario(sc: dict, batch: Dict[str, torch.Tensor], device: torch.device,
                 mesh: Optional[parallel.Mesh] = None) -> dict:
    """One scenario on this rank: the model of sc["model"] (ModelConfig
    fields) drawn from sc.get("seed", 0) on the CPU, or loaded from
    sc["load"] (a model checkpoint file, with sc.get("load_opt") its
    optimizer file), sharded over `mesh`, trained sc["steps"] steps on
    its rows of `batch` (the global batch), and saved as epoch 0 to
    sc["save"] if given. Returns {"loss", "grad_norm", "per_exit",
    "state", "seconds"} per step ("state" the BatchNorm tree, numpy, after
    it; "seconds" the step's wall, its loss read back), with
    sc["keep_params"] the parameters at the end ("params"), and with
    sc["leaf_norms"] the first step's gradient norm a parameter name
    ("leaf_norms", the whole leaf's under tensor parallelism)."""
    model = build_model(ModelConfig(**sc["model"]))
    model.init(torch.Generator().manual_seed(sc.get("seed", 0)))
    model = model.to(device)
    tcfg = TrainConfig(**sc.get("train", {}))
    if mesh is not None:
        parallel.replicate([*model.parameters(), *model.buffers()], mesh)
        parallel.shard_params(model, mesh)
        batch = parallel.shard_batch(batch, mesh)
    trainer = Trainer(model, tcfg, warmup=sc.get("warmup", 100))
    if sc.get("load"):
        checkpoint.load_model_file(model, sc["load"])
        if sc.get("load_opt"):
            checkpoint.load_opt_tree(model, trainer.opt, checkpoint.load_tree(sc["load_opt"]))
    if sc.get("leaf_norms"):
        step, grads = trainer.opt.step, []

        def keep(g):
            if not grads:
                grads.append([t.clone() for t in g])
            return step(g)
        trainer.opt.step = keep
    batch = {k: v.to(device) for k, v in batch.items()}
    out = {"loss": [], "grad_norm": [], "per_exit": [], "state": [], "seconds": []}
    for _ in range(sc["steps"]):
        t0 = time.perf_counter()
        m = trainer.step(batch)
        out["loss"].append(float(m["loss"]))
        out["seconds"].append(time.perf_counter() - t0)
        out["grad_norm"].append(float(m["grad_norm"]))
        out["per_exit"].append(m["loss_per_exit"].cpu().numpy().tolist())
        out["state"].append(interop.numpy_tree(model.state()))
    if sc.get("keep_params"):
        out["params"] = [p.detach().cpu().clone() for p in model.parameters()]
    if sc.get("leaf_norms"):
        names = {p: n for n, p in model.named_parameters()}
        out["leaf_norms"] = {names[p]: float(t.float().norm()) for p, t in
                             checkpoint.full_tensors(model, grads[0]).items()}
    if sc.get("save"):
        os.makedirs(sc["save"], exist_ok=True)
        checkpoint.save_epoch(sc["save"], 0, model, trainer.opt)
    return out


def _child(rank: int, world: int, port: int, job_path: str) -> None:
    job = torch.load(job_path, weights_only=False)
    torch.set_num_threads(1)
    device = torch.device(job["device"])
    if device.type == "cuda":
        device = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(device)
    kw = {"device_id": device} if job["backend"] == "nccl" else {}
    dist.init_process_group(job["backend"], init_method=f"tcp://localhost:{port}",
                            world_size=world, rank=rank, **kw)
    if device.type == "cuda":
        runtime.exact_float32()         # as the single-rank card step
    for sc in job["scenarios"]:
        m = sc["mesh"]
        mesh = parallel.make_mesh(m.get("ranks"), dp=m.get("dp"), tp=m.get("tp", 1),
                                  dcn=m.get("dcn", 1))
        if mesh is None:            # a rank outside this scenario's mesh
            continue
        res = run_scenario(sc, job["batches"][sc.get("batch", "main")], device, mesh)
        if mesh.is_first:
            torch.save(res, os.path.join(job["out"], sc["name"] + ".pt"))
    dist.barrier()
    dist.destroy_process_group()


def run_world(scenarios: List[dict], batches: Dict[str, dict], *, world: int,
              device: str = "cpu", backend: str = "gloo", timeout: float = 600.0,
              workdir: Optional[str] = None) -> Dict[str, dict]:
    """Spawns `world` rank processes that run every scenario in order (each
    on the mesh of sc["mesh"]: dp, tp, dcn, and optionally the ranks it
    spans) on the global batches (name -> {key: CPU tensor}); returns
    {scenario name: run_scenario's result from the mesh's first rank}.
    Raises with the ranks' output if one fails."""
    tmp = tempfile.mkdtemp(prefix="eet_world_", dir=workdir)
    job = {"device": device, "backend": backend, "scenarios": scenarios,
           "batches": batches, "out": tmp}
    job_path = os.path.join(tmp, "job.pt")
    torch.save(job, job_path)
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    port = free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "early_exit_tpu_torch.multiprocess_smoke", "--child",
         str(r), "--world", str(world), "--port", str(port), "--job", job_path],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env, cwd=REPO)
        for r in range(world)]
    try:
        outs = [p.communicate(timeout=timeout)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    bad = [(r, p.returncode, o) for r, (p, o) in enumerate(zip(procs, outs)) if p.returncode]
    if bad:
        raise RuntimeError("\n".join(f"rank {r} exited {rc}:\n{o[-3000:]}" for r, rc, o in bad))
    return {sc["name"]: torch.load(os.path.join(tmp, sc["name"] + ".pt"), weights_only=False)
            for sc in scenarios}


def check(name: str, got: dict, want: dict) -> List[str]:
    """The JAX package's tolerances: the faults of `got` against `want`
    (run_scenario results of two or more steps)."""
    faults = []
    for key, i, rtol in (("loss", 0, LOSS_RTOL), ("grad_norm", 0, LOSS_RTOL),
                         ("loss", 1, NEXT_LOSS_RTOL)):
        a, b = got[key][i], want[key][i]
        if not abs(a - b) <= rtol * abs(b):
            faults.append(f"{name}: step {i + 1} {key} {a:.6f} vs {b:.6f} (rtol {rtol})")
    return faults


def tiny_setup():
    """The tiny flagship's ModelConfig fields and one global batch of
    GLOBAL_BATCH synthetic utterances (CPU tensors), as the train CLI
    builds them."""
    from early_exit_tpu_torch.cli import get_args
    from early_exit_tpu_torch.data.librispeech import SyntheticDataset
    from early_exit_tpu_torch.data.pipeline import Pipeline

    args, model_cfg, train_cfg, audio_cfg, tok = get_args(TINY_ARGS + ["--drop_prob", "0",
                                                                        "--compute_dtype",
                                                                        "float32"])
    pipe = Pipeline(SyntheticDataset(n_items=GLOBAL_BATCH, seed=SEED), tok, audio_cfg,
                    train_cfg, bpe=args.bpe, shuffle=False, seed=SEED, workers=1,
                    device="cpu")
    batch = next(pipe.epoch(0))
    return dataclasses.asdict(model_cfg), batch


def flagship_batch() -> Dict[str, torch.Tensor]:
    """16 synthetic requests of the calibration's distribution (seed 4343)
    as one featurized CPU sub-batch of the train pipeline."""
    from early_exit_tpu_torch import checkpoint as ckpt
    from early_exit_tpu_torch.configs import AudioConfig
    from early_exit_tpu_torch.data import text
    from early_exit_tpu_torch.data.pipeline import Pipeline
    from early_exit_tpu_torch.data.synthetic import synth_batch
    from early_exit_tpu_torch.tokenizer import load_tokenizer

    calib = ckpt.load_calib()
    tok = load_tokenizer(ckpt.bound_tokenizer(calib))
    pipe = Pipeline([], tok, AudioConfig(), TrainConfig(), device="cpu")
    wav, counts, refs = synth_batch(calib.get("bench_eval", {}), 16, 4343)
    items = [(wav[i, :counts[i]], text.encode_target(text.clean_train_label(refs[i]), tok), "")
             for i in range(16)]
    host = {k: torch.from_numpy(v) for k, v in pipe.host_subbatch(items).items()}
    return pipe.to_device(host)


def _padded(batch: Dict[str, torch.Tensor], rows: int) -> Dict[str, torch.Tensor]:
    """The batch with `rows` padding rows appended (no frames, no label,
    weight 0): the same loss and gradients from other product shapes."""
    return {k: torch.cat([v, torch.zeros((rows,) + v.shape[1:], dtype=v.dtype)])
            for k, v in batch.items()}


def flagship(steps: int = 4) -> int:
    """The --flagship report (module docstring); returns the exit code."""
    from early_exit_tpu_torch import checkpoint as ckpt

    device = runtime.resolve_device("cuda")
    runtime.exact_float32()
    cards = torch.cuda.device_count()
    backend = "nccl" if cards >= 4 else "gloo"
    batch = flagship_batch()
    print(f"flagship: {torch.cuda.get_device_name(0)} x {cards}, 4 ranks over {backend}; "
          f"batch {({k: tuple(v.shape) for k, v in batch.items()})}", flush=True)
    meshes = {"data=4": {"dp": 4}, "data=2 x model=2": {"dp": 2, "tp": 2},
              "model=4": {"dp": 1, "tp": 4}, "data=2": {"ranks": [0, 1], "dp": 2}}
    variants = {"rows reversed": {k: v.flip(0) for k, v in batch.items()},
                "16 padding rows": _padded(batch, 16)}
    for seed in range(1, 5):
        order = torch.randperm(16, generator=torch.Generator().manual_seed(seed))
        variants[f"rows permuted (seed {seed})"] = {k: v[order] for k, v in batch.items()}
    faults = []
    for dtype in ("float32", "bfloat16"):
        sc = {"model": dataclasses.asdict(ModelConfig(compute_dtype=dtype, drop_prob=0.0)),
              "steps": steps, "load": ckpt.FLAGSHIP_CKPT, "leaf_norms": True}
        runs = {"one rank": run_scenario(sc, batch, device)}
        runs.update({f"one rank, {n}": run_scenario(sc, b, device)
                     for n, b in variants.items()})
        t0 = time.perf_counter()
        runs.update(run_world([dict(sc, name=n, mesh=m) for n, m in meshes.items()],
                              {"main": batch}, world=4, device="cuda", backend=backend))
        print(f"{dtype}: the world of 4 ranks {time.perf_counter() - t0:.1f} s", flush=True)
        one = runs["one rank"]
        for name, res in runs.items():
            top = sorted(res["leaf_norms"], key=res["leaf_norms"].get, reverse=True)[:4]
            print(f"{dtype} {name}: loss {res['loss']} grad_norm {res['grad_norm']} seconds "
                  f"{[round(x, 4) for x in res['seconds']]}; largest step-1 gradient leaves "
                  + ", ".join(f"{k} {res['leaf_norms'][k]:.4g} (one rank "
                              f"{one['leaf_norms'][k]:.4g})" for k in top), flush=True)
            if dtype == "float32" and name in meshes:
                faults += check(f"{dtype} {name}", res, one)
        spread = {part: [runs[n]["grad_norm"][0] for n in names] for part, names in
                  (("same-math variants", [f"one rank, {v}" for v in variants]),
                   ("meshes", list(meshes)))}
        print(f"{dtype}: step-1 grad norm, one rank {one['grad_norm'][0]:.6f}; "
              + "; ".join(f"{part} {min(v):.6f} to {max(v):.6f}" for part, v in spread.items()),
              flush=True)
    if faults:
        print("FAIL: " + "; ".join(faults))
        return 1
    print("flagship ok: float32 on every mesh within the JAX tolerances of one rank")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=["cpu", "cuda"],
                    help="the ranks' device (default cuda; raises without it)")
    ap.add_argument("--flagship", action="store_true",
                    help="the flagship's widths and weights on CUDA, float32 and bf16 "
                         "(module docstring)")
    ap.add_argument("--child", type=int, default=None)
    ap.add_argument("--world", type=int, default=None)
    ap.add_argument("--port", type=int, default=None)
    ap.add_argument("--job", default=None)
    a = ap.parse_args(argv)
    if a.child is not None:
        _child(a.child, a.world, a.port, a.job)
        return 0
    if a.flagship:
        return flagship()
    backend = "gloo" if a.device == "cpu" else "nccl"
    device = runtime.resolve_device(a.device)
    if device.type == "cuda":
        runtime.exact_float32()         # as the ranks
    torch.set_num_threads(1)
    model, batch = tiny_setup()
    base = {"model": model, "steps": STEPS, "seed": SEED}
    single = run_scenario(base, batch, device)
    meshes = {"data=2 x model=2": {"dp": 2, "tp": 2},
              "replica=2 x data=1 x model=2": {"dcn": 2, "dp": 1, "tp": 2}}
    got = run_world([{**base, "name": n, "mesh": m} for n, m in meshes.items()],
                    {"main": batch}, world=4, device=a.device, backend=backend)
    faults = []
    for n in meshes:
        for s in range(STEPS):
            print(f"step {s + 1}: {n} loss {got[n]['loss'][s]:.6f} grad_norm "
                  f"{got[n]['grad_norm'][s]:.6f}; single rank loss {single['loss'][s]:.6f} "
                  f"grad_norm {single['grad_norm'][s]:.6f}")
        faults += check(n, got[n], single)
    if faults:
        print("FAIL: " + "; ".join(faults))
        return 1
    print(f"multiprocess_smoke ok: 4 ranks ({backend}, {a.device}), meshes "
          f"{' and '.join(meshes)}, {STEPS} steps equal to the single rank's")
    return 0


if __name__ == "__main__":
    sys.exit(main())
