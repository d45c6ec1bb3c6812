"""Plot training curves from the trainer's metrics stream (the
counterpart of `tools/plot_metrics.py`).

Reads the `metrics.jsonl` that `python -m early_exit_tpu_torch.train`
writes under --log_dir (`utils/metrics.py` `MetricsLogger`: "loss", "lr"
and "grad_norm" every logged step, "Total loss" every epoch):

    python -m early_exit_tpu_torch.plot_metrics runs/metrics.jsonl [--key loss]
    python -m early_exit_tpu_torch.plot_metrics runs/metrics.jsonl --out loss.png

Without --out it prints the JAX tool's ASCII summary (count, first, last,
min, max and a sparkline of the last 100 values); --out writes a PNG and
needs matplotlib, which raises ImportError by name where it is absent.
"""

import argparse
import json


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("metrics", nargs="?", default="runs/metrics.jsonl")
    ap.add_argument("--key", default="loss")
    ap.add_argument("--out", default=None,
                    help="Write a PNG (requires matplotlib); otherwise "
                         "print an ASCII sparkline summary.")
    args = ap.parse_args(argv)

    steps, values = [], []
    with open(args.metrics) as f:
        for line in f:
            rec = json.loads(line)
            if args.key in rec:
                steps.append(rec["step"])
                values.append(rec[args.key])
    if not values:
        print(f"no '{args.key}' entries in {args.metrics}")
        return

    if args.out:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        plt.figure(figsize=(8, 4))
        plt.plot(steps, values)
        plt.xlabel("step")
        plt.ylabel(args.key)
        plt.grid(True, alpha=0.3)
        plt.tight_layout()
        plt.savefig(args.out, dpi=120)
        print(f"wrote {args.out}")
    else:
        lo, hi = min(values), max(values)
        blocks = "▁▂▃▄▅▆▇█"
        span = (hi - lo) or 1.0
        line = "".join(blocks[min(int((v - lo) / span * 7.999), 7)]
                       for v in values[-100:])
        print(f"{args.key}: n={len(values)} first={values[0]:.4f} "
              f"last={values[-1]:.4f} min={lo:.4f} max={hi:.4f}")
        print(line)


if __name__ == "__main__":
    main()
