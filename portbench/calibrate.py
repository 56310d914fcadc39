"""The readings that a cell's limits are set from: the check's numbers for
the program over many seeds (the lower readings) and for the control
over the same seeds (the upper readings), in one process.

    python3 -m portbench.calibrate --workload <cell> --seconds <s> \\
        --seeds <n> [<n> ...]

The control is the plain reference computed in TF32 (its matrix products'
inputs rounded to 10 mantissa bits), put in the program's place and
judged on the same sampled queries as the program. Each seed prints one
JSON line, with the control's numbers held to the cell's limits by the
run's own comparison (``run.execute``) and whether they read correct;
the last line gives the largest program reading and the smallest control
reading of each number, and the seeds on which the control read correct.
The benchmark's own runs never run the control.
"""

import argparse
import json
import sys


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)

    import torch

    from portbench import run, spec

    cell = spec.Cell(args.workload)
    if not torch.cuda.is_available():
        print("portbench.calibrate: no CUDA card", file=sys.stderr)
        return 2
    run.cache_dirs(spec.ROOT)
    dev = torch.device("cuda", 0)
    print(f"card: {run.card_line()}", file=sys.stderr, flush=True)
    lows, highs, passed = {}, {}, []
    for seed in args.seeds:
        out = run.execute(cell, seed, args.seconds, False, dev, control=True)
        prog = {k: c["value"] for k, c in out["checks"].items()}
        ctl = {k: c["value"] for k, c in out["control"]["checks"].items()}
        line = dict(seed=seed, correct=out["correct"], program=prog,
                    control_correct=out["control"]["correct"], control=ctl,
                    metrics={k: v["value"] for k, v in out["metrics"].items()},
                    counters=out["counters"])
        print(json.dumps(line), flush=True)
        for k, v in prog.items():
            lows[k] = max(lows.get(k, 0.0), v)
        for k, v in ctl.items():
            highs[k] = min(highs.get(k, float("inf")), v)
        if out["control"]["correct"]:
            passed.append(seed)
        torch.cuda.empty_cache()
    print(json.dumps({"workload": args.workload, "seeds": len(args.seeds),
                      "lower": lows, "upper": highs,
                      "control_read_correct_on": passed}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
