"""Run one cell of the benchmark of ``columbiaimagesearch_tpu_torch`` once.

    python3 -m portbench.run --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout, on a machine with the cards the cell asks
for. Set-up makes the inputs from ``--seed`` on the card, builds the
program's index and warms up the cell's shapes (``setup_s``); the window
then offers the cell's traffic for ``--seconds``. Once the window has
closed and the program's state is freed, a sample of the answers, drawn
from the seed, is compared with the plain reference
(``portbench/reference``): ``correct``. With ``--trace 0`` the last line
of standard output carries the cell's end-to-end metrics; with
``--trace 1`` its per-layer metrics, read from a profiled part of the
window, the device's busy time and the breakdown. The numbers compared
and their limits are the last lines of standard error and the last key of
the result.

Exits 2 without a result when the cards are missing, and 3 when a module
of JAX or of the JAX package is loaded.
"""

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import types  # noqa: E402

#: top-level module names the process may not hold (compared whole: the
#: port's name begins with the JAX package's)
FORBIDDEN = ("jax", "jaxlib", "flax", "columbiaimagesearch_tpu")


def forbidden_modules():
    return sorted({name.split(".")[0] for name in list(sys.modules)}
                  & set(FORBIDDEN))


def cache_dirs(root):
    """Build and kernel caches at fixed paths inside the checkout (the
    port's nvcc builds go to ``build/kernels/`` by themselves)."""
    base = os.path.join(root, "build", "portbench")
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ[var] = os.path.join(base, sub)


def card_line():
    """``name, power.limit`` of the cards, as nvidia-smi reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi: {e}"
    return out.stdout.strip().replace("\n", "; ")


def execute(cell, seed, seconds, traced, dev, t0=None, control=False):
    """One run of ``cell`` (a ``spec.Cell``) on ``dev``, through its traffic
    kind's ``Load`` (``kinds/``). Returns the result line's dict; with
    ``control`` it carries under ``"control"`` (not a key of the
    benchmark's result) the control's numbers held to the same limits by
    the same comparison, and whether they read correct."""
    import torch

    from portbench import check, roofline, spec
    from portbench.util import log

    t0 = time.perf_counter() if t0 is None else t0
    load = spec.kind(cell.mix["kind"]).Load(cell.cfg, cell.mix, seed, dev)
    stages = load.setup()
    setup_s = time.perf_counter() - t0
    log("setup: " + ", ".join(f"{k} {v:.3f} s" for k, v in stages.items())
        + f"; setup_s {setup_s:.3f} s")
    win = load.window(seconds, traced)
    cuda = dev.type == "cuda"
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    sample = load.sample()
    load.free()
    t_ref = time.perf_counter()
    judged = load.judge(sample, control=control)
    log(f"check: judged in {time.perf_counter() - t_ref:.3f} s")
    checks, correct = check.compare(judged["program"], cell.limits)
    device = {"platform": "gpu" if cuda else dev.type,
              "kind": torch.cuda.get_device_name(dev) if cuda else "cpu",
              "count": cell.chips, "memory_peak_bytes": int(peak)}
    win["e2e"] = dict(win["e2e"], setup_s=setup_s)
    out = {"correct": correct, "attempted": win["attempted"],
           "failed": win["failed"]}
    if traced:
        red = win["trace"]
        run = types.SimpleNamespace(cfg=cell.cfg, mix=cell.mix,
                                    roofline=roofline, **win)
        metrics = {}
        for m in cell.per_layer:
            v = spec.reader(m["name"])(run)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        device.update(busy_s=red.busy_s, window_s=red.window_s)
        out.update(metrics=metrics, device=device, breakdown={
            "device_ops": red.device_ops(), "idle_gaps": red.idle_gaps()})
    else:
        out.update(metrics={m["name"]: {"value": win["e2e"][m["name"]],
                                        "unit": m["unit"]}
                            for m in cell.end_to_end},
                   device=device)
    out["counters"] = win["counters"]
    if control:
        ctl_checks, ctl_correct = check.compare(judged["control"],
                                                cell.limits)
        out["control"] = {"correct": ctl_correct, "checks": ctl_checks}
    out["checks"] = checks
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from portbench import spec

    cell = spec.Cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"portbench: {args.workload} needs {cell.chips} CUDA card(s); "
              f"torch.cuda.is_available()={torch.cuda.is_available()}, "
              f"device_count={torch.cuda.device_count()}", file=sys.stderr)
        return 2
    cache_dirs(spec.ROOT)
    dev = torch.device("cuda", 0)
    out = execute(cell, args.seed, args.seconds, bool(args.trace), dev,
                  t0=_T0)
    print(f"card: {card_line()}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}", file=sys.stderr, flush=True)
    found = forbidden_modules()
    if found:
        print(f"portbench: the process holds {found}, which the benchmark "
              f"may not load", file=sys.stderr)
        return 3
    print(json.dumps({k: v for k, v in out.items() if k != "counters"}),
          flush=True)
    print(f"counters: {json.dumps(out['counters'])}", file=sys.stderr)
    print(f"correct: {out['correct']}", file=sys.stderr)
    for k, c in out["checks"].items():
        print(f"check {k}: {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
