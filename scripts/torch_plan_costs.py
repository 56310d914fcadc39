#!/usr/bin/env python3
"""Fit the port's rerank plan cost model (``index/probe.py``) on the card
without the rest of ``chip_smoke.py``: its kernel build, training
(``phase_train``: the release and face models) and main path
(``phase_main_path``: the headline's 10,485,760-row index), then
``phase_plan_costs``, which times every plan-cost point, fits the
constants, holds the plan choice to the card and prints each point, the
fit and the choices. The last line is one JSON object: the fitted
constants, whether the fit holds its tolerances, the points outside them,
the choices and the brute pass's near-tie swaps between chunk widths.

    python3 scripts/torch_plan_costs.py

Needs one CUDA card; imports nothing of JAX.
"""

import json
import os
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402


def main():
    if not torch.cuda.is_available():
        print("torch_plan_costs: no CUDA device", file=sys.stderr)
        return 2
    import columbiaimagesearch_tpu_torch  # noqa: F401  (TF32 off)

    dev = torch.device("cuda", 0)
    card = cs.card_line()
    cs.log(card)
    cfg = dict(cs.HEADLINE)
    t0 = time.perf_counter()
    cs.phase_build()
    trained = cs.phase_train(dev, card)
    del trained["face"]["train"], trained["heldout"]
    state, _ = cs.phase_main_path(dev, cfg, card, trained)
    t1 = time.perf_counter()
    out = cs.phase_plan_costs(dev, cfg, state, card, trained["face"])
    cs.log(f"torch_plan_costs: set-up {t1 - t0:.1f} s, plan costs "
           f"{time.perf_counter() - t1:.1f} s")
    name, power = card.rsplit(",", 1)
    print(json.dumps(dict(
        fit=out["fit"], fit_within=out["fit_within"],
        outside=[{k: o[k] for k in ("plan", "V", "D", "itemsize", "nb",
                                    "nq", "rung", "ms", "fit_ms", "err",
                                    "known")} for o in out["outside"]],
        choice=out["choice"], brute_ties=out["brute_ties"],
        card=name.strip(), power_limit=power.strip())), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
