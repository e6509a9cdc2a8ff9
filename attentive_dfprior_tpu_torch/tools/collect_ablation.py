"""Merge ablation JSONs into one record: the port of
``scripts/collect_ablation.py``.

    python -m attentive_dfprior_tpu_torch.tools.collect_ablation OUT.json IN.json [IN.json ...]

Each input is a {variant: record} dict from ``tools/ablate_tracking.py``;
records with a ``seed`` other than 0 are grouped under ``seed_reruns``. The
output adds the variants ranked by aligned ATE.
"""

from __future__ import annotations

import json
import sys
import time
from typing import Any, Dict, List, Optional

PROTOCOL = (
    "configs/Synthetic/room_tracking.yaml, SLAM run per variant (frames as the inputs record) on one CUDA card "
    "through attentive_dfprior_tpu_torch, trajectory-only (side outputs disabled), aligned ATE via "
    "tools.eval_ate.evaluate_ate (the reference eval contract, ref: src/tools/eval_ate.py:113-223)"
)


def collect(paths: List[str]) -> Dict[str, Any]:
    """The merged record of the ablation JSONs at ``paths``."""
    runs: Dict[str, Any] = {}
    seed_reruns: Dict[str, Any] = {}
    for path in paths:
        with open(path) as f:
            d = json.load(f)
        for name, rec in d.items():
            seed = rec.get("seed", 0)
            if seed == 0:
                runs[name] = rec
            else:
                seed_reruns.setdefault(name, {})[f"seed{seed}"] = rec
    ranked = sorted(runs.items(), key=lambda kv: kv[1]["ate_cm_aligned"])
    return {
        "protocol": PROTOCOL,
        "ranked": [{"variant": k, "ate_cm": v["ate_cm_aligned"], "overrides": v["overrides"]} for k, v in ranked],
        "runs": runs,
        "seed_reruns": seed_reruns,
        "when": time.strftime("%Y-%m-%d %H:%M:%S"),
    }


def main(argv: Optional[List[str]] = None) -> Dict[str, Any]:
    args = sys.argv[1:] if argv is None else argv
    if len(args) < 2:
        raise SystemExit(__doc__)
    out_path = args[0]
    payload = collect(args[1:])
    with open(out_path, "w") as f:
        json.dump(payload, f, indent=1)
    print(f"wrote {out_path}: {len(payload['runs'])} variants, "
          f"{sum(len(v) for v in payload['seed_reruns'].values())} seed reruns")
    for r in payload["ranked"][:8]:
        print(f"  {r['variant']:26s} {r['ate_cm']:7.2f} cm")
    return payload


if __name__ == "__main__":
    main()
