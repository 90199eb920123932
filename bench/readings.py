"""Read the numbers that ``correct`` compares, over many seeds in one
process: the readings the cells' limits are set from.

    python3 bench/readings.py --workload <cell> --seeds 1,2,3 \
        --mode sound|control|witness|fault:<name> [--seconds 30]

``sound`` runs the cell as ``bench/run.py`` does (set-up, a window of
``--seconds``, by default none past the followed iterations, the
reference) on each seed; ``fault:<name>`` does the same with a fault of
``bench/faults.py`` planted in the port; ``control`` does what ``sound``
does and then puts the reference in TF32 in the program's place, over the
followed iterations and in the evaluation at the program's last weights
(``compare.control_readings``), and judges that by the cell's limits;
``witness`` runs the reference with its products rounded another way in
the program's place over the followed iterations (host only).  One JSON
line per seed (``correct`` is the control's own in ``control`` mode), then
the largest reading of each number.  On the card; ``--device cpu`` drives
the same path on the CPU.
"""
import argparse
import io
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
for _p in (str(ROOT / "src"), str(ROOT)):
    if _p not in sys.path:
        sys.path.insert(0, _p)


def _worst(worst: dict, vals: dict) -> None:
    for k, v in vals.items():
        worst[k] = max(worst.get(k, v), v)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--mode", default="sound")
    ap.add_argument("--seconds", type=float, default=0.0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--root", default=str(ROOT))
    args = ap.parse_args(argv)
    import torch

    from bench import compare, faults
    from bench.harness import Cell, run_cell
    seeds = [int(s) for s in args.seeds.split(",")]
    root = Path(args.root)
    cell = Cell(root, args.workload)
    limits = cell.spec.get("limits", {})
    followed = int(cell.spec["followed_iterations"])
    worst, worst_control = {}, {}
    for seed in seeds:
        t0 = time.perf_counter()
        line = {"workload": args.workload, "mode": args.mode, "seed": seed}
        if args.mode == "witness":
            arrays = cell.data.generate(cell.cfg, seed,
                                        torch.device(args.device))
            host = {k: v.cpu().numpy() for k, v in arrays.items()}
            del arrays
            vals = compare.standin_readings(cell, host, seed, followed,
                                            "float32-via-float64")
            line.update(correct=compare.judge(vals, limits)[0],
                        readings=vals)
        else:
            log = io.StringIO()
            probe = None
            if args.mode == "control":
                def probe(c, host, final, _seed=seed):
                    vals = compare.control_readings(c, host, _seed,
                                                    followed, final)
                    ok, checks = compare.judge(vals, limits)
                    return {"correct": ok, "readings": vals,
                            "checks": checks}
            if args.mode.startswith("fault:"):
                with faults.planted(args.mode.split(":", 1)[1]):
                    res = run_cell(root, args.workload, seed, args.seconds,
                                   False, device=args.device, out=log)
            else:
                res = run_cell(root, args.workload, seed, args.seconds,
                               False, device=args.device, out=log,
                               probe=probe)
            ref = [json.loads(x) for x in log.getvalue().splitlines()
                   if '"reference"' in x]
            vals = ref[-1]["readings"] if ref else {}
            line.update(correct=res["correct"], readings=vals)
            if args.mode == "control":
                control = ref[-1]["probe"] if ref else None
                line.update(program_correct=res["correct"],
                            correct=control["correct"] if control else None,
                            control=control["readings"] if control else {})
                _worst(worst_control, line["control"])
        _worst(worst, vals)
        line["seconds"] = time.perf_counter() - t0
        print(json.dumps(line), flush=True)
    summary = {"workload": args.workload, "mode": args.mode,
               "seeds": len(seeds), "largest": worst}
    if args.mode == "control":
        summary["largest_control"] = worst_control
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
